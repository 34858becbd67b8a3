"""Checks shared by the port's tests and ``chip_smoke.py``.

:func:`tensors_in` counts the torch tensors a result still holds (what
the mapping service hands out must hold none); :func:`pair_gain_lanes`
records the lane count of every K2 launch while it is entered;
:func:`moe_routes` records every MoE dispatch plan while it is entered,
and :func:`moe_replay` hands recorded plans back to the MoE layers;
:func:`warm_cpu_math` runs the CPU's vector math once before a CPU
reference is computed; :func:`float64_evaluation` runs the model and
training code in float64 (the truth a float32 train step's own error is
measured against) and :func:`widen_train_state` copies a train state to
float64 for it.

Nothing here runs at import: this module is imported on machines with
no CUDA toolkit.
"""

from __future__ import annotations

import contextlib
import dataclasses

__all__ = ["float64_evaluation", "moe_replay", "moe_routes",
           "pair_gain_lanes", "tensors_in", "warm_cpu_math",
           "widen_train_state"]


def tensors_in(obj) -> int:
    """Torch tensors reachable from ``obj`` through dataclass fields,
    lists, tuples and dict values."""
    import torch
    if isinstance(obj, torch.Tensor):
        return 1
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(tensors_in(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return sum(tensors_in(x) for x in obj)
    if isinstance(obj, dict):
        return sum(tensors_in(x) for x in obj.values())
    return 0


@contextlib.contextmanager
def pair_gain_lanes():
    """While entered, the lane count of every K2 launch (from any
    thread, the mapping service's worker among them), in launch order,
    appended to the yielded list.  The launch counts are left as the
    wrapper keeps them."""
    from .kernels import PAIR_GAIN_KERNEL
    lanes = []
    launch = PAIR_GAIN_KERNEL.launch

    def spy(*args):             # args[8]: the launch's lane count
        lanes.append(int(args[8]))
        return launch(*args)

    PAIR_GAIN_KERNEL.launch = spy
    try:
        yield lanes
    finally:
        del PAIR_GAIN_KERNEL.launch


@contextlib.contextmanager
def moe_routes():
    """Yield a list that receives every MoE dispatch plan made inside the
    block: ``models.moe._route``'s outputs (se, st, sw, pos, keep, order,
    aux), device tensors, nothing read back; detached, so that a plan
    recorded in a training forward keeps no autograd graph alive (under
    remat, a checkpointed layer's recomputed activations with it)."""
    from .models import moe
    orig = moe._route
    log = []

    def recording(*a, **kw):
        out = orig(*a, **kw)
        log.append(tuple(t.detach() for t in out))
        return out

    moe._route = recording
    try:
        yield log
    finally:
        moe._route = orig


@contextlib.contextmanager
def moe_replay(plans):
    """Inside the block, each MoE layer takes the next of ``plans`` (as
    :func:`moe_routes` recorded them, in order) in place of routing its
    own tokens: two runs of one model that differ in their last bits (an
    attention kernel against its plain version) then route alike, where
    a near tie between two experts would otherwise move a token to
    another expert.  Raises if the block asks for more plans than
    given."""
    from .models import moe
    orig = moe._route
    pending = list(plans)

    def replay(*a, **kw):
        if not pending:
            raise RuntimeError("moe_replay: more MoE layers than plans")
        return pending.pop(0)

    moe._route = replay
    try:
        yield
    finally:
        moe._route = orig


def warm_cpu_math() -> None:
    """Run the CPU's transcendental kernels once over every intra-op
    thread, results dropped.

    The first multi-threaded ``torch.cos`` of a process may come back
    wrong for one thread's share of its tensor, by up to 1.5e-4 (about
    11 bits, on values in [-1, 1]); later calls are exact.  Seen in 6 of
    2,000 fresh processes on an Intel Xeon with oneMKL 2024 (PyTorch's
    CPU ``cos`` goes through MKL's vector math;
    ``tools/cpu_first_cos.py``), and in 3 of 63 on the host of an H100
    machine, where it put the granite smoke prefill's CPU logits 6.2e-4
    off (layer 0's RoPE of q; ``tools/flash_f32_repeat.py``).  A CPU
    reference that a test holds the card to computes after this call."""
    import torch
    x = torch.linspace(-100.0, 100.0, 4096 * max(1, torch.get_num_threads()))
    for fn in (torch.cos, torch.sin, torch.exp, torch.log1p, torch.tanh,
               torch.sigmoid, torch.rsqrt, torch.erf):
        fn(x)


@contextlib.contextmanager
def float64_evaluation():
    """Inside the block the model and training modules compute in float64
    wherever they would cast to, or allocate, float32: their module
    global ``torch`` is a stand-in whose ``float32`` is ``float64``.  On
    float64 parameters (:func:`widen_train_state`) a train step is then
    the same code in float64 throughout, the truth against which a
    float32 step's rounding is measured; an op on floating tensors that
    makes a floating tensor of another type inside the block (a float32
    reached some other way) raises.  Process-wide while entered."""
    import types

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from .models import attention, layers, mamba, moe, rwkv, transformer
    from .train import loss, optimizer, steps

    class Widened(types.ModuleType):
        float32 = torch.float64

        def __getattr__(self, name):
            return getattr(torch, name)

    def floats(tree):
        return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)
                and t.is_floating_point()]

    class OnlyFloat64(TorchDispatchMode):
        # an op on floating tensors must give float64; a factory (no
        # floating input: autograd's checkpoint makes float32 sentinels)
        # is let through
        def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if floats((args, kwargs)):
                for t in floats(out):
                    if t.dtype != torch.float64:
                        raise TypeError(f"float64_evaluation: {func} made "
                                        f"a {t.dtype} tensor")
            return out

    mods = (attention, layers, mamba, moe, rwkv, transformer, loss,
            optimizer, steps)
    wide = Widened("torch")
    for mod in mods:
        mod.torch = wide
    try:
        with OnlyFloat64():
            yield
    finally:
        for mod in mods:
            mod.torch = torch


def widen_train_state(state) -> dict:
    """A float64 copy of a float32 train state, on the same device."""
    import copy

    import torch
    return {"params": copy.deepcopy(state["params"]).double(),
            "m": {k: t.double() for k, t in state["m"].items()},
            "v": {k: t.double() for k, t in state["v"].items()},
            "step": state["step"].clone()}
