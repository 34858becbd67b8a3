"""Checks shared by the port's tests and ``chip_smoke.py``.

:func:`tensors_in` counts the torch tensors a result still holds (what
the mapping service hands out must hold none); :func:`pair_gain_lanes`
records the lane count of every K2 launch while it is entered;
:func:`moe_routes` records every MoE dispatch plan while it is entered,
and :func:`moe_replay` hands recorded plans back to the MoE layers;
:func:`warm_cpu_math` runs the CPU's vector math once before a CPU
reference is computed.

Nothing here runs at import: this module is imported on machines with
no CUDA toolkit.
"""

from __future__ import annotations

import contextlib
import dataclasses

__all__ = ["moe_replay", "moe_routes", "pair_gain_lanes", "tensors_in",
           "warm_cpu_math"]


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
    aux), device tensors, nothing read back."""
    from .models import moe
    orig = moe._route
    log = []

    def recording(*a, **kw):
        out = orig(*a, **kw)
        log.append(out)
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
