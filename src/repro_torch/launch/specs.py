"""Shape stand-ins for every (arch × shape) dry-run cell, and the
fleet-placement configuration shared by the placement service
(:func:`repro_torch.launch.serve.placement_service`) and the serving
benchmark (``benchmarks/bench_port_serve.py``) — the port's copy of the
JAX package's ``launch/specs.py``.

The stand-ins are meta tensors: no memory, no values.  Their shapes and
types come from the port's own ``init_params``, ``init_caches`` and
``init_train_state`` run under ``FakeTensorMode`` (the initialisers'
``torch.Generator`` draws are faked there, not run; a generator on the
meta device cannot be made), so the dry-run traces exactly what the
launcher would run — the counterpart of ``jax.eval_shape``.
"""

from __future__ import annotations

import torch

from ..configs import SHAPES

__all__ = ["placement_service_config", "placement_spec",
           "prefill_input_specs", "serve_input_specs", "train_input_specs"]


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _sds(tree):
    """``tree`` with every tensor replaced by a meta tensor of its shape
    and type (a module's parameters in place, keeping ``requires_grad``);
    dicts, lists and other leaves kept."""
    if isinstance(tree, torch.nn.Module):
        from ..models.transformer import replace_parameters
        replace_parameters(tree, lambda name, t: _meta(t))
        return tree
    if isinstance(tree, dict):
        return {k: _sds(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_sds(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return _meta(tree)
    return tree


def _shapes_of(fn):
    """``fn()``'s result as meta stand-ins, ``fn`` run under
    ``FakeTensorMode`` on the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        out = fn()
    return _sds(out)


def _tokens(cfg, b: int, t: int) -> dict:
    t_tok = t - cfg.frontend_tokens
    batch = {"tokens": torch.empty((b, t_tok), dtype=torch.int32,
                                   device="meta")}
    if cfg.frontend_tokens:
        batch["frontend"] = torch.empty(
            (b, cfg.frontend_tokens, cfg.d_model), dtype=cfg.torch_dtype,
            device="meta")
    return batch


def train_input_specs(cfg, shape_name: str, batch: int | None = None):
    """(train state, batch) stand-ins of a train cell (``batch``: another
    global batch than the cell's)."""
    from ..train.steps import init_train_state
    shape = SHAPES[shape_name]
    state = _shapes_of(lambda: init_train_state(0, cfg, device="cpu"))
    batch = _tokens(cfg, batch or shape.global_batch, shape.seq_len)
    batch["labels"] = torch.empty_like(batch["tokens"])
    return state, batch


def prefill_input_specs(cfg, shape_name: str):
    """(params, batch) stand-ins of a prefill cell."""
    from ..models.transformer import init_params
    shape = SHAPES[shape_name]
    params = _shapes_of(lambda: init_params(0, cfg, device="cpu"))
    return params, _tokens(cfg, shape.global_batch, shape.seq_len)


def serve_input_specs(cfg, shape_name: str):
    """(params, token, caches, step) stand-ins of a decode cell; the step
    is a host int, as the port's decode takes it."""
    from ..models.transformer import init_caches, init_params
    shape = SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    params = _shapes_of(lambda: init_params(0, cfg, device="cpu"))
    caches = _shapes_of(lambda: init_caches(b, cfg, max_len=s,
                                            device="cpu"))
    token = torch.empty((b, 1), dtype=torch.int32, device="meta")
    return params, token, caches, 0


def placement_spec(seed: int = 0):
    """The fleet-placement ``MappingSpec`` shared by the serving placement
    service (``repro_torch.launch.serve``) and the mesh-mapping benchmark
    — the same config language the ``viem`` CLI speaks (``--config``).

    d=3 keeps the N_C^d neighborhood tractable at fleet scale (hundreds to
    thousands of devices) while still crossing tray/superblock boundaries.
    The engine is left at its default, ``"host"``: this spec maps on the
    host whatever the Mapper's device.
    """
    from ..core import MappingSpec
    return MappingSpec(preconfiguration="eco", neighborhood="communication",
                       neighborhood_dist=3, seed=seed)


def placement_service_config() -> dict:
    """Knobs for the fleet :class:`~repro_torch.launch.serve.MappingService`,
    shared by the placement service and ``benchmarks.bench_port_serve`` so
    both measure the same configuration.

    ``pow2`` shape buckets collapse mixed traffic onto a handful of
    lowered plans; a small ``max_wait_s`` trades a few milliseconds of
    latency for whole-bucket batches; the warm result cache answers
    repeat traffic graphs (recompiled serving programs usually re-emit
    the same communication pattern) without touching the device.
    """
    return {"schedule": "pow2", "max_batch": 4, "max_wait_s": 0.005,
            "result_cache_size": 256}
