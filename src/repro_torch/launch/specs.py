"""The fleet-placement configuration shared by the placement service
(:func:`repro_torch.launch.serve.placement_service`) and the serving
benchmark (``benchmarks/bench_port_serve.py``) — the port's copy of the
mapping half of the JAX package's ``launch/specs.py``.

The JAX package's ``*_input_specs`` functions (shape stand-ins for the
LM dry-run cells, built with ``jax.eval_shape``) are not ported here:
they belong with the XLA-bound part of the LM training path.
"""

from __future__ import annotations

__all__ = ["placement_service_config", "placement_spec"]


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
