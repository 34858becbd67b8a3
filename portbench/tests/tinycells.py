"""A cell at a size the CPU test run holds: the service cell at n = 64,
built as the harness builds the real cell, with the real cell's
limits."""

from __future__ import annotations

import json

from portbench import harness, plugins

ROOT = plugins.BENCH_DIR.parent
TINY_CONFIG = {"machine": {"kind": "tree", "factors": [4, 4, 4],
                           "distances": [1.0, 10.0, 100.0]}}
TINY_TRAFFIC = {"structures": [
    {"name": "grid3d-4", "generator": "stencil", "dims": [4, 4, 4]},
    {"name": "rgg-64", "generator": "random_geometric", "n": 64,
     "radius": 0.2, "structure_seed": 31}]}


def tiny_cell() -> harness.Cell:
    """The real ``tree4096.svc8`` with its machine and structures cut to
    n = 64."""
    real = harness.load_cell(ROOT, harness.load_benchmark(ROOT),
                             "tree4096.svc8")
    config = json.loads(json.dumps(real.config))
    config.update(TINY_CONFIG)
    traffic = dict(real.traffic, **TINY_TRAFFIC)
    return harness.Cell(real.name, 1, config, traffic, dict(real.limits),
                        real.end_to_end, real.per_layer,
                        dict(real.judge_params))
