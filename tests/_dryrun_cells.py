"""Shared by the dry-run tests: run ``python -m repro_torch.launch.dryrun``
in a subprocess (the fake process group never enters the test process)
and hold each row's ``arg_bytes`` and ``out_bytes`` to the local shard
bytes computed from the JAX package's ``jax.eval_shape`` stand-ins
(``repro.launch.specs``) and its specs on ``AbstractMesh``."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
from jax.sharding import AbstractMesh, PartitionSpec as P

import repro.models.sharding as jshd
from repro.configs import SHAPES, get_config as jax_config
from repro.launch import specs as jspecs
from repro.train import steps as jsteps

_SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
# the train metrics: ce, aux, loss, grad_norm, lr float32, tokens int32
METRIC_BYTES = 5 * 4 + 4


def run(archs, shapes, mesh, overrides, out_dir, timeout=600):
    """The rows of one dry-run call, by (arch, shape)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", ",".join(archs), "--shape", ",".join(shapes),
           "--mesh", mesh, "--overrides", json.dumps(overrides),
           "--out", str(out_dir)]
    env = dict(os.environ, PYTHONPATH=_SRC)
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rows = {}
    for arch in archs:
        for shape in shapes:
            rows[(arch, shape)] = json.loads(
                (Path(out_dir) / f"{arch}__{shape}__{mesh}.json").read_text())
    return rows


def _local(mesh, x, spec) -> int:
    n = 1
    for d, size in enumerate(x.shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else ((e,) if isinstance(e, str) else e)
        parts = int(np.prod([mesh.shape[a] for a in axes]))
        n *= -(-int(size) // parts)
    return n * np.dtype(x.dtype).itemsize


def _sum(mesh, tree, specs) -> int:
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, P))
    assert len(leaves) == len(spec_leaves)
    return sum(_local(mesh, x, s) for x, s in zip(leaves, spec_leaves))


def reference_bytes(arch, shape_name, mesh_name, overrides):
    """(arg_bytes, out_bytes) of a cell from the JAX package's stand-ins
    and specs."""
    cfg = dataclasses.replace(jax_config(arch), **overrides)
    am = AbstractMesh(*MESHES[mesh_name])
    shape = SHAPES[shape_name]
    fe = cfg.frontend_tokens > 0
    if shape.kind == "train":
        state, batch = jspecs.train_input_specs(cfg, shape_name)
        s = _sum(am, state, jsteps.train_state_specs(cfg, am))
        b = _sum(am, batch, jshd.train_batch_specs(am, fe))
        return s + b, s + METRIC_BYTES
    if shape.kind == "prefill":
        params, batch = jspecs.prefill_input_specs(cfg, shape_name)
        bspec = {k: v for k, v in jshd.train_batch_specs(am, fe).items()
                 if k != "labels"}
        arg = (_sum(am, params, jshd.param_specs(cfg, am))
               + _sum(am, batch, bspec))
        logits = jax.ShapeDtypeStruct((shape.global_batch, 1,
                                       cfg.padded_vocab), cfg.jnp_dtype)
        return arg, _local(am, logits, P(jshd.batch_axes(am), None, None))
    b = shape.global_batch
    params, token, caches, step = jspecs.serve_input_specs(cfg, shape_name)
    # build_serve_step's specs (jitting it needs a concrete mesh)
    cspec = jshd.cache_specs(cfg, am, b, seq_shard=b == 1)
    n_b = int(np.prod([am.shape[a] for a in jshd.batch_axes(am)]))
    tok_spec = (P(jshd.batch_axes(am), None) if b % n_b == 0 and b >= n_b
                else P(None, None))
    cache_b = _sum(am, caches, cspec)
    tok_b = _local(am, token, tok_spec)
    arg = (_sum(am, params, jshd.param_specs(cfg, am)) + tok_b + cache_b
           + _local(am, step, P()))
    return arg, tok_b + cache_b


def check_rows(rows, mesh_name, overrides):
    for (arch, shape_name), r in rows.items():
        assert r["status"] == "ok", r
        arg, out = reference_bytes(arch, shape_name, mesh_name, overrides)
        assert r["arg_bytes"] == arg, (arch, shape_name, r["arg_bytes"], arg)
        assert r["out_bytes"] == out, (arch, shape_name, r["out_bytes"], out)
        assert r["per_device_bytes"] == (r["arg_bytes"] + r["temp_bytes"]
                                         + r["out_bytes"]
                                         - r["alias_bytes"])
        assert r["temp_bytes"] > 0 and r["flops"] > 0, r
        assert r["trip_counts"]["periods"] >= 1
        if r["kind"] == "train_step":
            kinds = r["collectives_by_type"]
            assert kinds.get("all-gather", 0) > 0, kinds
            assert kinds.get("reduce-scatter", 0) > 0, kinds
        if mesh_name == "multi" and r["kind"] == "train_step":
            assert r["dcn_bytes"] > 0, r      # the pod dim's gradient sums
