"""The port's sharding plans (``repro_torch.models.sharding``,
``train.steps.train_state_specs``, ``models.attention.sharded_layout``)
against the JAX package's on the production meshes, (16, 16) ("data",
"model") and (2, 16, 16) ("pod", "data", "model"), for every shipped
config.

The reference's side runs in this process on ``jax.sharding.AbstractMesh``:
``param_specs`` and ``cache_specs`` read only the mesh's names and sizes.
Its constrainers refuse to run under the installed jax
(``with_sharding_constraint`` rejects the mesh), so their targets are
captured by patching ``jax.lax.with_sharding_constraint`` to record the
spec and return its input; the sharded flash's specs and per-rank KV
ids by patching ``jax.shard_map`` and ``jax.lax.axis_index``.  No file of
the JAX package changes.  A PartitionSpec entry ``("pod",)`` and the
port's ``"pod"`` are the same spec (JAX normalises one-name tuples).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor._utils import (
    _compute_local_shape_and_global_offset)

import repro.models.attention as jattn
import repro.models.sharding as jshd
from repro.configs import ARCHS, get_config as jax_config
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import sharding as tshd
from repro_torch.models.moe import capacity
from repro_torch.train import steps as tsteps

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), tshd.MeshShape(shape, names)


def _entry(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _ref(tree):
    """A reference spec tree in the port's form (tuples of entries)."""
    if isinstance(tree, P):
        return tuple(_entry(e) for e in tree)
    if isinstance(tree, dict):
        return {k: _ref(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_ref(v) for v in tree]
    return tree


def _port(tree):
    if isinstance(tree, dict):
        return {k: _port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port(v) for v in tree]
    return tuple(_entry(e) for e in tree)


def _n_leaves(tree):
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_n_leaves(v) for v in tree)
    return 1


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_train_state_specs_equal_the_references(arch, mesh):
    am, tm = _meshes(mesh)
    jc, tc = jax_config(arch), get_config(arch)
    want = _ref(jshd.param_specs(jc, am))
    assert _port(tshd.param_specs(tc, tm)) == want
    state = _ref(jsteps.train_state_specs(jc, am))
    assert _port(tsteps.train_state_specs(tc, tm)) == state
    # the port's per-layer placements are the same specs without the
    # period axis, one entry per named parameter
    per_layer = tsteps.param_placements(tc, tm)
    assert len(per_layer) == 3 + (_n_leaves(want["periods"])
                                  * tc.n_periods)
    for i in range(tc.n_layers):
        ref = want["periods"][i % tc.period]
        for k, v in per_layer.items():
            if k.startswith(f"layers.{i}."):
                *path, leaf = k.split(".")[2:]
                node = ref
                for part in path:
                    node = node[part]
                assert (None,) + v == node[leaf], k


@pytest.mark.parametrize("case", [(128, False), (1, True)],
                         ids=["b128", "b1-seq"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_references(arch, mesh, case):
    am, tm = _meshes(mesh)
    batch, seq_shard = case
    want = _ref(jshd.cache_specs(jax_config(arch), am, batch, seq_shard))
    got = tshd.cache_specs(get_config(arch), tm, batch, seq_shard)
    assert _port(got) == want


@pytest.mark.parametrize("frontend", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_train_batch_specs_equal_the_references(mesh, frontend):
    am, tm = _meshes(mesh)
    assert _port(tshd.train_batch_specs(tm, frontend)) == _ref(
        jshd.train_batch_specs(am, frontend))


def _captured(monkeypatch):
    seen = []

    def record(x, sharding):
        seen.append((tuple(x.shape), _ref(sharding.spec)))
        return x
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", record)
    return seen


@pytest.mark.parametrize("batch", [64, 2])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_constrainer_targets_equal_the_references(arch, mesh, batch,
                                                  monkeypatch):
    am, tm = _meshes(mesh)
    jc, tc = jax_config(arch), get_config(arch)
    seen = _captured(monkeypatch)
    d = tc.d_model
    act = [(batch, 512, d), (batch, 512)]
    jcon = jshd.activation_constrainer(am, batch)
    tcon = tshd.activation_constrainer(tm, batch)
    for shape in act:
        del seen[:]
        jcon(jax.ShapeDtypeStruct(shape, jnp.float32))
        want = seen[0][1] if seen else None
        got = tcon.spec(shape) if tcon.spec else None
        assert (got and _port([got])[0]) == want, shape
    jm = jshd.moe_constrainers(jc, am, batch)
    tmc = tshd.moe_constrainers(tc, tm, batch)
    assert (jm is None) == (tmc is None)
    if jm is None:
        return
    ev = tc.moe_experts * tc.moe_ep_split
    cap = capacity(tc, 512)
    shapes = [(batch, ev, cap, d), (batch, ev, cap,
                                    tc.d_ff // tc.moe_ep_split)]
    for jf, tf in zip(jm, tmc):
        for shape in shapes:
            del seen[:]
            jf(jax.ShapeDtypeStruct(shape, jnp.float32))
            assert _port([tf.spec(shape)])[0] == seen[0][1], shape
    if batch == 64 and mesh == "multi":
        # the issue's capture for mixtral-8x7b, spelled out
        if arch == "mixtral-8x7b":
            assert tmc[0].spec(shapes[1]) == ("pod", "data", None, "model")
            assert tmc[1].spec(shapes[0]) == (("pod", "data"), None, None,
                                              None)


@pytest.mark.parametrize("batch", [64, 2])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_flash_layout_equals_the_references(arch, mesh, batch,
                                                    monkeypatch):
    """q and k/v specs, and each model rank's expanded KV heads, of the
    reference's ``_flash_kernel_sharded`` against the port's
    ``sharded_layout``."""
    am, tm = _meshes(mesh)
    jc, tc = jax_config(arch), get_config(arch)
    if "attn" not in [k[0] for k in tc.period_kinds()]:
        pytest.skip(f"{arch} has no attention layer")
    n_model = 16
    h_ok = jc.n_heads_eff % n_model == 0
    h_local = jc.n_heads_eff // n_model if h_ok else jc.n_heads_eff
    got_specs = {}
    ids = {}

    def shard_map(fn, mesh, in_specs, out_specs, check_vma):
        got_specs["in"], got_specs["out"] = in_specs, out_specs

        def run(q, k, v):
            for r in range(n_model if h_ok else 1):
                monkeypatch.setattr(jax.lax, "axis_index", lambda _: r)
                kv = jnp.broadcast_to(
                    jnp.arange(jc.n_kv_heads)[None, None, :, None],
                    (1, 1, jc.n_kv_heads, 1))
                ids[r] = np.asarray(fn(jnp.zeros((1, 1, h_local, 1)), kv,
                                       kv))[0, 0, :, 0].tolist()
        return run

    import repro.kernels.flash_attention as jfa
    monkeypatch.setattr(jax, "shard_map", shard_map)
    monkeypatch.setattr(jfa, "flash_attention_kernel",
                        lambda q, k, v, **kw: k)
    monkeypatch.setattr(jshd, "FLASH_MESH", am)
    jattn._flash_kernel_sharded(jax.ShapeDtypeStruct((batch, 8, 1, 1),
                                                     jnp.float32),
                                None, None, jc)
    qspec, kvspec, kv_ids = tattn.sharded_layout(tc, tm, batch)
    assert _port([qspec, kvspec]) == [_ref(got_specs["in"][0]),
                                      _ref(got_specs["in"][1])]
    assert _port([qspec])[0] == _ref(got_specs["out"])
    for r, want in ids.items():
        assert kv_ids(r, h_local).tolist() == want, r


def _blocks(spec, mesh_shape, names, n):
    """Each rank's (offset, length) of an arange(n) sharded at ``spec``
    over a mesh of ``mesh_shape``: DTensor's own layout, rank by rank."""
    mesh = tshd.MeshShape(mesh_shape, names)
    pl = tshd.placements(mesh, spec)
    out = {}
    for coord in np.ndindex(*mesh_shape):
        shape, off = _compute_local_shape_and_global_offset(
            (n,), mesh_shape, list(coord), pl)
        out[coord] = (off[0], shape[0])
    return out


def test_named_lays_data_model_out_in_the_references_block_order():
    """A dim over ("data", "model") on (16, 16): rank (i, j) holds block
    i·16 + j (JAX's major-to-minor order); ("pod", "data") on (2, 16, 16):
    rank (p, d, ·) block p·16 + d; out of mesh order is refused (it would
    need a ``_StridedShard``)."""
    blocks = _blocks((("data", "model"),), (16, 16), ("data", "model"),
                     256 * 4)
    for (i, j), (off, n) in blocks.items():
        assert (off, n) == ((i * 16 + j) * 4, 4)
    blocks = _blocks((("pod", "data"),), (2, 16, 16),
                     ("pod", "data", "model"), 32 * 3)
    for (p, d, m), (off, n) in blocks.items():
        assert (off, n) == ((p * 16 + d) * 3, 3)
    mesh = tshd.MeshShape((16, 16), ("data", "model"))
    assert tshd.placements(mesh, (("data", "model"), None)) == (
        Shard(0), Shard(0))
    assert tshd.placements(mesh, (None, "model")) == (Replicate(), Shard(1))
    assert tshd.named(mesh, {"a": [(None, "data")]}) == {
        "a": [(Shard(1), Replicate())]}
    with pytest.raises(ValueError, match="order"):
        tshd.placements(mesh, (("model", "data"),))
