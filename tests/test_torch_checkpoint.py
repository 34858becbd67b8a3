"""The port's ``CheckpointManager`` on the CPU: the JAX package's cases
(``tests/test_checkpoint_runtime.py``) carried to torch tensors, the
shared file layout, and bfloat16 leaves read bit for bit across the two
packages (both store a bfloat16 leaf as its ``uint16`` bit pattern and
record ``"bfloat16"`` in the manifest)."""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JaxManager
from repro.checkpoint.checkpoint import tree_paths as jax_tree_paths
from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                               tree_paths)
from repro_torch.configs import get_smoke_config
from repro_torch.convert import reference_tree
from repro_torch.launch.train import MESH_SHAPE
from repro_torch.train.steps import init_train_state
from _train_kinds import _jax_tree

# the train states of the layout and round-trip cases: a dense smoke
# config and two with the new layer kinds (jamba: Mamba, attention, MoE
# and MLP layers over 2 periods of 8; rwkv6-3b: time and channel mix)
STATE_ARCHS = ["granite-3-2b", "jamba-v0.1-52b", "rwkv6-3b"]


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 8), generator=g),
                       "b": torch.zeros((8,))},
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    st = _state()
    mgr.save(7, st, mesh_shape=(16, 16))
    assert mgr.all_steps() == [7]
    target = _zeros_like(st)
    back = mgr.restore(7, target)
    assert back is target                          # restored in place
    assert torch.equal(back["params"]["w"], st["params"]["w"])
    assert int(back["step"]) == 7 and back["step"].dtype == torch.int32


def test_async_save_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, _state(s))
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    assert mgr._thread is None


def test_async_snapshot_is_taken_before_the_caller_moves_on(tmp_path):
    """``save_async`` copies the state on the caller's thread: an
    in-place update right after it does not reach the file."""
    mgr = CheckpointManager(tmp_path)
    st = _state()
    want = st["params"]["w"].clone()
    gate = threading.Event()
    real_write = mgr._write
    mgr._write = lambda *a: (gate.wait(10), real_write(*a))[1]
    mgr.save_async(1, st)
    st["params"]["w"].add_(1.0)                    # the next step's update
    gate.set()
    mgr.wait()
    back = mgr.restore(1, _zeros_like(st))
    assert torch.equal(back["params"]["w"], want)


def test_restore_rejects_structure_change(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _state())
    bad = {"params": {"w": torch.zeros((4, 4))},
           "step": torch.tensor(0, dtype=torch.int32)}
    with pytest.raises(ValueError, match="structure changed"):
        mgr.restore(1, bad)
    bad = _zeros_like(_state())
    bad["params"]["w"] = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(1, bad)
    bad = _zeros_like(_state())
    bad["params"]["w"] = torch.zeros((8, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype mismatch"):
        mgr.restore(1, bad)


def test_restore_onto_a_mesh_is_not_ported(tmp_path):
    """The elastic restore is ported (``tests/test_torch_shard_gloo.py``
    restores onto two mesh sizes); a mesh without shardings, or
    shardings without a mesh, is refused before anything is read."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _state())
    for kw in ({"mesh": object()}, {"shardings": object()}):
        with pytest.raises(ValueError, match="both mesh and shardings"):
            mgr.restore(1, _zeros_like(_state()), **kw)


def test_bf16_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    st = {"w": torch.randn((16, 16)).to(torch.bfloat16),
          "v": torch.ones((4,))}
    mgr.save(3, st)
    back = mgr.restore(3, _zeros_like(st))
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16),
                       st["w"].view(torch.int16))


def test_atomic_tmpdir_never_latest(tmp_path):
    mgr = CheckpointManager(tmp_path)
    (tmp_path / "step_00000099.tmp").mkdir()       # a crashed writer
    mgr.save(1, _state())
    assert mgr.all_steps() == [1]
    assert mgr.latest_step() == 1


def _train_state(arch, seed=0):
    """A smoke config's bf16 train state with nonzero moments, step 3."""
    st = init_train_state(seed, get_smoke_config(arch), device="cpu")
    with torch.no_grad():
        for t in list(st["m"].values()) + list(st["v"].values()):
            t.normal_()
    st["step"].fill_(3)
    return st


@pytest.mark.parametrize("case", ["leaves"] + STATE_ARCHS[1:])
def test_layout_matches_the_references(tmp_path, case):
    """The same state saved by both packages: the same files, manifest
    keys, paths, shapes, dtypes and npz members.  "leaves": a tree of
    three leaves; an arch: its smoke train state, which the port writes
    in the JAX package's tree (``convert.reference_tree``: every layer
    leaf stacked over the periods), and each package restores the
    other's file."""
    if case == "leaves":
        rng = np.random.default_rng(0)
        w = rng.standard_normal((3, 5)).astype(np.float32)
        b = rng.standard_normal(4).astype(np.float32)
        jax_state = {"b": jnp.asarray(b).astype(jnp.bfloat16),
                     "step": jnp.int32(5), "w": jnp.asarray(w)}
        port_state = {"w": torch.from_numpy(w), "step": torch.tensor(
            5, dtype=torch.int32),
            "b": torch.from_numpy(b).to(torch.bfloat16)}
    else:
        port_state = _train_state(case)
        jax_state = {k: v for k, v in _jax_tree(port_state).items()}
    JaxManager(tmp_path / "jax").save(5, jax_state, mesh_shape=(1, 1))
    CheckpointManager(tmp_path / "port").save(
        5, port_state if case == "leaves" else reference_tree(port_state),
        mesh_shape=MESH_SHAPE)
    dirs = [tmp_path / side / "step_00000005" for side in ("jax", "port")]
    assert [sorted(p.name for p in d.iterdir()) for d in dirs] == \
        [["manifest.json", "shard_0.npz"]] * 2
    mj, mp = (json.loads((d / "manifest.json").read_text()) for d in dirs)
    assert mj == mp
    if case == "leaves":
        assert mp["dtypes"] == ["bfloat16", "int32", "float32"]
        assert mp["paths"] == ["['b']", "['step']", "['w']"]
    else:
        assert any(p.startswith("['params']['periods'][1]")
                   for p in mp["paths"]) == (case == "jamba-v0.1-52b")
        back = JaxManager(tmp_path / "port").restore(5, jax_state)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax_state)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        fresh = _train_state(case, seed=1)
        CheckpointManager(tmp_path / "jax").restore(5, reference_tree(fresh))
        for key, x in _leaves(port_state).items():
            assert torch.equal(_bits(x), _bits(_leaves(fresh)[key])), key
    nj, np_ = (np.load(d / "shard_0.npz") for d in dirs)
    assert sorted(nj.files) == sorted(np_.files)
    for k in nj.files:
        assert nj[k].dtype == np_[k].dtype and np.array_equal(nj[k], np_[k])


def test_bf16_leaves_read_across_packages(tmp_path):
    """A bfloat16 leaf written by the port reads back bit for bit
    through numpy's ``uint16`` view and through the JAX package's
    manager; one written by the JAX package restores into the port bit
    for bit."""
    bits = np.random.default_rng(1).integers(0, 2 ** 16, (6, 7),
                                             dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0             # no NaN / inf
    t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    CheckpointManager(port_dir).save(1, {"w": t})
    raw = np.load(port_dir / "step_00000001" / "shard_0.npz")["leaf_0"]
    assert raw.dtype == np.uint16 and np.array_equal(raw, bits)
    back = JaxManager(port_dir).restore(1, {"w": jnp.zeros((6, 7),
                                                           jnp.bfloat16)})
    assert back["w"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(back["w"]).view(np.uint16), bits)

    JaxManager(jax_dir).save(2, {"w": jnp.asarray(bits.view(jnp.bfloat16))})
    target = {"w": torch.zeros((6, 7), dtype=torch.bfloat16)}
    CheckpointManager(jax_dir).restore(2, target)
    assert np.array_equal(target["w"].view(torch.int16).numpy()
                          .view(np.uint16), bits)


def _bits(t):
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _leaves(st):
    out = {f"params:{n}": p for n, p in st["params"].named_parameters()}
    for part in ("m", "v"):
        out.update({f"{part}:{n}": t for n, t in st[part].items()})
    return dict(out, step=st["step"])


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_train_state_roundtrip_bit_for_bit(tmp_path, arch):
    """A bfloat16 train state (a module's parameters, named float32
    moments, the int32 step) in the JAX package's tree
    (``convert.reference_tree``) through save_async and restore into a
    fresh state: every leaf equal bit for bit, and the manifest's paths
    are the JAX package's train state's."""
    cfg = get_smoke_config(arch)                    # bfloat16
    st = _train_state(arch)
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(3, reference_tree(st), mesh_shape=MESH_SHAPE)
    mgr.wait()
    fresh = init_train_state(1, cfg, device="cpu")
    mgr.restore(mgr.latest_step(), reference_tree(fresh))
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json")
                          .read_text())
    assert manifest["paths"] == tree_paths(reference_tree(st))
    assert manifest["paths"] == jax_tree_paths(_jax_tree(st))
    assert manifest["mesh_shape"] == [1, 1]
    assert "bfloat16" in manifest["dtypes"]
    for (n, a), (_, b) in zip(st["params"].named_parameters(),
                              fresh["params"].named_parameters()):
        assert a.dtype == b.dtype
        assert torch.equal(_bits(a), _bits(b)), n
        assert b.requires_grad
    assert any(p.dtype == torch.bfloat16 for p in st["params"].parameters())
    for part in ("m", "v"):
        for n in st[part]:
            assert torch.equal(st[part][n], fresh[part][n])
    assert int(fresh["step"]) == 3
