"""Atomic, async checkpoints of the training state — the JAX package's
``checkpoint/checkpoint.py`` on torch tensors, in the same file layout.

Layout (one directory per step):
    step_000100/
      manifest.json      — leaf paths, shapes, dtypes, mesh shape
      shard_<host>.npz   — this host's leaves ``leaf_<i>`` (here: 1 host)

Properties:
  * async — `save_async` snapshots device → host on the caller's thread
    (at the named boundary ``checkpoint.snapshot``: its copies are the
    scope's counted reads) and writes in a background thread; the device
    steps continue as soon as the snapshot is taken,
  * atomic — writes go to ``<dir>.tmp`` then rename, so a failure
    mid-save never corrupts the latest checkpoint,
  * self-describing — the manifest stores logical shapes and dtypes.

npz has no bfloat16 (and the port carries no ``ml_dtypes``): a bfloat16
leaf is stored as its bit pattern in ``uint16`` and recorded as
``"bfloat16"`` in the manifest, as the JAX package stores it, so either
package reads the other's bfloat16 leaves bit for bit.

A state is a tree of dicts (keys in sorted order, as JAX flattens them),
lists and tuples, whose leaves are tensors (or numpy arrays, for a
snapshot); a module stands for its ``named_parameters()``.  Paths are
written as JAX's ``keystr`` writes them.

A leaf may be a :class:`Stacked`: a list of tensors saved as one array,
stacked on the host along a new first axis, and restored by copying each
slice back into its tensor.  ``convert.reference_tree`` uses it to write
a model's train state in the JAX package's tree (each layer leaf stacked
over the periods), so that either package restores the other's file.
``restore(..., mesh=, shardings=)`` is the elastic restart: each leaf
is placed with ``distribute_tensor`` onto the target ``DeviceMesh`` at
its spec (a ``models.sharding`` spec or a tuple of DTensor placements),
whatever mesh saved it.  A DTensor leaf is saved whole
(``full_tensor()``, a collective every rank takes part in).
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from ..runtime.boundary import host_boundary

__all__ = ["CheckpointManager", "Stacked", "tree_leaves", "tree_paths"]


class Stacked:
    """One leaf made of tensors of one shape and type, saved as their
    stack along a new first axis (on the host, in the snapshot); a
    restore copies each slice back into its tensor."""

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def shape(self):
        return (len(self.parts),) + tuple(self.parts[0].shape)

    @property
    def dtype(self):
        return self.parts[0].dtype


def _items(tree, prefix=""):
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _items(x, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def tree_leaves(tree) -> list:
    return [x for _, x in _items(tree)]


def tree_paths(tree) -> list[str]:
    return [p for p, _ in _items(tree)]


def _host(t, hb) -> np.ndarray:
    """A leaf as a host numpy array of its own type (bfloat16 as its
    ``uint16`` bit pattern), a CUDA tensor copied through ``hb.read``; a
    CPU tensor is copied too, so the snapshot does not follow later
    in-place updates."""
    if isinstance(t, np.ndarray):
        return t
    if isinstance(t, Stacked):
        return np.stack([_host(x, hb) for x in t.parts])
    t = t.detach()
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    bf16 = t.dtype == torch.bfloat16
    bits = t.view(torch.int16) if bf16 else t
    arr = np.asarray(hb.read(bits.reshape(-1))).reshape(tuple(t.shape))
    if not t.is_cuda:
        arr = arr.copy()
    return arr.view(np.uint16) if bf16 else arr


def _dtype_name(t) -> str:
    if isinstance(t, np.ndarray):
        return str(t.dtype)
    return str(t.dtype).removeprefix("torch.")


def _copy_into(tgt, saved) -> None:
    """Copy a stored leaf (a CPU tensor) into the target's tensor, or
    each period's slice into its layer's tensor."""
    if isinstance(tgt, Stacked):
        for x, s in zip(tgt.parts, saved):
            x.copy_(s)
    else:
        tgt.copy_(saved)


def _tensor(arr: np.ndarray, dtype_str: str):
    """A stored leaf as a CPU tensor of the manifest's type."""
    if dtype_str == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _is_spec(x) -> bool:
    """A spec (one entry per dim: None, a mesh dim name, a tuple of
    names) or a tuple of DTensor placements: a leaf of ``shardings``."""
    from torch.distributed.tensor import Placement
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, Placement))
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _spec_leaves(tree) -> list:
    if _is_spec(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [x for t in tree for x in _spec_leaves(t)]


def _place(saved, mesh, spec):
    """A restored leaf on ``mesh`` at ``spec``: each rank keeps its own
    shard of the (identical) host copy."""
    from torch.distributed.tensor import Placement, distribute_tensor

    from ..models.sharding import placements
    pl = spec if spec and all(isinstance(e, Placement) for e in spec) \
        else placements(mesh, spec)
    return distribute_tensor(saved.to(mesh.device_type), mesh, pl,
                             src_data_rank=None)


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken from ``it`` in
    :func:`tree_leaves` order."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out[k] = _rebuild(tree[k], it)
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, it) for x in tree)
    return next(it)


def _snapshot(state) -> list:
    """[(path, host array, type name)] of the state's leaves, copied
    device → host at the boundary ``checkpoint.snapshot``."""
    items = list(_items(state))
    device = next((t.device for _, x in items
                   for t in (x.parts if isinstance(x, Stacked) else [x])
                   if isinstance(t, torch.Tensor)), None)
    with host_boundary("checkpoint.snapshot", device) as hb:
        return [(p, _host(x, hb), _dtype_name(x)) for p, x in items]


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, state, mesh_shape=None) -> Path:
        """Synchronous atomic save."""
        return self._write(step, _snapshot(state), mesh_shape)

    def save_async(self, step: int, state, mesh_shape=None):
        """Snapshot on the caller thread (device→host copy), write in the
        background.  Joins any in-flight save first (ordering)."""
        self.wait()
        snapshot = _snapshot(state)
        self._thread = threading.Thread(
            target=self._write, args=(step, snapshot, mesh_shape),
            daemon=True)
        self._thread.start()

    def _write(self, step: int, snapshot: list, mesh_shape) -> Path:
        host = {f"leaf_{i}": x for i, (_, x, _) in enumerate(snapshot)}
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "shard_0.npz", **host)
        manifest = {
            "step": step,
            "paths": [p for p, _, _ in snapshot],
            "shapes": [list(x.shape) for _, x, _ in snapshot],
            "dtypes": [dt for _, _, dt in snapshot],
            "mesh_shape": list(mesh_shape) if mesh_shape else None,
            "n_hosts": 1,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()
        return final

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._thread = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if p.is_dir() and not p.name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree, mesh=None, shardings=None):
        """Restore into ``target_tree``: every leaf is copied in place into
        the target's tensor (on its device), after the leaf count, shapes
        and types are checked.  Returns ``target_tree``.

        With ``mesh`` and ``shardings`` (a tree of specs or placements,
        leaf for leaf with the target, as ``train.steps.train_state_specs``
        gives them) each leaf is instead placed on ``mesh`` with
        ``distribute_tensor`` — the elastic restart onto a mesh of any
        size — and the same tree is returned with DTensor leaves (a
        module as the dict of its named parameters)."""
        if (mesh is None) != (shardings is None):
            raise ValueError("CheckpointManager.restore: give both mesh "
                             "and shardings, or neither")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        data = np.load(d / "shard_0.npz")
        leaves = [_tensor(data[f"leaf_{i}"], dt)
                  for i, dt in enumerate(manifest["dtypes"])]
        t_leaves = tree_leaves(target_tree)
        if len(t_leaves) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(leaves)} leaves, target expects "
                f"{len(t_leaves)} — structure changed since save")
        for saved, tgt, path in zip(leaves, t_leaves, manifest["paths"]):
            if tuple(saved.shape) != tuple(tgt.shape):
                raise ValueError(f"shape mismatch at {path}: "
                                 f"{tuple(saved.shape)} vs "
                                 f"{tuple(tgt.shape)}")
            if saved.dtype != tgt.dtype:
                raise ValueError(f"dtype mismatch at {path}: "
                                 f"{saved.dtype} vs {tgt.dtype}")
        if mesh is not None:
            specs = _spec_leaves(shardings)
            if len(specs) != len(leaves):
                raise ValueError(f"shardings have {len(specs)} leaves, the "
                                 f"checkpoint {len(leaves)}")
            return _rebuild(target_tree, iter(
                _place(x, mesh, s) for x, s in zip(leaves, specs)))
        with torch.no_grad():
            for saved, tgt in zip(leaves, t_leaves):
                _copy_into(tgt, saved)
        return target_tree

