"""Training entry point: data pipeline → train loop → checkpoints → fault
tolerance — the JAX package's ``launch/train.py`` on one card.

Usage (local smoke; any shipped ``--arch``, every layer kind and
modality frontend):
    PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b \\
        --smoke --steps 20 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 4 --batch 4 --seq 4096 --microbatches 4

Runs on ``cuda`` unless ``--device cpu`` (no fallback: without a card
the default raises).  :func:`train` builds the local mesh
(:func:`make_local_mesh`: the reference's rule over the ranks present;
on one card a (1, 1) mesh over a world-1 NCCL group the launcher starts
from a local store, with no network) and passes it to
``build_train_step``, as the reference does; :func:`train_model` takes a
mesh or none.  Checkpoints record the mesh's shape and hold the train
state in the JAX package's layout (leaves stacked over periods, the
same paths).  Each step's
batch is uploaded through page-locked memory without blocking (boundary
``train.batch``); the step itself
(forward, backward, AdamW) runs inside the boundary ``train.step``,
whose syncs — on this thread and on the autograd engine's — are counted
on CUDA and reported per step; the log values
(loss, grad norm, lr) come back in one counted read (boundary
``train.log``), which is also where the step's time is taken.  Weights
are random from seed 0 (``init_train_state``: other numbers than the
JAX package's PRNG key 0 gives).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint.checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..convert import reference_tree
from ..data.pipeline import Prefetcher, SyntheticLM
from ..runtime.boundary import host_boundary
from ..runtime.device import resolve_device
from ..runtime.fault_tolerance import Action, StragglerMonitor
from ..train import OptConfig
from ..train.steps import (build_train_step, gather_train_state,
                           init_train_state)

__all__ = ["MESH_SHAPE", "main", "make_local_mesh", "train", "train_model",
           "upload"]

MESH_SHAPE = (1, 1)             # (data, model) of one card


def make_local_mesh(device=None):
    """A ("data", "model") ``DeviceMesh`` over the ranks present: model
    the largest of 16, 8, 4, 2, 1 dividing the rank count, data the
    rest (the reference's ``launch/train.py:26`` rule).  Without a
    process group it starts a world-1 one itself (NCCL on a card, gloo
    on the CPU) from an in-process ``HashStore``: no network."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    model = next(c for c in (16, 8, 4, 2, 1) if n % c == 0)
    return DeviceMesh(dev.type, torch.arange(n).reshape(n // model, model),
                      mesh_dim_names=("data", "model"))


def upload(batch: dict, device) -> dict:
    """A host batch (numpy) on ``device``; to a card through page-locked
    memory with ``non_blocking`` (a pageable copy would sync).  The
    caching host allocator keeps each page-locked block until its copy
    has run."""
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def train(arch: str, steps: int, global_batch: int, seq_len: int,
          smoke: bool = False, ckpt_dir: str | None = None,
          ckpt_every: int = 10, microbatches: int = 1,
          log_every: int = 1, device=None) -> dict:
    """:func:`train_model` of ``arch``'s config (its smoke config with
    ``smoke``) on :func:`make_local_mesh`: every shipped config, of any
    layer kind, trains through the same code.  A process group this call
    starts, it destroys at the end, after gathering the returned state
    back into plain tensors."""
    import torch.distributed as dist
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    started = not dist.is_initialized()
    mesh = make_local_mesh(device)
    try:
        out = train_model(cfg, steps, global_batch, seq_len,
                          ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                          microbatches=microbatches, log_every=log_every,
                          device=device, mesh=mesh)
        if started:
            gather_train_state(out["state"])
        return out
    finally:
        if started:
            dist.destroy_process_group()


def train_model(cfg, steps: int, global_batch: int, seq_len: int,
                ckpt_dir: str | None = None, ckpt_every: int = 10,
                microbatches: int = 1, log_every: int = 1,
                device=None, mesh=None) -> dict:
    """Train ``cfg`` for ``steps`` steps (resuming from the latest
    checkpoint in ``ckpt_dir``, if any).  Returns ``final_loss`` and
    ``state``, as the JAX package does, and ``log``: per step run, its
    ``step``, ``loss``, ``grad_norm``, ``lr``, ``seconds`` (upload, step
    and the log read, as the log line prints), and on CUDA the syncs
    each boundary saw (``step_syncs``, ``batch_syncs``, ``log_syncs``
    beside ``log_reads``; None on the CPU).  With a ``mesh`` the state
    is placed on it at the first step (after any restore) and the step
    runs on DTensors."""
    dev = resolve_device(device)
    opt = OptConfig(total_steps=steps, warmup_steps=max(1, steps // 10))
    step_fn, _, _ = build_train_step(cfg, mesh, opt=opt,
                                     global_batch=global_batch,
                                     microbatches=microbatches)
    mesh_shape = MESH_SHAPE if mesh is None else tuple(mesh.shape)

    data = SyntheticLM(cfg.vocab_size, seq_len, global_batch,
                       frontend_tokens=cfg.frontend_tokens,
                       d_model=cfg.d_model)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    monitor = StragglerMonitor(n_hosts=1)

    start_step = 0
    state = init_train_state(0, cfg, device=dev)
    if mgr is not None and mgr.latest_step() is not None:
        start_step = mgr.latest_step()
        mgr.restore(start_step, reference_tree(state))
        print(f"restored checkpoint at step {start_step}")

    pre = Prefetcher(data, start_step=start_step)
    loss = float("nan")
    log = []
    try:
        for step in range(start_step, steps):
            host = pre.next()
            t0 = time.perf_counter()
            with host_boundary("train.batch", dev) as hb_batch:
                batch = upload(host, dev)
            # all threads: the backward runs on autograd's device thread
            with host_boundary("train.step", dev,
                               all_threads=True) as hb_step:
                state, metrics = step_fn(state, batch)
            with host_boundary("train.log", dev) as hb_log:
                loss, gnorm, lr = (float(x) for x in hb_log.read(
                    torch.stack([metrics["loss"], metrics["grad_norm"],
                                 metrics["lr"]])))
            dt = time.perf_counter() - t0
            log.append({"step": step, "loss": loss, "grad_norm": gnorm,
                        "lr": lr, "seconds": dt,
                        "step_syncs": hb_step.syncs,
                        "batch_syncs": hb_batch.syncs,
                        "log_reads": hb_log.reads,
                        "log_syncs": hb_log.syncs})
            action, slow = monitor.record_step({0: dt})
            if action is not Action.CONTINUE:
                print(f"[ft] straggler action: {action} hosts={slow}")
            if step % log_every == 0:
                print(f"step {step:5d} loss={loss:.4f} "
                      f"gnorm={gnorm:.3f} "
                      f"lr={lr:.2e} {dt*1e3:.0f}ms",
                      flush=True)
            if mgr is not None and (step + 1) % ckpt_every == 0:
                mgr.save_async(step + 1, reference_tree(state),
                               mesh_shape=mesh_shape)
    finally:
        pre.close()
        if mgr is not None:
            mgr.wait()
    return {"final_loss": loss, "state": state, "log": log}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or "
                         "cpu")
    args = ap.parse_args(argv)
    out = train(args.arch, args.steps, args.batch, args.seq,
                smoke=args.smoke, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every,
                microbatches=args.microbatches, device=args.device)
    print(f"done: final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
