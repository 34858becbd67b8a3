"""Int8 error-feedback gradient compression for cross-pod (DCN) sync —
the JAX package's ``train/compression.py`` on torch tensors.

DCN is the scarcest bandwidth in a multi-pod fleet (DESIGN §7).  The
cross-pod gradient exchange is compressed 4× by quantizing each gradient
leaf to int8 with a per-leaf scale and *error feedback* (the quantization
residual is added to the next step's gradient — provably preserves SGD
convergence, Karimireddy et al. 2019).

Wire format per leaf: int8 tensor + f32 scale.  The exchange
(:func:`cross_pod_mean`) is an ``all_gather_into_tensor`` of the int8
payload over the ``pod`` dim of a ``DeviceMesh`` (true int8 on the wire)
followed by a local dequantized mean — for small pod counts this moves
(P−1)/P · ¼ the bytes of an f32 ring all-reduce.
"""

from __future__ import annotations

import torch

__all__ = ["cross_pod_mean", "dequantize", "init_error_state", "quantize"]


def quantize(g, err):
    """(int8 payload, f32 scale, new error) with error feedback."""
    gf = g.to(torch.float32) + err
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.to(torch.float32) * scale
    return q, scale, new_err


def dequantize(q, scale):
    return q.to(torch.float32) * scale


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    return next(it)


def _all_gather(x, group, size: int):
    """(P, *x.shape): every pod's ``x``, in pod order."""
    import torch.distributed as dist
    out = torch.empty((size * x.numel(),), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=group)
    return out.reshape((size,) + tuple(x.shape))


def cross_pod_mean(grads, err_state, mesh, axis_name: str = "pod"):
    """Compressed mean over the ``axis_name`` dim of ``mesh`` (the JAX
    package's, inside ``shard_map`` over ``pod``).

    grads/err_state: this rank's pod's gradients and error buffers, a
    tensor or a dict of them (nested dicts allowed).  Each leaf is
    quantized with error feedback, its int8 payload and float32 scale
    are all-gathered over the pod group, and the dequantized payloads
    are averaged in the reference's order.  Returns (mean grads in each
    gradient's type, new error state)."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(f"cross_pod_mean: mesh dims {names} have no "
                         f"{axis_name!r}")
    group = mesh.get_group(axis_name)
    size = mesh.size(names.index(axis_name))

    def leaf(g, err):
        q, scale, new_err = quantize(g, err)
        qs = _all_gather(q, group, size)                 # (P, ...) int8
        ss = _all_gather(scale.reshape(1), group, size)  # (P, 1) f32
        deq = qs.to(torch.float32) * ss.reshape((-1,) + (1,) * (qs.ndim - 1))
        return deq.mean(0).to(g.dtype), new_err

    out = [leaf(g, e) for g, e in zip(_leaves(grads), _leaves(err_state))]
    return (_unflatten(grads, iter(o[0] for o in out)),
            _unflatten(grads, iter(o[1] for o in out)))


def init_error_state(grads):
    """Zero float32 error buffers shaped like ``grads`` (a dict of
    tensors, or one tensor)."""
    if isinstance(grads, dict):
        return {k: init_error_state(g) for k, g in grads.items()}
    return torch.zeros(grads.shape, dtype=torch.float32,
                       device=grads.device)
