"""Int8 error-feedback gradient compression for cross-pod (DCN) sync —
the JAX package's ``train/compression.py`` on torch tensors.

DCN is the scarcest bandwidth in a multi-pod fleet (DESIGN §7).  The
cross-pod gradient exchange is compressed 4× by quantizing each gradient
leaf to int8 with a per-leaf scale and *error feedback* (the quantization
residual is added to the next step's gradient — provably preserves SGD
convergence, Karimireddy et al. 2019).

Wire format per leaf: int8 tensor + f32 scale.  The exchange itself
(:func:`cross_pod_mean`, an ``all_gather`` over a pod axis of a device
mesh) needs more than one device and is not ported.
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


def cross_pod_mean(grads, err_state, axis_name: str = "pod"):
    """The compressed mean over a pod axis: an ``all_gather`` of the
    int8 payloads across pods.  One card has no pod axis."""
    raise NotImplementedError(
        "cross_pod_mean: the all_gather over a pod axis needs a device "
        "mesh of several pods; it waits with the XLA-bound part of ROADMAP "
        "queue 1 item 7")


def init_error_state(grads):
    """Zero float32 error buffers shaped like ``grads`` (a dict of
    tensors, or one tensor)."""
    if isinstance(grads, dict):
        return {k: init_error_state(g) for k, g in grads.items()}
    return torch.zeros(grads.shape, dtype=torch.float32,
                       device=grads.device)
