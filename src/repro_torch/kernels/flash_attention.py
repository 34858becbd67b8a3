"""K4 — causal / sliding-window GQA flash attention (forward), and its
plain twin.

:func:`flash_attention_kernel` is the wrapper, with the JAX package's
layouts (q (B, T, H, hd); k, v (B, T, KV, hd), self-attention positions
0..T−1; returns (B, T, H, hd) in q's type): on CUDA tensors it launches
the hand-written kernel ``csrc/flash_attention.cu`` (which replaces
``flash_attention_kernel`` of the JAX package's
``kernels/flash_attention.py``), on CPU tensors it runs the plain
PyTorch version :func:`~repro_torch.kernels.ref.flash_attention_plain`.
Both compute ``_flash_kernel``'s function: scores in float32, masked
scores −1e30, an online softmax in float32, p cast to v's type before
p·v.  The TPU wrapper's ``q_block``/``kv_block``/``interpret`` arguments
have no counterpart: the kernel's tiles are fixed (64 rows) and masked
at the ragged edge.
"""

from __future__ import annotations

import ctypes

from .cuda import CudaKernel
from .ref import flash_attention_plain

__all__ = ["FLASH_KERNEL", "FLASH_TILE", "HEAD_DIMS",
           "flash_attention_kernel", "flash_attention_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int

FLASH_KERNEL = CudaKernel(
    "flash_attention", "flash_attention", "viem_flash_attention",
    [_P, _P, _P, _P,            # q, k, v, o
     _I, _I, _I, _I, _I,        # batch, seq, heads, kv_heads, head_dim
     _I, ctypes.c_float, _I,    # window, scale, bf16
     _P])                       # stream

HEAD_DIMS = (32, 64, 96, 128)   # the kernel's instantiations
FLASH_TILE = 64                 # q rows and kv rows of a tile (kTile)


def _check(q, k, v, window):
    import torch
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention_kernel: q must be (B,T,H,hd) and "
                         f"k, v (B,T,KV,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, hd = q.shape
    if k.shape[0] != b or k.shape[1] != t or k.shape[3] != hd \
            or h % k.shape[2]:
        raise ValueError(f"flash_attention_kernel: k/v {tuple(k.shape)} do "
                         f"not match q {tuple(q.shape)} (S = T, KV | H)")
    if window < 0:
        raise ValueError(f"flash_attention_kernel: window {window} < 0")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_kernel: q, k, v must all be "
                         f"float32 or all bfloat16; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")


def flash_attention_kernel(q, k, v, *, window: int = 0):
    """Causal attention of q over k, v (sliding-window when ``window`` >
    0): K4 for CUDA tensors, the plain version for CPU tensors."""
    _check(q, k, v, window)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, window=window)
    import torch
    b, t, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_kernel: head_dim {hd} is not one "
                         f"of the kernel's {HEAD_DIMS}")
    for key, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention_kernel: {key} is on "
                             f"{x.device}, expected {q.device}")
    for key, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_attention_kernel: {key} must be "
                             f"contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention_kernel: {key} is not 16-byte "
                             f"aligned")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        FLASH_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), b, t, h, int(k.shape[2]), hd,
                            int(window), hd ** -0.5,
                            int(q.dtype == torch.bfloat16), stream)
    return o
