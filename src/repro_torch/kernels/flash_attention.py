"""K4 — causal / sliding-window GQA flash attention (forward), and its
plain twin.

:func:`flash_attention_kernel` is the wrapper, with the JAX package's
layouts (q (B, T, H, hd); k, v (B, T, KV, hd), self-attention positions
0..T−1; returns (B, T, H, hd) in q's type).  On CUDA tensors it takes
one of two hand-written kernels by dtype, both replacing
``flash_attention_kernel`` of the JAX package's
``kernels/flash_attention.py``:

  bfloat16 — ``csrc/flash_attention_sm90.cu`` (:data:`FLASH_KERNEL`):
             ``wgmma`` on bf16 tiles fed by TMA through an mbarrier ring,
             128-row q and kv tiles, exp2 with log2 e folded into the
             scale;
  float32  — ``csrc/flash_attention.cu`` (:data:`FLASH_F32_KERNEL`):
             ``wgmma`` on TF32 tiles through a 3xTF32 split (big·big +
             big·small + small·big of every product), fed by TMA, 128-row
             q tiles (two warpgroups of 64 rows) and 32-key kv tiles,
             exp2 with log2 e folded into the scale; a pre-pass in the
             same launch splits k and v and transposes v into a scratch
             this wrapper allocates.

On CPU tensors it runs the plain PyTorch version
:func:`~repro_torch.kernels.ref.flash_attention_plain`.  All compute
``_flash_kernel``'s function: scores in float32, masked scores −1e30, an
online softmax in float32, p cast to v's type before p·v.  The TPU
wrapper's ``q_block``/``kv_block``/``interpret`` arguments have no
counterpart: the kernels' tiles are fixed and masked at the ragged edge.

K4 is forward only, and writes into a buffer autograd knows nothing of:
under grad mode with q, k or v requiring grad the wrapper raises on
both devices, rather than return a tensor through which ``wq``, ``wk``
and ``wv`` would get no gradient (training attends through
``models.attention.blocked_flash_attention``).
"""

from __future__ import annotations

import ctypes
import math

from .cuda import CudaKernel
from .ref import flash_attention_plain

__all__ = ["FLASH_F32_KERNEL", "FLASH_KERNEL", "FLASH_SM90_TILES",
           "FLASH_TILE", "HEAD_DIMS", "LOG2E", "f32_scratch_floats",
           "flash_attention_kernel", "flash_attention_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# the bfloat16 entry: q, k, v, o; batch, seq, heads, kv_heads, head_dim;
# window, scale (hd^-½·log2 e); stream.  The float32 entry takes its
# scratch and the scratch's floats after o.
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
_F32_ARGS = _ARGS[:4] + [_P, ctypes.c_longlong] + _ARGS[4:]

FLASH_KERNEL = CudaKernel(          # bfloat16
    "flash_attention", "flash_attention_sm90", "viem_flash_attention_sm90",
    _ARGS)
FLASH_F32_KERNEL = CudaKernel(      # float32
    "flash_attention_f32", "flash_attention", "viem_flash_attention",
    _F32_ARGS)

HEAD_DIMS = (32, 64, 96, 128)   # both kernels' head dims
FLASH_TILE = (128, 32)          # q rows and kv rows of a float32 tile
FLASH_SM90_TILES = (128, 128)   # q rows and kv rows of a bf16 tile
LOG2E = math.log2(math.e)       # folded into both kernels' scale


def f32_scratch_floats(b: int, t: int, kv: int, hd: int) -> int:
    """Floats of scratch the float32 kernel takes for these sizes, as its
    C side sizes them (``viem_flash_attention_scratch_floats``: k's big
    and small parts and vᵀ's); builds the kernel's library if needed."""
    fn = FLASH_F32_KERNEL.library().viem_flash_attention_scratch_floats
    fn.argtypes = [_I] * 4
    fn.restype = ctypes.c_longlong
    return int(fn(b, t, kv, hd))


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


META_OBSERVERS: list = []


def attended_pairs(t: int, window: int = 0) -> int:
    """The (query, key) pairs causal attention over t positions keeps
    (each query its last ``window`` keys when ``window`` > 0)."""
    if not window or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def flash_flops(b: int, t: int, h: int, hd: int, window: int = 0) -> int:
    """K4's analytic count: q·kᵀ and p·v, 2·hd each per kept pair."""
    return 4 * b * h * hd * attended_pairs(t, window)


def flash_attention_kernel(q, k, v, *, window: int = 0):
    """Causal attention of q over k, v (sliding-window when ``window`` >
    0): K4 for CUDA tensors (bfloat16 through the sm90 kernel, float32
    through the float32 one), the plain version for CPU tensors.  Meta
    tensors (a shape-only trace, as the dry-run makes) give an empty
    output of q's shape and tell each of ``META_OBSERVERS`` the launch
    (``fn(q, k, v, window)``)."""
    import torch
    _check(q, k, v, window)
    if q.is_meta:
        for fn in META_OBSERVERS:
            fn(q, k, v, window)
        return torch.empty_like(q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention_kernel: K4 has no backward, and q, k or v "
            "requires grad under grad mode; train through "
            "models.attention.blocked_flash_attention (attention_block("
            "..., train=True)), or call K4 under torch.no_grad() / "
            "torch.inference_mode()")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, window=window)
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
    kv = int(k.shape[2])
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
        args = (b, t, h, kv, hd, int(window), hd ** -0.5 * LOG2E, stream)
        if q.dtype == torch.bfloat16:
            FLASH_KERNEL.launch(*ptrs, *args)
        else:
            n = f32_scratch_floats(b, t, kv, hd)
            scratch = torch.empty(n, dtype=torch.float32, device=q.device)
            FLASH_F32_KERNEL.launch(*ptrs, scratch.data_ptr(), n, *args)
    return o
