"""K3 — the dense pair-exchange gain matrix of the QAP, and its plain twin.

With B[u,v] = D[perm[u], perm[v]] and M = C @ Bᵀ (DESIGN §3):

    G[u,v] = M[u,u] + M[v,v] − M[u,v] − M[v,u] − 2·C[u,v]·B[u,v]

with the diagonal zeroed (G[u,v] > 0 ⇔ swapping the PEs of u and v
improves the objective by G[u,v]).

:func:`swap_gain_matrix` is the wrapper, with the JAX package's
signature: on CUDA tensors it launches the hand-written kernel
``csrc/swap_gain.cu`` (which replaces ``swap_gain_matrix`` of the JAX
package's ``kernels/swap_gain.py``: one 2n³ pass over the upper triangle
of 128×128 tiles on 3xTF32 ``wgmma``, fed by TMA), on CPU tensors it runs
the plain PyTorch version :func:`swap_gain_matrix_plain`.  Both compute
in float32 whatever float type they are given.  The kernel's tolerance
contract (exact on the integer instances, 2⁻¹⁸ of each entry's scale on
real data) is ``kernels.ref.swap_gain_limits``.  Like the JAX package,
this module is registered in ``KERNELS`` but not exported from
``kernels.__all__``.
"""

from __future__ import annotations

import ctypes

from .cuda import CudaKernel

__all__ = ["SWAP_GAIN_KERNEL", "swap_gain_matrix", "swap_gain_matrix_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int

SWAP_GAIN_KERNEL = CudaKernel(
    "swap_gain_matrix", "swap_gain", "viem_swap_gain_matrix",
    [_P, _P, _I, _I,            # C, B, n, ld (row stride of C and B)
     _P, _P,                    # d (scratch), G
     _P])                       # stream
# TMA reads C and B: a row stride that is a multiple of 16 bytes and a
# 16-byte aligned base
_ALIGN_FLOATS = 4


def _square_f32(C, B):
    import torch
    n = C.shape[0]
    if C.dim() != 2 or tuple(C.shape) != (n, n) or tuple(B.shape) != (n, n):
        raise ValueError(f"C and B must be (n, n), got {tuple(C.shape)}, "
                         f"{tuple(B.shape)}")
    return C.to(torch.float32), B.to(torch.float32)


def swap_gain_matrix_plain(C, B):
    """G (n, n) float32 from C and B in plain PyTorch: M = C @ Bᵀ, the
    formula above, diagonal zeroed."""
    C, B = _square_f32(C, B)
    M = C @ B.T
    d = M.diagonal()
    G = d[:, None] + d[None, :] - M - M.T - 2.0 * C * B
    return G.fill_diagonal_(0.0)


def _pitched(X, ld):
    """X (n, n) copied into the first n columns of a zeroed (n, ld)
    tensor: TMA needs a row stride that is a multiple of 16 bytes.  The
    kernel reads only the first n columns (its tensor maps end there)."""
    import torch
    out = torch.zeros((X.shape[0], ld), dtype=X.dtype, device=X.device)
    out[:, :X.shape[1]] = X
    return out


def swap_gain_matrix(C, B, tile: int = 128):
    """Full gain matrix G (n, n) float32 from the communication matrix C
    and the permuted distance matrix B: the K3 kernel for CUDA tensors,
    :func:`swap_gain_matrix_plain` for CPU tensors.  Any float input is
    cast to float32 first.  ``tile`` is accepted for parity with the JAX
    package; the CUDA kernel picks its own tile.  On CUDA, C and B must be
    contiguous and 16-byte aligned (TMA's rule; raises otherwise); when
    n % 4 != 0 they are copied to a row stride padded to a multiple of 4
    first (the same kernel runs)."""
    del tile
    if not C.is_cuda:
        return swap_gain_matrix_plain(C, B)
    import torch
    C, B = _square_f32(C, B)
    if B.device != C.device:
        raise ValueError(f"swap_gain_matrix: B is on {B.device}, expected "
                         f"{C.device}")
    for key, t in (("C", C), ("B", B)):
        if not t.is_contiguous():
            raise ValueError(f"swap_gain_matrix: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"swap_gain_matrix: {key} is not 16-byte "
                             f"aligned")
    n = int(C.shape[0])
    ld = -(-n // _ALIGN_FLOATS) * _ALIGN_FLOATS
    if ld != n:
        C, B = _pitched(C, ld), _pitched(B, ld)
    d = torch.empty(n, dtype=torch.float32, device=C.device)
    G = torch.empty((n, n), dtype=torch.float32, device=C.device)
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        SWAP_GAIN_KERNEL.launch(C.data_ptr(), B.data_ptr(), n, ld,
                                d.data_ptr(), G.data_ptr(), stream)
    return G
