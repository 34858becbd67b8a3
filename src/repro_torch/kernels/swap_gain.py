"""K3 — the dense pair-exchange gain matrix of the QAP, and its plain twin.

With B[u,v] = D[perm[u], perm[v]] and M = C @ Bᵀ (DESIGN §3):

    G[u,v] = M[u,u] + M[v,v] − M[u,v] − M[v,u] − 2·C[u,v]·B[u,v]

with the diagonal zeroed (G[u,v] > 0 ⇔ swapping the PEs of u and v
improves the objective by G[u,v]).

:func:`swap_gain_matrix` is the wrapper, with the JAX package's
signature: on CUDA tensors it launches the hand-written kernel
``csrc/swap_gain.cu`` (which replaces ``swap_gain_matrix`` of the JAX
package's ``kernels/swap_gain.py``), on CPU tensors it runs the plain
PyTorch version :func:`swap_gain_matrix_plain`.  Both compute in float32
whatever float type they are given.  Like the JAX package, this module
is registered in ``KERNELS`` but not exported from ``kernels.__all__``.
"""

from __future__ import annotations

import ctypes

from .cuda import CudaKernel

__all__ = ["SWAP_GAIN_KERNEL", "swap_gain_matrix", "swap_gain_matrix_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int

SWAP_GAIN_KERNEL = CudaKernel(
    "swap_gain_matrix", "swap_gain", "viem_swap_gain_matrix",
    [_P, _P, _I,                # C, B, n
     _P, _P,                    # d (scratch), G
     _P])                       # stream


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


def swap_gain_matrix(C, B, tile: int = 128):
    """Full gain matrix G (n, n) float32 from the communication matrix C
    and the permuted distance matrix B: the K3 kernel for CUDA tensors,
    :func:`swap_gain_matrix_plain` for CPU tensors.  Any float input is
    cast to float32 first.  ``tile`` is accepted for parity with the JAX
    package; the CUDA kernel picks its own tile."""
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
    n = int(C.shape[0])
    d = torch.empty(n, dtype=torch.float32, device=C.device)
    G = torch.empty((n, n), dtype=torch.float32, device=C.device)
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        SWAP_GAIN_KERNEL.launch(C.data_ptr(), B.data_ptr(), n, d.data_ptr(),
                                G.data_ptr(), stream)
    return G
