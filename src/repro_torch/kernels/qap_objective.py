"""K1 — the sparse QAP objective over an edge list, and its plain twin.

J(C, D, Π) = Σ_{e=(u,v)} w_e · D(Π(u), Π(v)) — the paper's O(m)
evaluation (guide §2.1) with the distance oracle in one of the device
forms a topology's ``kernel_params()`` selects:

  tree    — online hierarchical oracle, k compare/select steps,
  torus   — closed-form k-ary n-cube ring distance per axis,
  matrix  — a gather from the explicit D, float32 or a lossless
            int8/int16 packing (the convert to float32 is exact, so the
            objective is bit-identical to the float table's).

:func:`qap_objective_edges` is the wrapper: on CUDA tensors it launches
the hand-written kernel ``csrc/qap_objective.cu`` (which replaces the
JAX package's three Pallas reductions in ``kernels/qap_objective.py`` and
fuses the Π gather their wrapper did), on CPU tensors it runs the plain
PyTorch version :func:`qap_objective_plain`.  Both take the padded edge
tensors (eu, ev, ew) and the permutation; padding edges (0, 0, w = 0)
are inert.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .cuda import CudaKernel

__all__ = ["OBJECTIVE_KERNEL", "distance_form", "form_args",
           "qap_objective_edges", "qap_objective_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int

OBJECTIVE_KERNEL = CudaKernel(
    "qap_objective", "qap_objective", "viem_qap_objective",
    [_P, _P, _P, _I,            # eu, ev, ew, E
     _P, _P,                    # perm, D
     _I, _I, _I,                # form, nlev, n_pe
     _P, _I, _P, _I,            # ip, n_ip, fp, n_fp
     _P, _I, _P,                # partials, nb, out
     _P])                       # stream

_BLOCK = 256                    # threads per block (viem_objective_block)
_MAX_BLOCKS = 1024
_FORMS = {"tree": 0, "torus": 1}
_MATRIX_FORMS = {"float32": 2, "int8": 3, "int16": 4}


# ------------------------------------------------------------ distance forms
def _hier_distance(pu, pv, strides, dists):
    """Vector online distance oracle: d = dists[lca_level-1], 0 if equal."""
    import torch
    out = torch.zeros(pu.shape, dtype=torch.float32, device=pu.device)
    k = len(dists)
    # from the top level down: overwrite with smaller distances when the
    # pair is in the same subtree at that level
    differ = pu != pv
    out = torch.where(differ, np.float32(dists[k - 1]).item(), out)
    for lvl in range(k - 1, 0, -1):
        same = (pu // strides[lvl]) == (pv // strides[lvl])
        out = torch.where(same & differ, np.float32(dists[lvl - 1]).item(),
                          out)
    return out


def _torus_distance(pu, pv, dims, weights):
    """Closed-form k-ary n-cube oracle: Σ_a w_a · ring(|x_a − y_a|, k_a),
    axis 0 innermost in the PE index (mixed radix)."""
    import torch
    out = torch.zeros(pu.shape, dtype=torch.float32, device=pu.device)
    stride = 1
    for d, w in zip(dims, weights):
        delta = torch.abs((pu // stride) % d - (pv // stride) % d)
        ring = torch.minimum(delta, d - delta).to(torch.float32)
        out = out + np.float32(w).item() * ring
        stride *= d
    return out


def distance_form(kind: str, params: tuple):
    """Device distance fn ``d(p, q, D) -> float32 tensor`` for a
    ``kernel_params`` kind.  ``D`` is the explicit matrix for ``kind ==
    "matrix"`` (float32 or a lossless int8/int16 packing — the
    post-gather convert is exact) and an ignored dummy for the closed
    forms, so every caller threads one argument list."""
    import torch
    if kind == "tree":
        strides, dists = params

        def d(p, q, D):
            return _hier_distance(p, q, strides, dists)
    elif kind == "torus":
        dims, weights = params

        def d(p, q, D):
            return _torus_distance(p, q, dims, weights)
    elif kind == "matrix":
        def d(p, q, D):
            return D[p.long(), q.long()].to(torch.float32)
    else:
        raise ValueError(f"unknown kernel_params kind {kind!r}")
    return d


# ----------------------------------------------------------------- plain
def qap_objective_plain(kind: str, params: tuple, eu, ev, ew, perm, D):
    """Σ w_e · D(perm[eu_e], perm[ev_e]) as one float32 sum — the
    kernel's plain PyTorch twin (0-d float32 tensor)."""
    import torch
    d = distance_form(kind, params)
    perm_l = perm.long()
    return torch.sum(ew * d(perm_l[eu.long()], perm_l[ev.long()], D))


# ------------------------------------------------------------------ kernel
def form_args(kind: str, params: tuple, D) -> tuple:
    """The C entries' static distance arguments: ``(form, nlev, n_pe,
    ip array, n_ip, fp array, n_fp)``; the arrays are ctypes buffers the
    caller keeps alive across the call."""
    if kind == "tree":
        strides, dists = params
        ip, fp, nlev = list(strides), list(dists), len(dists)
        form = _FORMS[kind]
    elif kind == "torus":
        dims, weights = params
        ip, fp, nlev = list(dims), list(weights), len(dims)
        form = _FORMS[kind]
    elif kind == "matrix":
        dtype = str(D.dtype).replace("torch.", "")
        if dtype not in _MATRIX_FORMS:
            raise ValueError(f"matrix distance table dtype {D.dtype} is not "
                             f"one of {sorted(_MATRIX_FORMS)}")
        if D.dim() != 2 or D.shape[0] != D.shape[1]:
            raise ValueError(f"matrix distance table must be square, got "
                             f"{tuple(D.shape)}")
        ip, fp, nlev, form = [], [], 0, _MATRIX_FORMS[dtype]
    else:
        raise ValueError(f"unknown kernel_params kind {kind!r}")
    if len(ip) > 17 or len(fp) > 16:
        raise ValueError(f"{kind} distance form has {nlev} levels; the "
                         f"CUDA kernels take at most 16")
    ip_arr = (ctypes.c_int * max(len(ip), 1))(*[int(x) for x in ip])
    fp_arr = (ctypes.c_float * max(len(fp), 1))(*[float(x) for x in fp])
    n_pe = int(D.shape[0]) if kind == "matrix" else 0
    return form, nlev, n_pe, ip_arr, len(ip), fp_arr, len(fp)


def check_cuda(name: str, device, **tensors) -> None:
    """Raise unless every tensor lies on ``device``, is contiguous and
    has the dtype its name demands (int32 ids, float32 weights)."""
    import torch
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        want = torch.float32 if key in ("ew", "wgt") else torch.int32
        if key != "D" and t.dtype != want:
            raise ValueError(f"{name}: {key} must be {want}, got {t.dtype}")


def qap_objective_edges(kind: str, params: tuple, eu, ev, ew, perm, D):
    """J = Σ w_e · D(perm[eu_e], perm[ev_e]) as a 0-d float32 tensor on
    the inputs' device: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  eu, ev, perm int32; ew float32; D the
    matrix table (float32/int8/int16) or a dummy for tree/torus."""
    if not eu.is_cuda:
        return qap_objective_plain(kind, params, eu, ev, ew, perm, D)
    import torch
    check_cuda("qap_objective", eu.device, eu=eu, ev=ev, ew=ew, perm=perm,
               D=D)
    e = int(eu.shape[0])
    if ev.shape[0] != e or ew.shape[0] != e:
        raise ValueError("qap_objective: eu, ev, ew differ in length")
    form, nlev, n_pe, ip, n_ip, fp, n_fp = form_args(kind, params, D)
    nb = max(1, min(-(-e // _BLOCK), _MAX_BLOCKS))
    partials = torch.empty(nb, dtype=torch.float32, device=eu.device)
    out = torch.empty((), dtype=torch.float32, device=eu.device)
    with torch.cuda.device(eu.device):
        stream = torch.cuda.current_stream(eu.device).cuda_stream
        OBJECTIVE_KERNEL.launch(
            eu.data_ptr(), ev.data_ptr(), ew.data_ptr(), e,
            perm.data_ptr(), D.data_ptr(), form, nlev, n_pe,
            ctypes.addressof(ip), n_ip, ctypes.addressof(fp), n_fp,
            partials.data_ptr(), nb, out.data_ptr(), stream)
    return out
