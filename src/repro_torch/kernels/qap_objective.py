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
are inert.  Both also take a lane axis: (B, E) edge tensors and a
(B, n) permutation give the B objectives (B,) of a batch, and (E,) edge
tensors with a (B, n) permutation those of B permutations of one graph
(the portfolio's lanes; the edge list is read by every lane, never
copied), in one launch on CUDA, each lane's bits those of a single call
on its arrays (the counterpart of ``jax.vmap`` over the Pallas call,
with ``in_axes=None`` for a shared edge list).  The kernel takes a
call in one launch, and its distance
form as one :class:`FormParams` struct, built once per form and cached
(:func:`form_params`), with a fixed-point reciprocal (:func:`reciprocal`)
for every divisor of the closed forms, so it divides by nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np

from .cuda import CudaKernel

__all__ = ["OBJECTIVE_KERNEL", "FormParams", "distance_form",
           "form_params", "lane_of", "qap_objective_edges",
           "qap_objective_plain", "reciprocal"]

_P, _I = ctypes.c_void_p, ctypes.c_int

MAX_LEVELS = 16                 # csrc/distance.cuh: kMaxLevels
_BLOCK = 256                    # csrc/qap_objective.cu: kBlock
_MAX_BLOCKS = 1024              # csrc/qap_objective.cu: kMaxBlocks
_FORMS = {"tree": 0, "torus": 1}
_MATRIX_FORMS = {"float32": 2, "int8": 3, "int16": 4}


class Recip(ctypes.Structure):
    """``csrc/distance.cuh:Recip``: p // s == (p · mul) >> shift."""
    _fields_ = [("mul", ctypes.c_uint32), ("shift", ctypes.c_uint32)]


class FormParams(ctypes.Structure):
    """``csrc/distance.cuh:FormParams``, field for field: the static
    distance parameters both kernels take by value."""
    _fields_ = [("nlev", ctypes.c_int), ("n_pe", ctypes.c_int),
                ("ip", ctypes.c_int * (MAX_LEVELS + 1)),
                ("rc", Recip * (MAX_LEVELS + 1)),
                ("fp", ctypes.c_float * MAX_LEVELS)]


OBJECTIVE_KERNEL = CudaKernel(
    "qap_objective", "qap_objective", "viem_qap_objective",
    [_P, _P, _P, _I,            # eu, ev, ew, E
     _P, _I, _I, _I,            # perm, n, lanes, shared edge list
     _P, _I,                    # D, form
     _P, _I,                    # FormParams, its size
     _P, _I, _P,                # scratch, nb, out
     _P])                       # stream


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
    kernel's plain PyTorch twin (0-d float32 tensor); with a lane axis
    ((B, n) perm, and (B, E) edges or one (E,) edge list shared by the
    lanes) the (B,) sums of the lanes, each the single call on its
    lane."""
    import torch
    if perm.dim() == 2:
        return torch.stack([qap_objective_plain(
            kind, params, *lane_of(b, eu.dim() == 1, eu, ev, ew), perm[b],
            D) for b in range(perm.shape[0])])
    d = distance_form(kind, params)
    perm_l = perm.long()
    return torch.sum(ew * d(perm_l[eu.long()], perm_l[ev.long()], D))


def lane_of(b: int, shared: bool, *tensors) -> list:
    """Lane ``b``'s per-graph tensors: the tensors themselves when the
    lanes share one graph, else their ``b``-th slices."""
    return list(tensors) if shared else [t[b] for t in tensors]


# ------------------------------------------------------------------ kernel
def reciprocal(s: int) -> tuple:
    """``(mul, shift)`` with ``p // s == (p * mul) >> shift`` for every
    0 <= p < 2**31, ``mul < 2**32``: the kernels' division by a static
    divisor 1 <= s < 2**31 (Granlund and Montgomery, PLDI 1994).

    ``shift`` is the largest (<= 63) that keeps ``mul = ceil(2**shift /
    s)`` below 2**32.  With ``mul·s = 2**shift + e``, 0 <= e < s, the
    product is p/s + p·e/(s·2**shift), and its floor is p // s exactly
    when p·e < (s − p % s)·2**shift; the worst case p % s = s − 1 needs
    p·e < 2**shift, which the largest p, 2**31 − 1, is checked against
    here (it holds for every s: a larger shift would overflow mul, so
    2**shift > (2**32 − 1)·s / 2 > (2**31 − 1)·(s − 1))."""
    s = int(s)
    if not 1 <= s < 2 ** 31:
        raise ValueError(f"divisor {s} outside [1, 2**31)")
    shift = 63
    while -(-(1 << shift) // s) >= 1 << 32:
        shift -= 1
    mul = -(-(1 << shift) // s)
    if (2 ** 31 - 1) * (mul * s - (1 << shift)) >= 1 << shift:
        raise AssertionError(f"reciprocal of {s} is not exact below 2**31")
    return mul, shift


def _divisors(kind: str, params: tuple) -> dict:
    """{FormParams.rc index: divisor}: a tree's strides[l] for
    l = 1 .. nlev-1; a torus' strides dims[0]·…·dims[a-1], a = 1 .. nlev."""
    if kind == "tree":
        return {lvl: int(params[0][lvl]) for lvl in range(1, len(params[1]))}
    stride, out = 1, {}
    for a, d in enumerate(params[0], start=1):
        stride *= int(d)
        out[a] = stride
    return out


@functools.lru_cache(maxsize=64)
def _form_params(kind: str, params: tuple, dtype: str, n_pe: int) -> tuple:
    if kind in _FORMS:
        ip, fp = list(params[0]), list(params[1])
        nlev, form = len(fp) if kind == "tree" else len(ip), _FORMS[kind]
    elif kind == "matrix":
        if dtype not in _MATRIX_FORMS:
            raise ValueError(f"matrix distance table dtype {dtype} is not "
                             f"one of {sorted(_MATRIX_FORMS)}")
        ip, fp, nlev, form = [], [], 0, _MATRIX_FORMS[dtype]
    else:
        raise ValueError(f"unknown kernel_params kind {kind!r}")
    if len(ip) > MAX_LEVELS + 1 or len(fp) > MAX_LEVELS:
        raise ValueError(f"{kind} distance form has {nlev} levels; the "
                         f"CUDA kernels take at most {MAX_LEVELS}")
    f = FormParams(nlev=nlev, n_pe=n_pe if kind == "matrix" else 0)
    f.ip[:] = [int(x) for x in ip] + [1] * (MAX_LEVELS + 1 - len(ip))
    f.fp[:] = [float(x) for x in fp] + [0.0] * (MAX_LEVELS - len(fp))
    rcs = {} if kind == "matrix" else _divisors(kind, params)
    for i in range(MAX_LEVELS + 1):
        f.rc[i].mul, f.rc[i].shift = reciprocal(rcs.get(i, 1))
    return form, f


def form_params(kind: str, params: tuple, D) -> tuple:
    """``(form id, FormParams)`` for the C entries, built once per (kind,
    params, dtype and size of D) and cached: the struct the kernels take
    by value, with a fixed-point reciprocal for every divisor."""
    if kind == "matrix" and (D.dim() != 2 or D.shape[0] != D.shape[1]):
        raise ValueError(f"matrix distance table must be square, got "
                         f"{tuple(D.shape)}")
    return _form_params(kind, params, str(D.dtype).replace("torch.", ""),
                        int(D.shape[0]))


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


def on_device(device):
    """A context in which ``device`` is the current device (the C
    entries launch on the current one); a no-op when it already is."""
    import torch
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


_SCRATCH: dict = {}


def _scratch(device, stream: int, lanes: int = 1):
    """The K1 launch's scratch for one stream: for each of ``lanes``
    lanes ``_MAX_BLOCKS`` partials and its ticket counter, zero-filled
    when made; every launch leaves the counters 0 again.  It grows (a
    fresh zero-filled buffer) when a launch takes more lanes than it
    holds."""
    import torch
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    need = lanes * (_MAX_BLOCKS + 1)
    if buf is None or buf.numel() < need:
        buf = _SCRATCH[key] = torch.zeros(need, dtype=torch.float32,
                                          device=device)
    return buf


def qap_objective_edges(kind: str, params: tuple, eu, ev, ew, perm, D):
    """J = Σ w_e · D(perm[eu_e], perm[ev_e]) as a 0-d float32 tensor on
    the inputs' device: the CUDA kernel (one launch) for CUDA tensors,
    the plain version for CPU tensors.  eu, ev, perm int32; ew float32;
    D the matrix table (float32/int8/int16) or a dummy for tree/torus.
    With a lane axis — perm (B, n), and eu, ev, ew (B, E) or one (E,)
    edge list shared by the lanes — the (B,) objectives of the lanes,
    still one launch."""
    if not eu.is_cuda:
        return qap_objective_plain(kind, params, eu, ev, ew, perm, D)
    import torch
    dev = eu.device
    check_cuda("qap_objective", dev, eu=eu, ev=ev, ew=ew, perm=perm, D=D)
    lanes = perm.shape[:-1]
    shared = eu.dim() == 1 and perm.dim() == 2
    if perm.dim() not in (1, 2) or \
            eu.shape[:-1] != (() if shared else lanes) or \
            ev.shape != eu.shape or ew.shape != eu.shape:
        raise ValueError(f"qap_objective: eu, ev, ew must share one shape "
                         f"(E,) or (B, E) and perm be (n,) or (B, n); got "
                         f"{tuple(eu.shape)}, {tuple(ev.shape)}, "
                         f"{tuple(ew.shape)}, {tuple(perm.shape)}")
    b = int(lanes[0]) if lanes else 1
    e, n = int(eu.shape[-1]), int(perm.shape[-1])
    form, f = form_params(kind, params, D)
    nb = max(1, min(-(-e // _BLOCK), _MAX_BLOCKS))
    out = torch.empty(lanes, dtype=torch.float32, device=dev)
    with on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        OBJECTIVE_KERNEL.launch(
            eu.data_ptr(), ev.data_ptr(), ew.data_ptr(), e,
            perm.data_ptr(), n, b, int(shared), D.data_ptr(), form,
            ctypes.addressof(f),
            ctypes.sizeof(f), _scratch(dev, stream, b).data_ptr(), nb,
            out.data_ptr(), stream)
    return out
