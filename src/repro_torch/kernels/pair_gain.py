"""K2 — sparse per-pair swap gains over padded (ELL) neighbor rows, its
plain twin, and the engine's device objective.

The paper's central speedup is the O(deg(u) + deg(v)) incremental gain
(guide §2.1).  These functions batch that sparse gain over P candidate
pairs at once, on device, against the topology's distance form
(``Topology.kernel_params()``):

    gain(u, v) = Σ_{k∈N(u)\\{v}} w_uk · (D(π_u, π_k) − D(π_v, π_k))
               + Σ_{k∈N(v)\\{u}} w_vk · (D(π_v, π_k) − D(π_u, π_k))

Neighbor rows come from :class:`repro_torch.core.graph.DeviceGraph` —
fixed-width (n, K) tensors padded with zero-weight entries.  The
`v ∈ N(u)` exclusion and the row padding are both folded into the
weights (w = 0 kills the term), so the reduction is branch-free.
Positive gain = the objective decreases by that amount when swapped;
padding pairs (u, u) give exactly 0.

  * :func:`pair_gains` — the wrapper: the hand-written kernel
    ``csrc/pair_gain.cu`` for CUDA tensors (it replaces the JAX
    package's ``pair_gains_pallas``), :func:`pair_gains_plain` for CPU
    tensors.
  * :func:`pair_gains_plain` — the plain PyTorch version, the JAX
    package's fused ``pair_gains``; with a :class:`KernelConfig` whose
    pair tile is smaller than P it runs tile by tile, so temporaries
    scale with the tile.  Each pair's K-slot reduction is the same
    either way.
  * :func:`edge_objective` — Σ w_e · D(π_u, π_v), the engine's
    in-loop objective: the K1 kernel on CUDA tensors, the plain
    (optionally chunked) sum on CPU tensors.

Each takes a lane axis in two layouts, with D shared: a leading B on
every per-graph tensor (a batch of graphs), or a leading B on the
permutation alone, the graph and pair tensors shared by every lane (the
portfolio's restart lanes of one graph; they are read by every lane,
never copied).  B instances in one launch on CUDA, lane by lane in the
plain versions, each lane equal to the single call on its arrays.  It is
the sweep's counterpart of ``jax.vmap`` over the Pallas call, with
``in_axes=None`` for the shared tensors.
"""

from __future__ import annotations

import ctypes

from .config import KernelConfig
from .cuda import CudaKernel
from .qap_objective import (check_cuda, distance_form, form_params,
                            lane_of, on_device, qap_objective_edges)

__all__ = ["PAIR_GAIN_KERNEL", "distance_form", "edge_objective",
           "pair_gains", "pair_gains_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int

PAIR_GAIN_KERNEL = CudaKernel(
    "pair_gains", "pair_gain", "viem_pair_gains",
    [_P, _P, _I, _I,            # nbr, wgt, K, n
     _P, _P, _P, _I, _I, _I,    # perm, us, vs, P, lanes, shared graph
     _P, _I,                    # D, form
     _P, _I,                    # FormParams, its size
     _P,                        # out
     _P])                       # stream


def edge_objective(kind: str, params: tuple, eu, ev, ew, perm, D,
                   config: KernelConfig | None = None):
    """Σ w_e · D(perm[u_e], perm[v_e]) — the device-side objective (0-d
    float32).  Edge padding (w = 0) is inert.

    CUDA tensors go to the K1 kernel.  On the CPU, without a config (or
    when one edge tile covers the list) this is the flat sum; with a
    smaller tile it sums (block_rows · lanes)-element chunks in order,
    accumulating in ``config.acc_dtype``, as the JAX package does.  With
    a lane axis ((B, n) perm; (B, E) edges, or (E,) edges shared by the
    lanes) the (B,) objectives."""
    if eu.is_cuda:
        return qap_objective_edges(kind, params, eu, ev, ew, perm, D)
    import torch
    if perm.dim() == 2:
        return torch.stack([edge_objective(
            kind, params, *lane_of(b, eu.dim() == 1, eu, ev, ew), perm[b],
            D, config=config) for b in range(perm.shape[0])])
    d = distance_form(kind, params)
    e = eu.shape[0]
    chunk = config.block_rows * config.lanes if config is not None else None
    perm_l = perm.long()
    if chunk is None or chunk >= e:
        return torch.sum(ew * d(perm_l[eu.long()], perm_l[ev.long()], D))
    acc_dtype = getattr(torch, config.acc_dtype)
    acc = torch.zeros((), dtype=acc_dtype)
    for lo in range(0, e, chunk):
        u, v, w = eu[lo:lo + chunk], ev[lo:lo + chunk], ew[lo:lo + chunk]
        acc = acc + torch.sum(w * d(perm_l[u.long()], perm_l[v.long()], D),
                              dtype=acc_dtype)
    return acc.to(torch.float32)


def _side_weights(nbr_rows, wgt_rows, other):
    """Fold the `k != other` exclusion into the weights (padding already
    carries w = 0)."""
    import torch
    return torch.where(nbr_rows == other[:, None], 0.0, wgt_rows)


# ------------------------------------------------------------------ plain
def pair_gains_plain(kind: str, params: tuple, nbr, wgt, perm, us, vs, D,
                     config: KernelConfig | None = None):
    """Exact swap gains for P candidate pairs in plain PyTorch (float32):
    per side, Σ over the K slots of w · (d(π_a, t) − d(π_b, t)), then
    the two sides added.  With a lane axis (perm (B, n); nbr/wgt
    (B, n, K) and us/vs (B, P), or nbr/wgt (n, K) and us/vs (P,) shared
    by the lanes) the (B, P) gains, lane by lane."""
    import torch
    if perm.dim() == 2:
        shared = us.dim() == 1
        return torch.stack([pair_gains_plain(
            kind, params, *lane_of(b, shared, nbr, wgt), perm[b],
            *lane_of(b, shared, us, vs), D, config=config)
            for b in range(perm.shape[0])])
    d = distance_form(kind, params)
    perm_l = perm.long()

    def gains_of(a, b):
        na, nb_ = nbr[a], nbr[b]
        ta = perm_l[na.long()]                      # (p, K) PE targets
        wa = _side_weights(na, wgt[a], b)
        pa = perm_l[a][:, None].expand_as(ta)
        pb = perm_l[b][:, None].expand_as(ta)
        sa = torch.sum(wa * (d(pa, ta, D) - d(pb, ta, D)), dim=1)
        tb = perm_l[nb_.long()]
        wb = _side_weights(nb_, wgt[b], a)
        qa = perm_l[a][:, None].expand_as(tb)
        qb = perm_l[b][:, None].expand_as(tb)
        return sa + torch.sum(wb * (d(qb, tb, D) - d(qa, tb, D)), dim=1)

    p = us.shape[0]
    tile = config.pair_tile(nbr.shape[1]) if config is not None else None
    us_l, vs_l = us.long(), vs.long()
    if tile is None or tile >= p:
        return gains_of(us_l, vs_l)
    out = torch.empty(p, dtype=torch.float32, device=us.device)
    for lo in range(0, p, tile):
        out[lo:lo + tile] = gains_of(us_l[lo:lo + tile], vs_l[lo:lo + tile])
    return out


# ------------------------------------------------------------------ kernel
def pair_gains(kind: str, params: tuple, nbr, wgt, perm, us, vs, D,
               config: KernelConfig | None = None):
    """Swap gains (P,) float32 of the candidate pairs (us[i], vs[i]):
    the K2 kernel for CUDA tensors, :func:`pair_gains_plain` for CPU
    tensors.  ``nbr``/``wgt`` (n, K) int32/float32, ``perm`` (n,) int32,
    ``us``/``vs`` (P,) int32, ``D`` the matrix table or a dummy.  With a
    lane axis — perm (B, n), and nbr/wgt (B, n, K) with us/vs (B, P), or
    nbr/wgt (n, K) with us/vs (P,) shared by the lanes — the (B, P) gains
    of B instances under one D, in one launch."""
    if not us.is_cuda:
        return pair_gains_plain(kind, params, nbr, wgt, perm, us, vs, D,
                                config=config)
    import torch
    check_cuda("pair_gains", us.device, nbr=nbr, wgt=wgt, perm=perm, us=us,
               vs=vs, D=D)
    lanes = perm.shape[:-1]
    shared = us.dim() == 1 and perm.dim() == 2
    graph_lanes = () if shared else lanes
    n, k = nbr.shape[-2:]
    p = int(us.shape[-1])
    if perm.dim() not in (1, 2) or wgt.shape != nbr.shape or \
            nbr.shape[:-2] != graph_lanes or vs.shape != us.shape or \
            us.shape[:-1] != graph_lanes or perm.shape[-1] != n:
        raise ValueError("pair_gains: inconsistent shapes nbr "
                         f"{tuple(nbr.shape)}, wgt {tuple(wgt.shape)}, "
                         f"perm {tuple(perm.shape)}, us {tuple(us.shape)}, "
                         f"vs {tuple(vs.shape)}")
    if k % 4 or nbr.data_ptr() % 16 or wgt.data_ptr() % 16:
        nbr, wgt = _rows_by_fours(nbr, wgt)
    form, f = form_params(kind, params, D)
    out = torch.empty((*lanes, p), dtype=torch.float32, device=us.device)
    with on_device(us.device):
        stream = torch.cuda.current_stream(us.device).cuda_stream
        PAIR_GAIN_KERNEL.launch(
            nbr.data_ptr(), wgt.data_ptr(), int(nbr.shape[-1]), int(n),
            perm.data_ptr(), us.data_ptr(), vs.data_ptr(), p,
            int(lanes[0]) if lanes else 1, int(shared), D.data_ptr(), form,
            ctypes.addressof(f), ctypes.sizeof(f), out.data_ptr(), stream)
    return out


def _rows_by_fours(nbr, wgt):
    """Fresh (hence 16-byte aligned) copies of the rows, K padded up to a
    multiple of 4 as ``DeviceGraph.pad_to`` pads: the row's own vertex
    id with weight 0, an inert slot.  The kernel reads rows four slots
    at a time.  A leading lane axis is kept."""
    import torch
    n, k = nbr.shape[-2:]
    pad = -k % 4
    ids = torch.arange(n, dtype=nbr.dtype, device=nbr.device)[:, None]
    return (torch.cat([nbr, ids.expand(*nbr.shape[:-1], pad)], dim=-1),
            torch.cat([wgt, wgt.new_zeros((*wgt.shape[:-1], pad))], dim=-1))
