"""Sparse communication graphs in CSR form + Metis/Chaco/DIMACS file format.

The host half is a copy of the JAX package's ``core/graph.py``;
:class:`DeviceGraph` and :func:`device_pairs` hold torch tensors.

This is the substrate of the paper: the communication matrix C is *always*
handled as a graph G_C = ({1..n}, E[C]) with E[C] = {(u,v) | C_uv != 0}
(guide §2.2).  We keep forward and backward edges explicitly (symmetric CSR),
exactly like the Metis format the guide mandates (§3.1).
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np


class GraphFormatError(ValueError):
    """Raised when an input file violates the guide's format rules (§3.3)."""


@dataclass
class CommGraph:
    """Undirected weighted graph in CSR form.

    Attributes:
      xadj:    (n+1,) int64 — CSR row pointers.
      adjncy:  (2m,)  int64 — neighbor ids, both directions stored.
      adjwgt:  (2m,)  float64 — edge weights, mirrored on both directions.
      vwgt:    (n,)   float64 — vertex weights (ignored for one-to-one
               mappings per guide §3.1, but kept for the partitioner).
    """

    xadj: np.ndarray
    adjncy: np.ndarray
    adjwgt: np.ndarray
    vwgt: np.ndarray

    # ------------------------------------------------------------------ basic
    @property
    def n(self) -> int:
        return len(self.xadj) - 1

    @property
    def num_edges(self) -> int:
        """Number of undirected edges m (each stored twice in CSR)."""
        return len(self.adjncy) // 2

    def degree(self, u: int) -> int:
        return int(self.xadj[u + 1] - self.xadj[u])

    def neighbors(self, u: int) -> np.ndarray:
        return self.adjncy[self.xadj[u]:self.xadj[u + 1]]

    def weights(self, u: int) -> np.ndarray:
        return self.adjwgt[self.xadj[u]:self.xadj[u + 1]]

    def edge_list(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(u, v, w) arrays with u < v — each undirected edge once."""
        src = np.repeat(np.arange(self.n, dtype=np.int64),
                        np.diff(self.xadj))
        mask = src < self.adjncy
        return src[mask], self.adjncy[mask], self.adjwgt[mask]

    def total_edge_weight(self) -> float:
        return float(self.adjwgt.sum()) / 2.0

    def to_dense(self) -> np.ndarray:
        """Dense symmetric communication matrix C (test/small-n use only)."""
        C = np.zeros((self.n, self.n))
        src = np.repeat(np.arange(self.n), np.diff(self.xadj))
        C[src, self.adjncy] = self.adjwgt
        return C

    def subgraph(self, nodes: np.ndarray) -> tuple["CommGraph", np.ndarray]:
        """Induced subgraph; returns (graph, mapping local->global)."""
        nodes = np.asarray(nodes, dtype=np.int64)
        glob2loc = -np.ones(self.n, dtype=np.int64)
        glob2loc[nodes] = np.arange(len(nodes))
        xadj = [0]
        adjncy: list[np.ndarray] = []
        adjwgt: list[np.ndarray] = []
        for u in nodes:
            nb = self.neighbors(u)
            wt = self.weights(u)
            loc = glob2loc[nb]
            keep = loc >= 0
            adjncy.append(loc[keep])
            adjwgt.append(wt[keep])
            xadj.append(xadj[-1] + int(keep.sum()))
        return (
            CommGraph(
                xadj=np.asarray(xadj, dtype=np.int64),
                adjncy=(np.concatenate(adjncy) if adjncy else
                        np.zeros(0, np.int64)).astype(np.int64),
                adjwgt=(np.concatenate(adjwgt) if adjwgt else
                        np.zeros(0)).astype(np.float64),
                vwgt=self.vwgt[nodes].copy(),
            ),
            nodes,
        )


def contract(g: CommGraph, labels: np.ndarray, k: int) -> CommGraph:
    """Collapse ``g`` along a cluster labeling: vertices = clusters
    ``0..k-1``, edge weight = summed inter-cluster communication,
    intra-cluster edges dropped (no self-loops — the Metis invariant),
    vertex weights summed per cluster.

    The one edge-collapsing primitive behind the ``generate_model``
    quotient (:func:`repro.core.construction.quotient`), the
    partitioner's host coarsening, and the multilevel mapping V-cycle's
    host-side graph assembly.
    """
    labels = np.asarray(labels, dtype=np.int64)
    u, v, w = g.edge_list()
    cu, cv = labels[u], labels[v]
    keep = cu != cv
    cu, cv, w = cu[keep], cv[keep], w[keep]
    lo, hi = np.minimum(cu, cv), np.maximum(cu, cv)
    vw = np.bincount(labels, weights=g.vwgt, minlength=k)
    if len(lo) == 0:
        return CommGraph(np.zeros(k + 1, np.int64), np.zeros(0, np.int64),
                         np.zeros(0), vw)
    return from_edges(k, lo, hi, w, vwgt=vw)


def csr_expand(xadj: np.ndarray, rows: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Loop-free flat expansion of CSR rows: for each r in ``rows`` (in
    order, repeats allowed) the positions [xadj[r], xadj[r+1])
    concatenated.  Returns ``(pos, off, cnt)`` — flat CSR positions,
    within-row offsets, and per-row counts — the shared repeat/offset
    idiom behind batched gains, frontier BFS, and the ELL conversion.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cnt = xadj[rows + 1] - xadj[rows]
    total = int(cnt.sum())
    if not total:
        z = np.zeros(0, np.int64)
        return z, z.copy(), cnt
    ends = np.cumsum(cnt)
    off = np.arange(total, dtype=np.int64) - np.repeat(ends - cnt, cnt)
    return np.repeat(xadj[rows], cnt) + off, off, cnt


# ------------------------------------------------------------- device arrays
@dataclass
class DeviceGraph:
    """Device-resident view of a :class:`CommGraph` for the refinement
    engine: fixed-width (ELL) neighbor rows plus a padded edge list, all
    torch tensors on one device, so gains, objectives, and sweeps run
    without ragged indexing or host round-trips.

    Attributes:
      nbr:  (n, K) int32 — neighbor ids; rows right-padded with the row's
            own vertex id (safe for any D gather; the weight masks it out).
      wgt:  (n, K) float32 — edge weights, 0.0 on padding.
      eu/ev/ew: (E,) int32/int32/float32 — each undirected edge once
            (u < v), padded with (0, 0, 0.0) entries (inert: w = 0).
      n, num_edges: true (unpadded) sizes.

    Padding invariants (relied on by the engine and tested):
      * a padded neighbor slot contributes 0 to every pair gain (w = 0),
      * a padded edge contributes 0 to the objective (w = 0),
      * both are invariant under *further* padding, so batching graphs to
        common (K, E) maxima leaves per-graph results unchanged.
    """

    nbr: object
    wgt: object
    eu: object
    ev: object
    ew: object
    n: int
    num_edges: int

    @property
    def max_deg(self) -> int:
        return self.nbr.shape[1]

    @property
    def device(self):
        return self.nbr.device

    @classmethod
    def from_comm(cls, g: "CommGraph", device="cuda", pad_deg_to: int = 8,
                  pad_edges_to: int = 128) -> "DeviceGraph":
        """Build the padded device arrays from a CSR graph on ``device``.
        ``pad_deg_to`` / ``pad_edges_to`` round K and E up so same-bucket
        graphs share shapes."""
        import torch

        from ..kernels.pad import pad_edge_arrays
        n = g.n
        pos, cols, deg = csr_expand(g.xadj, np.arange(n))
        k = int(deg.max(initial=0))
        k = max(pad_deg_to, -(-max(k, 1) // pad_deg_to) * pad_deg_to)
        nbr = np.repeat(np.arange(n, dtype=np.int32)[:, None], k, axis=1)
        wgt = np.zeros((n, k), dtype=np.float32)
        rows = np.repeat(np.arange(n), deg)
        nbr[rows, cols] = g.adjncy[pos]
        wgt[rows, cols] = g.adjwgt[pos]
        u, v, w = g.edge_list()
        eu, ev, ew = pad_edge_arrays(u, v, w, base=pad_edges_to,
                                     device=device)
        return cls(
            nbr=torch.from_numpy(nbr).to(device),
            wgt=torch.from_numpy(wgt).to(device),
            eu=eu, ev=ev, ew=ew,
            n=n, num_edges=len(u))

    def pad_to(self, max_deg: int, num_edges: int) -> "DeviceGraph":
        """Re-pad to a batch's common (K, E) — results are unchanged by
        the extra inert padding (see class docstring)."""
        import torch

        from ..kernels.pad import pad1, pad2
        if max_deg < self.max_deg or num_edges < self.eu.shape[0]:
            raise ValueError("pad_to cannot shrink device arrays")
        dk = max_deg - self.max_deg
        row_ids = torch.arange(self.n, dtype=torch.int32,
                               device=self.device)[:, None].expand(
                                   self.n, dk)
        return DeviceGraph(
            nbr=torch.cat([self.nbr, row_ids], dim=1),
            wgt=pad2(self.wgt, self.n, max_deg),
            eu=pad1(self.eu, num_edges), ev=pad1(self.ev, num_edges),
            ew=pad1(self.ew, num_edges),
            n=self.n, num_edges=self.num_edges)


def device_pairs(pairs: np.ndarray, pad_to: int = 128,
                 device="cuda") -> tuple:
    """Candidate pairs as device tensors: (us, vs) int32, right-padded
    with (0, 0) entries to a ``pad_to`` multiple.  A u == v pair has
    exactly zero gain and is never selected by the engine, so the padding
    is inert (and invariant under further padding — batching-safe)."""
    import torch
    pairs = np.asarray(pairs, dtype=np.int64)
    p = max(pad_to, -(-max(len(pairs), 1) // pad_to) * pad_to)
    pad = p - len(pairs)
    us = np.pad(pairs[:, 0] if len(pairs) else np.zeros(0, np.int64),
                (0, pad)).astype(np.int32)
    vs = np.pad(pairs[:, 1] if len(pairs) else np.zeros(0, np.int64),
                (0, pad)).astype(np.int32)
    return torch.from_numpy(us).to(device), torch.from_numpy(vs).to(device)


# --------------------------------------------------------------------- build
def from_edges(n: int, u: np.ndarray, v: np.ndarray, w: np.ndarray,
               vwgt: np.ndarray | None = None) -> CommGraph:
    """Build a symmetric CSR graph from one-directional edge lists.

    Parallel edges are merged by summing weights; self loops are rejected
    (the guide's format forbids both, §3.3 — `from_edges` is the programmatic
    entry so we merge rather than crash, but loops are a caller bug).
    """
    u = np.asarray(u, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    w = np.asarray(w, dtype=np.float64)
    if np.any(u == v):
        raise GraphFormatError("self-loops are not allowed")
    # mirror
    src = np.concatenate([u, v])
    dst = np.concatenate([v, u])
    wt = np.concatenate([w, w])
    # merge parallel edges: sort by (src, dst) and sum runs
    key = src * n + dst
    order = np.argsort(key, kind="stable")
    key, src, dst, wt = key[order], src[order], dst[order], wt[order]
    uniq, start = np.unique(key, return_index=True)
    wsum = np.add.reduceat(wt, start) if len(wt) else wt
    src = src[start]
    dst = dst[start]
    xadj = np.zeros(n + 1, dtype=np.int64)
    np.add.at(xadj, src + 1, 1)
    xadj = np.cumsum(xadj)
    return CommGraph(
        xadj=xadj,
        adjncy=dst.astype(np.int64),
        adjwgt=wsum.astype(np.float64),
        vwgt=(np.ones(n) if vwgt is None else
              np.asarray(vwgt, dtype=np.float64)),
    )


def from_dense(C: np.ndarray) -> CommGraph:
    """Graph view of a dense symmetric communication matrix."""
    C = np.asarray(C, dtype=np.float64)
    if C.shape[0] != C.shape[1]:
        raise GraphFormatError("C must be square")
    if not np.allclose(C, C.T):
        raise GraphFormatError("C must be symmetric (guide §1)")
    iu, iv = np.nonzero(np.triu(C, k=1))
    return from_edges(C.shape[0], iu, iv, C[iu, iv])


# ----------------------------------------------------------------- Metis IO
def read_metis(path_or_file) -> CommGraph:
    """Read the Metis/Chaco/DIMACS format described in guide §3.1.

    First line: ``n m [f]`` with f in {<absent>, 1, 10, 11}.  Comment lines
    start with %.  Vertices are 1-indexed in the file, 0-indexed in memory.
    Violations raise GraphFormatError with the same checks the guide's
    `graphchecker` performs (§3.3, §4.3).
    """
    if hasattr(path_or_file, "read"):
        lines = path_or_file.read().splitlines()
    else:
        with open(path_or_file, "r") as fh:
            lines = fh.read().splitlines()
    # blank lines are significant — an isolated vertex has an empty
    # adjacency line — so only comments and leading blanks are dropped
    body = [ln for ln in lines if not ln.lstrip().startswith("%")]
    while body and not body[0].strip():
        body.pop(0)
    if not body:
        raise GraphFormatError("empty graph file")
    header = body[0].split()
    if len(header) not in (2, 3):
        raise GraphFormatError(f"header must be 'n m [f]', got {body[0]!r}")
    n, m = int(header[0]), int(header[1])
    fmt = header[2] if len(header) == 3 else "0"
    if fmt not in ("0", "1", "10", "11", "00", "01"):
        raise GraphFormatError(f"unknown format flag {fmt!r}")
    has_ew = fmt.endswith("1")
    has_vw = len(fmt) == 2 and fmt[0] == "1"
    # tolerate editor-added blank lines after the last vertex line
    while len(body) - 1 > n and not body[-1].strip():
        body.pop()
    if len(body) - 1 != n:
        raise GraphFormatError(
            f"file declares n={n} vertices but has {len(body)-1} vertex lines")
    xadj = [0]
    adjncy: list[int] = []
    adjwgt: list[float] = []
    vwgt = np.ones(n)
    for i, ln in enumerate(body[1:]):
        tok = ln.split()
        pos = 0
        if has_vw:
            if not tok:
                raise GraphFormatError(f"vertex {i+1}: missing vertex weight")
            cw = float(tok[0])
            if cw < 0:
                raise GraphFormatError(f"vertex {i+1}: vertex weight < 0")
            vwgt[i] = cw
            pos = 1
        step = 2 if has_ew else 1
        rest = tok[pos:]
        if len(rest) % step:
            raise GraphFormatError(
                f"vertex {i+1}: dangling token (edge weight missing?)")
        for j in range(0, len(rest), step):
            v = int(rest[j]) - 1
            if v == i:
                raise GraphFormatError(f"vertex {i+1}: self-loop")
            if not (0 <= v < n):
                raise GraphFormatError(f"vertex {i+1}: neighbor {v+1} out of range")
            w = float(rest[j + 1]) if has_ew else 1.0
            if w <= 0:
                raise GraphFormatError(f"vertex {i+1}: edge weight <= 0")
            adjncy.append(v)
            adjwgt.append(w)
        xadj.append(len(adjncy))
    g = CommGraph(np.asarray(xadj, np.int64), np.asarray(adjncy, np.int64),
                  np.asarray(adjwgt, np.float64), vwgt)
    validate(g, declared_m=m)
    return g


def validate(g: CommGraph, declared_m: int | None = None) -> None:
    """The `graphchecker` checks (guide §3.3): edge count, symmetry,
    matching forward/backward weights, no parallel edges."""
    if declared_m is not None and len(g.adjncy) != 2 * declared_m:
        raise GraphFormatError(
            f"header says m={declared_m} but file stores "
            f"{len(g.adjncy)} directed edges (expected {2*declared_m})")
    for u in range(g.n):
        nb = g.neighbors(u)
        if len(np.unique(nb)) != len(nb):
            raise GraphFormatError(f"vertex {u+1}: parallel edges")
    # symmetry + weight match via sorted key comparison
    src = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.xadj))
    fwd = np.lexsort((g.adjncy, src))
    bwd = np.lexsort((src, g.adjncy))
    if not (np.array_equal(src[fwd], g.adjncy[bwd])
            and np.array_equal(g.adjncy[fwd], src[bwd])):
        raise GraphFormatError("missing backward edge")
    if not np.allclose(g.adjwgt[fwd], g.adjwgt[bwd]):
        raise GraphFormatError("forward/backward edge weights differ")


def write_metis(g: CommGraph, path_or_file, edge_weights: bool = True) -> None:
    out = io.StringIO()
    fmt = " 1" if edge_weights else ""
    out.write(f"{g.n} {g.num_edges}{fmt}\n")
    for u in range(g.n):
        toks: list[str] = []
        for v, w in zip(g.neighbors(u), g.weights(u)):
            toks.append(str(int(v) + 1))
            if edge_weights:
                toks.append(f"{int(w) if float(w).is_integer() else w}")
        out.write(" ".join(toks) + "\n")
    if hasattr(path_or_file, "write"):
        path_or_file.write(out.getvalue())
    else:
        with open(path_or_file, "w") as fh:
            fh.write(out.getvalue())


# ------------------------------------------------------------- generators
def grid3d(nx: int, ny: int, nz: int, torus: bool = False,
           weight: float = 1.0) -> CommGraph:
    """3D stencil communication graph — the canonical sparse HPC pattern."""
    def vid(x, y, z):
        return (x * ny + y) * nz + z
    us, vs = [], []
    for x in range(nx):
        for y in range(ny):
            for z in range(nz):
                for dx, dy, dz in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
                    X, Y, Z = x + dx, y + dy, z + dz
                    if torus:
                        if (dx and nx > 2 or dy and ny > 2 or dz and nz > 2):
                            X, Y, Z = X % nx, Y % ny, Z % nz
                        elif X >= nx or Y >= ny or Z >= nz:
                            continue
                    elif X >= nx or Y >= ny or Z >= nz:
                        continue
                    a, b = vid(x, y, z), vid(X, Y, Z)
                    if a != b:
                        us.append(a)
                        vs.append(b)
    us, vs = np.asarray(us), np.asarray(vs)
    return from_edges(nx * ny * nz, us, vs, np.full(len(us), weight))


def random_geometric(n: int, radius: float, seed: int = 0) -> CommGraph:
    """Random geometric graph in the unit square (sparse, community-like)."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    iu, iv = np.nonzero(np.triu(d2 < radius * radius, k=1))
    w = rng.integers(1, 10, size=len(iu)).astype(np.float64)
    if len(iu) == 0:  # guarantee connectivity fallback: a path
        iu = np.arange(n - 1)
        iv = iu + 1
        w = np.ones(n - 1)
    return from_edges(n, iu, iv, w)
