"""`matrix` — explicit distance matrix: true general sparse QAP.

The guide's framing is mapping *against an arbitrary distance matrix*;
this backend is that arbitrary matrix, loadable from disk:

  * Metis/Chaco graph format (guide §3.1): an edge-weighted graph over the
    n PEs whose edge weight is the distance between its endpoints; PE
    pairs without an edge have distance 0 — a *sparse* D, exactly the
    sparse-QAP benchmark encoding,
  * ``.npy`` — a dense float n×n numpy array,
  * plain text — n whitespace-separated rows of n floats (optionally a
    leading line with n).

D must be square, symmetric, non-negative, zero-diagonal (validated on
build).  ``split`` uses farthest-pair seeded balanced halving — a generic
recursive decomposition so the top-down construction works for machines
with no closed-form structure.
"""

from __future__ import annotations

import numpy as np

from .base import Topology, balanced_halves, register_topology


def load_distance_matrix(path) -> np.ndarray:
    """Load D from ``.npy``, Metis graph (edge weight = distance), or a
    plain dense text file."""
    path = str(path)
    if path.endswith(".npy"):
        return np.asarray(np.load(path), dtype=np.float64)
    with open(path) as fh:
        text = fh.read()
    body = [ln for ln in text.splitlines()
            if ln.strip() and not ln.lstrip().startswith("%")]
    if not body:
        raise ValueError(f"{path}: empty distance file")
    header = body[0].split()

    def _is_int(tok: str) -> bool:
        return tok.lstrip("+").isdigit()

    # Metis header `n m [f]`: an all-integer first line with a positive
    # vertex count.  A dense text distance matrix can never match: its
    # first row starts with the zero diagonal entry ("0" or "0.0"), and a
    # leading-count-line variant has a single token.
    if (len(header) in (2, 3) and all(_is_int(t) for t in header)
            and int(header[0]) > 0):
        import io

        from ..core.graph import read_metis
        g = read_metis(io.StringIO(text))
        return g.to_dense().astype(np.float64)
    # dense text: optional leading `n` line, then n rows of n floats
    rows = [np.fromstring(ln, sep=" ") for ln in body]
    if len(rows[0]) == 1 and len(rows) == int(rows[0][0]) + 1:
        rows = rows[1:]
    D = np.vstack(rows)
    if D.shape[0] != D.shape[1]:
        raise ValueError(f"{path}: distance matrix must be square, "
                         f"got {D.shape}")
    return D.astype(np.float64)


@register_topology("matrix")
class MatrixTopology(Topology):
    """Explicit distance matrix.  Build from an in-memory ``matrix`` or a
    ``file`` path (see :func:`load_distance_matrix`)."""

    def __init__(self, matrix=None, file=None):
        if (matrix is None) == (file is None):
            raise ValueError("matrix topology needs exactly one of "
                             "matrix=, file=")
        if file is not None:
            matrix = load_distance_matrix(file)
        D = np.ascontiguousarray(np.asarray(matrix, dtype=np.float64))
        if D.ndim != 2 or D.shape[0] != D.shape[1]:
            raise ValueError(f"distance matrix must be square, "
                             f"got shape {D.shape}")
        if np.any(np.diag(D) != 0.0):
            raise ValueError("distance matrix must have a zero diagonal")
        if not np.array_equal(D, D.T):
            raise ValueError("distance matrix must be symmetric")
        if np.any(D < 0):
            raise ValueError("distances must be non-negative")
        D.setflags(write=False)
        self.D = D
        self._matrix = D                 # base-class cache, pre-filled
        self.file = str(file) if file is not None else None

    # ------------------------------------------------------------ contract
    @property
    def n_pe(self) -> int:
        return self.D.shape[0]

    def distance(self, p, q):
        p = np.asarray(p, dtype=np.int64)
        q = np.asarray(q, dtype=np.int64)
        out = self.D[p, q]
        return out if np.ndim(out) else float(out)

    def distance_matrix(self) -> np.ndarray:
        return self.D

    def split(self, pe_ids: np.ndarray) -> "list[np.ndarray] | None":
        pe_ids = np.asarray(pe_ids, dtype=np.int64)
        if len(pe_ids) <= 2:
            return None
        return balanced_halves(self.D, pe_ids)

    def spec_params(self) -> dict:
        if self.file is not None:
            return {"file": self.file}
        return {"matrix": self.D.tolist()}
