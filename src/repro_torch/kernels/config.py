"""`KernelConfig` — the accelerator-geometry knobs of the kernel layer.

The port's copy of the JAX package's ``kernels/config.py``.  A
:class:`KernelConfig` is an explicit, serializable artifact selected at
``Mapper.lower`` time from the plan's
:class:`~repro_torch.core.spec.ShapeBucket` and the device type,
cached inside the :class:`~repro_torch.core.plan.MappingPlan`, and
reported via ``plan.describe()["kernels"]``:

  block_rows — rows per reduction tile.  Tiles are *byte-homogeneous*:
      a pair-gain tile is (block_rows · lanes / K) candidate rows of K
      neighbor slots and an edge tile is (block_rows, lanes) lanes.  The
      plain torch versions loop over tiles of that byte budget instead
      of materializing the full padded row; the CUDA kernels stream the
      whole arrays and read only ``dist_dtype``.
  lanes      — lane width of the edge-reduction rows (the last-dim
      multiple; clamped down for tiny edge lists by the pad helpers).
  acc_dtype  — accumulation dtype of the tiled reductions ("float32";
      "float64" is accepted for host-side experiments).
  dist_dtype — packed distance-table dtype for matrix-form topologies:
      None (float32 gathers) or "int8"/"int16" — lossless packings
      selected by :func:`quantize_table` when the table is exact small
      integers, cutting the gather path's bytes-moved 4×/2× with
      bit-identical gains (the integer differences are exact in f32).

Derivation is device-aware: on the CPU the budget is the JAX
package's CPU budget, so a port plan derives the same geometry (and
``describe()`` tag) as the reference plan; on ``cuda`` the budget only
sizes the plain versions' temporaries.  Explicit overrides
(``MappingSpec.kernel``) win over derivation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

# per-operand tile byte budgets, keyed by torch device type.  "cuda"
# bounds the plain versions' (P, K) temporaries on the card (the CUDA
# kernels do not tile); every other device uses the JAX package's CPU
# budget, which covers benchmarked sizes in one tile
_TILE_BYTES = {"cuda": 1 << 22}
_TILE_BYTES_DEFAULT = 1 << 21

_QUANT_MODES = ("auto", "off", "int8", "int16")
_INT_RANGE = {"int8": 127, "int16": 32767}


def _pow2_at_most(x: int) -> int:
    return 1 << max(int(x), 1).bit_length() - 1


def _pow2_at_least(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


@dataclass(frozen=True)
class KernelConfig:
    """Concrete kernel geometry for ONE compiled pipeline level (see
    module docstring).  Hashable — engine pools and plan caches key on
    ``key()``."""

    block_rows: int = 8
    lanes: int = 1024
    acc_dtype: str = "float32"
    dist_dtype: str | None = None

    def validate(self) -> "KernelConfig":
        if self.block_rows < 1:
            raise ValueError("KernelConfig.block_rows must be >= 1")
        if self.lanes < 128 or self.lanes % 128:
            raise ValueError("KernelConfig.lanes must be a positive "
                             "multiple of 128")
        if self.acc_dtype not in ("float32", "float64"):
            raise ValueError(f"unknown acc_dtype {self.acc_dtype!r}; "
                             f"choose 'float32' or 'float64'")
        if self.dist_dtype not in (None, "int8", "int16"):
            raise ValueError(f"unknown dist_dtype {self.dist_dtype!r}; "
                             f"choose None, 'int8', or 'int16'")
        return self

    # ------------------------------------------------------------- identity
    def key(self) -> tuple:
        return (self.block_rows, self.lanes, self.acc_dtype,
                self.dist_dtype)

    def tag(self) -> str:
        q = self.dist_dtype or "f32"
        return f"b{self.block_rows}:l{self.lanes}:{self.acc_dtype}:{q}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KernelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown KernelConfig keys {unknown}; "
                             f"known keys: {sorted(known)}")
        return cls(**d).validate()

    def replace(self, **changes) -> "KernelConfig":
        return dataclasses.replace(self, **changes).validate()

    # ------------------------------------------------------------- geometry
    def pair_tile(self, k_pad: int) -> int:
        """Rows per pair-gain tile: the byte-homogeneous row count
        (block_rows · lanes / K, at least block_rows) so a (rows, K)
        pair tile costs the same bytes as a (block_rows, lanes) edge
        tile."""
        return self.block_rows * max(1, self.lanes // max(k_pad, 1))


def quantize_table(D, mode: str = "auto"):
    """Lossless packed form of a distance table, or ``None``.

    Returns ``(packed int array, dtype name)`` when every entry of ``D``
    is an exact integer inside the target width's range — the
    Schulz–Träff integer-distance structure every registered topology
    satisfies at benchmarked sizes — else ``None`` (``mode="auto"``) or
    a ``ValueError`` naming the loss (explicit ``"int8"``/``"int16"``:
    a forced packing must never silently change results).
    """
    if mode not in _QUANT_MODES:
        raise ValueError(f"unknown quantize mode {mode!r}; choose from "
                         f"{list(_QUANT_MODES)}")
    if mode == "off":
        return None
    D = np.asarray(D)
    integral = bool(np.all(D == np.rint(D)))
    lo, hi = (float(D.min()), float(D.max())) if D.size else (0.0, 0.0)
    if mode == "auto":
        if not integral:
            return None
        for dt in ("int8", "int16"):
            if -_INT_RANGE[dt] - 1 <= lo and hi <= _INT_RANGE[dt]:
                return np.asarray(np.rint(D), dtype=dt), dt
        return None
    if not integral:
        raise ValueError(f"cannot pack distance table to {mode}: entries "
                         f"are not exact integers (quantize='auto' falls "
                         f"back to float32)")
    if lo < -_INT_RANGE[mode] - 1 or hi > _INT_RANGE[mode]:
        raise ValueError(f"cannot pack distance table to {mode}: range "
                         f"[{lo:g}, {hi:g}] exceeds ±{_INT_RANGE[mode]}")
    return np.asarray(np.rint(D), dtype=mode), mode


def derive_kernel_config(kind: str, bucket=None, backend: str | None = None,
                         table=None, block_rows: int | None = None,
                         lanes: int | None = None,
                         acc_dtype: str | None = None,
                         quantize: str = "auto") -> KernelConfig:
    """Select the kernel geometry for one (distance form, bucket,
    device type) — the ``Mapper.lower``-time hook.

    ``bucket`` is the plan's :class:`~repro.core.spec.ShapeBucket` (or
    ``None`` for dynamic plans → seed-era defaults); ``table`` is the
    materialized distance matrix for ``kind == "matrix"`` (quantization
    candidate); the keyword overrides are the serialized knobs of
    :class:`~repro.core.spec.KernelSpec` and win over derivation.
    """
    if backend is None:
        raise ValueError("derive_kernel_config needs the device type "
                         "('cuda' or 'cpu') as backend")
    budget = _TILE_BYTES.get(backend, _TILE_BYTES_DEFAULT)
    e = bucket.num_edges if bucket is not None else 128
    k = bucket.max_deg if bucket is not None else 8
    k_pad = _pow2_at_least(max(k, 128))          # lane-padded ELL width
    if lanes is None:
        # ~8 reduction rows over the bucket's padded edge list, clamped
        # to the backend's tile budget (pad_to_lanes clamps small E down
        # again at call time, so oversizing here is free)
        lanes = min(max(budget // 4 // max(1, _pow2_at_least(8)), 128),
                    max(128, _pow2_at_least(-(-e // 8))))
        lanes = min(lanes, 8192)
        lanes = max(128, (lanes // 128) * 128)
    if block_rows is None:
        width = max(k_pad, lanes)
        block_rows = int(np.clip(_pow2_at_most(budget // (width * 4)),
                                 8, 4096))
    dist_dtype = None
    if kind == "matrix" and table is not None:
        packed = quantize_table(table, quantize)
        if packed is not None:
            dist_dtype = packed[1]
    return KernelConfig(block_rows=int(block_rows), lanes=int(lanes),
                        acc_dtype=acc_dtype or "float32",
                        dist_dtype=dist_dtype).validate()


def table_bytes(n_pe: int, dist_dtype: str | None) -> int:
    """Bytes of one n×n distance table under a packing — the bench's
    bytes-moved accounting for the gather path."""
    itemsize = {"int8": 1, "int16": 2, None: 4}[dist_dtype]
    return n_pe * n_pe * itemsize
