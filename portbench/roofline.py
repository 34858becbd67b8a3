"""The least time the card could take for the mapping kernels' work.

Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM and 67 TFLOP/s of float32 outside the tensor
cores.  K1 and K2 do scalar float32/int32 arithmetic, so they are held to
those two.  A kernel's roofline share is the larger of bytes over the
bandwidth and operations over the float32 peak, divided by its device
time.

Bytes count each input the work needs read once and each output written
once, whatever the kernel reads again: for a call whose lanes map one
structure (n processes, P candidate pairs, neighbour rows k wide, E
edges), the structure's pair ids and neighbour ids (or edge ends) once,
and each lane's weights, permutation and output.  Tree and torus
distances are computed, not read; a distance table (the matrix form) is
not counted, so a share there is a lower bound.
"""

from __future__ import annotations

__all__ = ["PEAK_BYTES_PER_S", "PEAK_FP32_FLOPS", "k1_work", "k2_work",
           "least_seconds"]

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
_I32 = _F32 = 4


def k2_work(lanes: int, pairs: int, k: int, n: int
            ) -> tuple[float, float]:
    """(bytes, operations) of the swap gains of ``pairs`` candidate pairs
    of one structure in each of ``lanes`` lanes: the pair ids (u, v) and
    the neighbour ids (n · k) once; per lane the neighbour weights, the
    permutation and the gains written.  Operations: per pair and side, k
    slots of (subtract, multiply, add)."""
    nbytes = (2 * pairs * _I32 + n * k * _I32
              + lanes * (n * k * _F32 + n * _I32 + pairs * _F32))
    return float(nbytes), float(lanes * pairs * 2 * k * 3)


def k1_work(lanes: int, edges: int, n: int) -> tuple[float, float]:
    """(bytes, operations) of the objective of ``lanes`` permutations over
    the ``edges`` edges of one structure: the edge ends (u, v) once; per
    lane the weights, the permutation and one float32 written.
    Operations: per edge a distance and a multiply-add, counted as 2."""
    nbytes = edges * 2 * _I32 + lanes * (edges * _F32 + n * _I32 + _F32)
    return float(nbytes), float(lanes * edges * 2)


def least_seconds(nbytes: float, flops: float) -> tuple[float, str]:
    """The bound and what sets it: ``"bytes"`` or ``"operations"``."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
