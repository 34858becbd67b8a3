"""TPU machine-model presets built on the topology backends.

The tree presets in :mod:`repro_torch.core.hierarchy` approximate the ICI mesh
with nested distance classes; these are the honest models: a v5e pod is a
16×16 2D torus of chips, a v5p pod a 3D torus — wraparound ICI links,
per-axis hop distance.  Multi-pod fleets add a pod axis whose weight is
the DCN/ICI cost ratio (~60×); with 2 pods the "ring" over pods is a
single DCN link, exactly right, and for small pod counts a ring is the
standard DCN modeling compromise.
"""

from __future__ import annotations

from .torus import TorusTopology


def tpu_v5e_torus(pods: int = 1, dcn_weight: float = 60.0) -> TorusTopology:
    """v5e: 16×16 2D ICI torus per pod (256 chips); ``pods`` > 1 appends a
    DCN pod axis.  Axis weights are relative link costs (ICI hop = 1)."""
    if pods == 1:
        return TorusTopology((16, 16), (1.0, 1.0))
    return TorusTopology((16, 16, pods), (1.0, 1.0, float(dcn_weight)))


def tpu_v5p_torus(dims=(8, 8, 16), pods: int = 1,
                  dcn_weight: float = 60.0) -> TorusTopology:
    """v5p: 3D ICI torus per pod (default 8×8×16 = 1024 chips)."""
    dims = tuple(int(d) for d in dims)
    if pods == 1:
        return TorusTopology(dims, (1.0,) * len(dims))
    return TorusTopology(dims + (pods,),
                         (1.0,) * len(dims) + (float(dcn_weight),))
