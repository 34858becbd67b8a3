"""Checks shared by the port's tests and ``chip_smoke.py``.

:func:`tensors_in` counts the torch tensors a result still holds (what
the mapping service hands out must hold none); :func:`pair_gain_lanes`
records the lane count of every K2 launch while it is entered.

Nothing here runs at import: this module is imported on machines with
no CUDA toolkit.
"""

from __future__ import annotations

import contextlib
import dataclasses

__all__ = ["pair_gain_lanes", "tensors_in"]


def tensors_in(obj) -> int:
    """Torch tensors reachable from ``obj`` through dataclass fields,
    lists, tuples and dict values."""
    import torch
    if isinstance(obj, torch.Tensor):
        return 1
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(tensors_in(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return sum(tensors_in(x) for x in obj)
    if isinstance(obj, dict):
        return sum(tensors_in(x) for x in obj.values())
    return 0


@contextlib.contextmanager
def pair_gain_lanes():
    """While entered, the lane count of every K2 launch (from any
    thread, the mapping service's worker among them), in launch order,
    appended to the yielded list.  The launch counts are left as the
    wrapper keeps them."""
    from .kernels import PAIR_GAIN_KERNEL
    lanes = []
    launch = PAIR_GAIN_KERNEL.launch

    def spy(*args):             # args[8]: the launch's lane count
        lanes.append(int(args[8]))
        return launch(*args)

    PAIR_GAIN_KERNEL.launch = spy
    try:
        yield lanes
    finally:
        del PAIR_GAIN_KERNEL.launch
