"""Machine distances from their definitions, one file a machine kind:
``machines/<kind>.py`` holds ``make(machine) -> (D, n)``, with ``D(p, q)``
vectorised in float64, and the kind's definition in its docstring.  A
machine kind is looked up in the folders of :data:`MACHINE_DIRS` in
turn."""

from __future__ import annotations

import importlib.util
from pathlib import Path

__all__ = ["MACHINE_DIRS", "distance_fn"]

MACHINE_DIRS = [Path(__file__).resolve().parent / "machines"]
_LOADED: dict = {}


def _machine(kind: str):
    for folder in MACHINE_DIRS:
        path = Path(folder) / f"{kind}.py"
        if path.is_file():
            break
    else:
        raise ValueError(f"the reference has no machine kind {kind!r}")
    mod = _LOADED.get(path)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            f"portbench_reference_machine_{kind}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return mod


def distance_fn(machine: dict):
    """``D(p, q)`` (vectorised, float64) and the PE count of a
    configuration's ``machine`` block."""
    return _machine(machine["kind"]).make(machine)
