"""Files found by name.

Everything that belongs to one traffic kind, one traffic mix, one
structure generator, one cell's limits or one per-layer metric is a file
of its own under a folder of ``portbench/``, named as ``BENCHMARK.json``
or a data file names it:

* ``kinds/<kind>.py``: a traffic kind (the ``kind`` of a mix), see
  :mod:`portbench.kinds`;
* ``structures/<generator>.py``: ``build(params) -> (n, u, v)``;
* ``traffic/<mix>.json``: a mix's parameters, with its ``kind``;
* ``limits/<workload>.json``: the limits of a cell's comparison;
* ``metrics/<metric>.py``: ``read(ctx)``; a metric named
  ``<base>.<suffix>`` falls back to ``metrics/<base>.py`` where no file
  of its full name exists.

Each name is looked up in the folders of :data:`ROOTS` in turn, so a
test can put a folder of new files first.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

__all__ = ["BENCH_DIR", "ROOTS", "find", "load"]

BENCH_DIR = Path(__file__).resolve().parent
ROOTS = [BENCH_DIR]
_LOADED: dict = {}


def find(folder: str, name: str, suffix: str) -> Path:
    """The first ``<root>/<folder>/<name><suffix>`` of :data:`ROOTS`."""
    for root in ROOTS:
        path = Path(root) / folder / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {folder}/{name}{suffix} under "
                            f"{[str(r) for r in ROOTS]}")


def load(folder: str, name: str):
    """The module ``<folder>/<name>.py``, loaded once per path."""
    path = find(folder, name, ".py")
    mod = _LOADED.get(path)
    if mod is None:
        tag = f"portbench_{folder}_{name}".replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(tag, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[tag] = mod          # dataclasses look their module up
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return mod
