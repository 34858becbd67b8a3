"""The benchmark's own tests: ``python -m pytest portbench/tests`` from
the repository's root.  The port's sources and the repository's root
go on the path here, as ``portbench/run.py`` puts them."""

import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
for _p in (_ROOT, _ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))
