"""The benchmark of the PyTorch/CUDA port of VieM (``repro_torch``).

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line.  Everything the yardstick needs lives here: the
structure and traffic generators, the plain reference that decides
``correct``, the roofline counts and the per-layer metric readers.
Configurations (``configs/``), traffic kinds (``kinds/``), structure
generators (``structures/``), traffic mixes (``traffic/``), the limits of
each cell's comparison (``limits/``), per-layer metrics (``metrics/``)
and the reference's machine kinds (``reference/machines/``) are files
found by name (:mod:`portbench.plugins`).
"""
