"""Traffic kinds, one file each, found by the ``kind`` of a traffic mix
(``traffic/<mix>.json``) as ``kinds/<kind>.py``.  A kind module holds:

* ``Traffic(params, seed)``: the mix's inputs from the seed, the same for
  the same seed; ``.structures`` maps each structure's name to its
  ``(n, u, v)`` (:mod:`portbench.graphs`).
* ``Driver(config, params, device)``: the system under test.
  ``setup(traffic, seed)`` builds and warms it (set-up time),
  ``window(traffic, seconds, capture)`` measures and returns the window's
  record, ``close()`` stops it; ``phases`` holds set-up's parts, and
  ``structure_of(graph)`` names the structure of a graph handed to the
  program (None for one it did not make).
* ``judge(window, traffic, cell, seed, control=False)``: the
  :class:`portbench.judge.Verdict` of the window against the reference
  (or, with ``control``, of the control in the program's place).
* ``end_to_end(window, verdict, setup_s)``: the end-to-end metrics this
  kind can report, by name.

A new kind may take any of these from another: a mix with repeats can
reuse the service kind's driver, judge and metrics beside a traffic of
its own.
"""
