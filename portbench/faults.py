"""Faults planted in the program under test, for the upper readings of
the numbers compared and for the tests that see ``correct`` come out
false.  Each replaces one of the program's methods for as long as the
``with`` block lasts and changes nothing else.

* ``unchanged``: the refinement returns the state it was given: every
  sweep loop leaves its permutations as they came and reports their
  starting objective.
* ``half_batch``: a batched map refines the first half of its lanes and
  hands their results to the other half as well.
* ``altered``: every answer's permutation has two entries exchanged
  after the answer was made (its reported objective left as it was).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

__all__ = ["FAULTS", "plant"]


def _altered(res):
    perm = np.array(res.perm, copy=True)
    perm[[0, 1]] = perm[[1, 0]]
    return dataclasses.replace(res, perm=perm)


def _patches(name: str):
    from repro_torch.core.plan import MappingPlan
    from repro_torch.engine import RefinementEngine
    if name == "unchanged":
        def refine_batch(self, graphs, perms, pairs_list, j0s=None, **kw):
            from repro_torch.core import qap_objective
            if j0s is None:
                j0s = [qap_objective(g, self.topology, p)
                       for g, p in zip(graphs, perms)]
            return [self._unmoved(j0, kw.get("telemetry", False))
                    for j0 in j0s]
        return [(RefinementEngine, "refine_batch", refine_batch)]
    if name == "half_batch":
        orig = MappingPlan.execute_batch

        def execute_batch(self, graphs, seed=None, telemetry=False):
            graphs = list(graphs)
            half = max(1, len(graphs) // 2)
            done = orig(self, graphs[:half], seed=seed, telemetry=telemetry)
            return done + [done[i % half] for i in range(len(graphs) - half)]
        return [(MappingPlan, "execute_batch", execute_batch)]
    if name == "altered":
        out = []
        for meth in ("execute", "execute_batch"):
            orig = getattr(MappingPlan, meth)

            def patched(self, *a, _orig=orig, **kw):
                res = _orig(self, *a, **kw)
                if isinstance(res, list):
                    return [_altered(r) for r in res]
                return _altered(res)
            out.append((MappingPlan, meth, patched))
        return out
    raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")


FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def plant(name: str):
    patches = _patches(name)
    saved = [(cls, attr, cls.__dict__[attr]) for cls, attr, _ in patches]
    try:
        for cls, attr, fn in patches:
            setattr(cls, attr, fn)
        yield
    finally:
        for cls, attr, fn in saved:
            setattr(cls, attr, fn)
