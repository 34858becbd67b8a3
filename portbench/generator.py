"""The seeded draws every traffic kind makes its inputs from.

Every draw comes from ``numpy.random.default_rng([seed, stream, index])``,
so draw ``index`` of a stream is the same whatever the timing of the run
and whatever else was drawn.  A kind names its streams by these numbers
(``kinds/*.py``); a new stream takes a new number.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ORDER", "RANDOM", "WEIGHTS", "rng", "random_perm"]

ORDER, WEIGHTS, RANDOM = 0, 1, 4     # a new stream takes a number of its own


def rng(seed: int, stream: int, index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), int(stream), int(index)])


def random_perm(seed: int, n: int) -> np.ndarray:
    """The run's random placement, the denominator of ``j_rel``."""
    return rng(seed, RANDOM, 0).permutation(n)
