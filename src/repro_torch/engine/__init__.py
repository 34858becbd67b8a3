"""Device-resident refinement engine: the sweep loop on one device.

The guide's central speedup is the cheap incremental gain during
pair-exchange local search (§2.1).  This package runs the whole sweep
loop on the device: graph, permutation, candidate pairs, gains,
conflict resolution and the objective live in device tensors, and only
one value per sweep (each lane's best gain) and one flag per matching
round come back to the host.  The loop runs over a lane axis: a batch
of graphs (``RefinementEngine.refine_batch``, a single ``refine`` being
a batch of one), or restart lanes of one graph whose graph and pair
tensors every lane shares (``refine_lanes``, the portfolio's), shares
every sweep's kernel launches and readbacks.
One sweep is:

  1. **Gains** — the sparse O(deg) gain of every candidate pair at once
     (:func:`repro_torch.kernels.pair_gain.pair_gains`: the K2 CUDA
     kernel on the card, its plain version on the CPU).
  2. **Conflict resolution** — a greedy *maximal* matching of
     positive-gain pairs by gain priority: rounds of locally dominant
     pairs (highest gain at both endpoints, ties to the lowest index),
     matched vertices masked out between rounds.
  3. **Apply and verify** — the matching is applied when the recomputed
     objective (the K1 kernel on the card) beats the best single swap;
     otherwise that swap is applied with its exact gain.

It is the port of the JAX package's ``repro.engine``; with integer
weights and distances both give the same permutation, trace, sweep and
swap counts and telemetry (tested on the CPU, checked on the card by
``chip_smoke.py``).
"""

from .sweep import RefinementEngine

__all__ = ["RefinementEngine"]
