"""Helpers that the per-layer metric readers (``metrics/*.py``) share.

The kernels are known by the names the program gives them in
``csrc/``: K1 ``objective<…>`` (``qap_objective.cu``) and K2
``pair_gains<…>`` (``pair_gain.cu``).  Their work is counted by
:mod:`portbench.roofline` from the window's calls
(:class:`portbench.trace.KernelCalls`: each call's lanes, K2's pairs,
and the structure of each lane) and the sizes of those structures in
the benchmark's own graphs (``ctx.structures``).
"""

from __future__ import annotations

import re
from collections import Counter

from . import roofline

__all__ = ["call_work", "idle_pct", "kernel_roofline_pct", "kernel_seconds"]

KERNELS = {
    "k1": re.compile(r"\bobjective<"),
    "k2": re.compile(r"\bpair_gains<"),
}


def kernel_seconds(ctx, kernel: str) -> float:
    pattern = KERNELS[kernel]
    return sum(s for name, s in ctx.device["by_name"].items()
               if pattern.search(name))


def call_work(kernel: str, call: tuple, structures: dict):
    """(bytes, operations) of one recorded call, its lanes grouped by
    structure; None where a lane's structure is unknown."""
    lanes = Counter(call[-1])
    if None in lanes or not set(lanes) <= set(structures):
        return None
    nbytes = flops = 0.0
    for name, m in lanes.items():
        s = structures[name]
        b, f = (roofline.k1_work(m, s["edges"], s["n"]) if kernel == "k1"
                else roofline.k2_work(m, call[1], s["k"], s["n"]))
        nbytes += b
        flops += f
    return nbytes, flops


def kernel_roofline_pct(ctx, kernel: str):
    """The least time of the kernel's calls in the window over its
    device time there, in %; None off the card, without a call, or with a
    call whose work cannot be counted."""
    if ctx.device is None:
        return None
    calls = getattr(ctx.kernel_calls, kernel)
    busy = kernel_seconds(ctx, kernel)
    if not calls or busy <= 0:
        return None
    least = 0.0
    for call in calls:
        work = call_work(kernel, call, ctx.structures)
        if work is None:
            return None
        least += roofline.least_seconds(*work)[0]
    return 100.0 * least / busy


def idle_pct(ctx):
    """The share of the traced window in which nothing ran on the
    device, in %; None off the card."""
    if ctx.device is None:
        return None
    return 100.0 * (1.0 - ctx.device["busy_s"] / ctx.device["window_s"])
