"""Sweep engine and host boundary: the counted reads of the sweep loops
in the traced window over their sweeps (loop passes), from the
``syncs`` the program's ``plan.refine`` spans carry: 1 plus the
matching rounds of a sweep.  Moves ``maps_per_s``."""


def read(ctx):
    reads = passes = 0
    for sp in ctx.spans_named("plan.refine"):
        syncs = sp.attrs.get("syncs")
        if syncs and syncs.get("passes"):
            reads += syncs["reads"]
            passes += syncs["passes"]
    return reads / passes if passes else None
