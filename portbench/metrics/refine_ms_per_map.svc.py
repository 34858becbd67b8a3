"""Sweep engine layer: the program's ``plan.refine`` spans of the traced
window summed (single maps and batched lanes alike), over the maps
answered in it, in ms.  Moves ``maps_per_s``."""


def read(ctx):
    spans = ctx.spans_named("plan.refine")
    maps = sum(1 for r in ctx.window.requests
               if r.t_answer is not None and ctx.t0 <= r.t_answer <= ctx.t1)
    if not spans or not maps:
        return None
    return 1e3 * sum(sp.dur for sp in spans) / maps
