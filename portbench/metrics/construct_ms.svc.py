"""Plan layer: the mean of the program's ``plan.construct`` spans in the
traced window, in ms.  Moves ``maps_per_s``."""


def read(ctx):
    spans = ctx.spans_named("plan.construct")
    if not spans:
        return None
    return 1e3 * sum(sp.dur for sp in spans) / len(spans)
