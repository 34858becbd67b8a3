"""Device layer: the share of the traced window with nothing running on
the card, in %."""

from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
