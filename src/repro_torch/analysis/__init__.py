"""HLO-text analysis: cost extraction + roofline model — the port's
copies of the JAX package's ``analysis`` modules.  They read HLO *text*
(numpy and the standard library only), so the port needs no XLA for
them; the text comes from a compiled program or a saved fixture."""

from .hlo import HloCost, analyze, parse_module
from .roofline import Roofline, roofline_from_cost

__all__ = ["HloCost", "analyze", "parse_module", "Roofline",
           "roofline_from_cost"]
