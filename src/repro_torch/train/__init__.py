"""Step functions of the LM substrate; only ``serve_step`` is ported."""

from .steps import serve_step

__all__ = ["serve_step"]
