"""Documented host<->device boundaries, with a count of host syncs.

The JAX package marks its deliberate transfers with a
``jax.transfer_guard("allow")`` scope.  The port's eager sweep loop
cannot avoid syncing — PyTorch has no device-side ``while_loop``, so the
loop and the matching rounds read a scalar back each iteration — and the
point of this module is that those syncs are named and counted, not
hidden:

    with host_boundary("engine.sweeps") as hb:
        ...
        if hb.read(flag):          # a deliberate, counted readback
            ...
    hb.reads      # readbacks made through hb.read
    hb.syncs      # syncs PyTorch itself reported inside the scope
                  # (CUDA only; None elsewhere)

On a CUDA device the scope turns on
``torch.cuda.set_sync_debug_mode("warn")`` and counts the warnings it
raises, so ``syncs`` also catches syncs that did not go through
``read`` (a boolean-mask index, a ``.cpu()``, a 0-d CUDA tensor used as
a Python index).  The debug mode and the warning capture are
process-global: scopes are meant for one thread at a time, the engine's
own use.  A scope may run off the main thread (the mapping service's
worker runs every engine scope of its Mapper) as long as no other
thread syncs the device while it is open.
"""

from __future__ import annotations

import contextlib
import warnings

__all__ = ["Boundary", "host_boundary"]


class Boundary:
    """One named boundary scope (see module docstring)."""

    def __init__(self, tag: str):
        self.tag = tag
        self.reads = 0
        self.syncs = None

    def read(self, t):
        """One deliberate, counted device->host readback: ``t.item()``
        for a 0-d tensor, a numpy array of ``t`` otherwise."""
        self.reads += 1
        return t.item() if t.dim() == 0 else t.cpu().numpy()


@contextlib.contextmanager
def host_boundary(tag: str, device=None):
    """Mark a deliberate host<->device crossing named ``tag`` (in the
    style of a metrics key: ``"engine.sweeps"``, ``"plan.objective"``)
    and yield its :class:`Boundary`.  With a CUDA ``device`` the syncs
    inside the scope are counted through PyTorch's sync debug mode."""
    b = Boundary(tag)
    if device is None or getattr(device, "type", device) != "cuda":
        yield b
        return
    import torch
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield b
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    b.syncs = sum(1 for w in caught
                  if "synchroniz" in str(w.message).lower())
