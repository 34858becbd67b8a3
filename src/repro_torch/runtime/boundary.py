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

On a CUDA device the scope has PyTorch warn on every synchronizing
operation (``torch.cuda.set_sync_debug_mode("warn")``) and counts the
warnings, so ``syncs`` also catches syncs that did not go through
``read`` (a boolean-mask index, a ``.cpu()``, a 0-d CUDA tensor used as
a Python index).

A scope behaves as if it were thread-local, as ``jax.transfer_guard``
is, though the debug mode and the warnings machinery are process-global:

  * the debug mode is reference-counted: the first CUDA scope to open
    in the process turns it to "warn", the last one to close restores
    the mode that was there before the first opened;
  * while any CUDA scope is open, one hook (``warnings.showwarning``)
    routes the warnings: a sync warning is charged to the innermost
    open scope of the thread that raised it (each thread keeps its own
    stack of open scopes); a sync warning from a thread with no open
    scope, and every other warning, go on to the hook that was there
    before, so nothing is swallowed.  A filter makes every sync warning
    reach the hook (not once per source line); both go when the last
    scope closes.

A scope opened with ``all_threads=True`` also takes the sync warnings of
threads that have no open scope of their own, while it is the innermost
such scope in the process: a training step's backward runs on the
autograd engine's device thread, and the Python it runs there (a
checkpointed layer's recomputed forward, a custom backward) warns on
that thread.

So two threads may hold scopes at once, in any order of opening and
closing, and each counts its own syncs.  Nested scopes on one thread
count a sync in the innermost CUDA scope.  While a scope is open
anywhere, a thread outside every scope sees its own syncs as warnings.
A ``warnings.catch_warnings`` block in another thread that opens before
a scope and closes while it is open puts back the hook it saw, and the
scope's later syncs then go uncounted: such a block is process-global
in the same way.

An observer installed on a thread (:func:`set_observer`; the runtime
audit of :mod:`repro_torch.staticcheck.runtime_audit` is one) is told
of every scope that thread opens and closes, CUDA or not, and brackets
every read made on it, so an op recorder can tell a counted read from
any other sync.  Without one, a scope and a read cost a thread-local
lookup more.
"""

from __future__ import annotations

import contextlib
import threading
import warnings

__all__ = ["Boundary", "host_boundary", "set_observer"]

# what PyTorch's sync warnings say ("called a synchronizing CUDA
# operation"), matched without regard to case
_SYNC = "synchroniz"

_LOCK = threading.Lock()
_LOCAL = threading.local()      # .stack: this thread's open CUDA scopes;
                                # .observer: see set_observer
_open = 0                       # CUDA scopes open in the process
_saved = None                   # (mode, hook, filter) from before the first
_ALL: list = []                 # open all-thread CUDA scopes, innermost last


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
        obs = getattr(_LOCAL, "observer", None)
        if obs is None:
            return t.item() if t.dim() == 0 else t.cpu().numpy()
        with obs.reading(self, t):
            return t.item() if t.dim() == 0 else t.cpu().numpy()


def set_observer(observer):
    """Install ``observer`` on this thread (``None`` removes it) and
    return the one installed before.  It is told of every scope the
    thread opens and closes (``observer.opened(b)``, ``observer.closed(b)``:
    CUDA scopes after their counting starts and before it stops) and
    brackets every read made on the thread (``with
    observer.reading(b, t):`` around the readback of tensor ``t``)."""
    before = getattr(_LOCAL, "observer", None)
    _LOCAL.observer = observer
    return before


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _router(prev):
    """The hook installed while scopes are open: a sync warning goes to
    the raising thread's innermost open scope, or, from a thread with
    none, to the innermost all-thread scope; anything else to
    ``prev``."""
    def showwarning(message, category, filename, lineno, file=None,
                    line=None):
        if _SYNC in str(message).lower():
            scopes = getattr(_LOCAL, "stack", None) or _ALL[-1:]
            if scopes:
                scopes[-1].syncs += 1
                return
        prev(message, category, filename, lineno, file, line)
    return showwarning


def _open_scope(b: Boundary, all_threads: bool) -> None:
    global _open, _saved
    import torch
    b.syncs = 0
    with _LOCK:
        if _open == 0:
            mode = torch.cuda.get_sync_debug_mode()
            hook = warnings.showwarning
            warnings.filterwarnings("always", message=f".*{_SYNC}")
            _saved = (mode, hook, warnings.filters[0])
            warnings.showwarning = _router(hook)
            torch.cuda.set_sync_debug_mode("warn")
        _open += 1
        if all_threads:
            _ALL.append(b)
    _stack().append(b)


def _close_scope(b: Boundary) -> None:
    global _open, _saved
    import torch
    _stack().remove(b)
    with _LOCK:
        if b in _ALL:
            _ALL.remove(b)
        _open -= 1
        if _open == 0:
            mode, hook, flt = _saved
            _saved = None
            torch.cuda.set_sync_debug_mode(mode)
            warnings.showwarning = hook
            if flt in warnings.filters:
                warnings.filters.remove(flt)


@contextlib.contextmanager
def host_boundary(tag: str, device=None, all_threads: bool = False):
    """Mark a deliberate host<->device crossing named ``tag`` (in the
    style of a metrics key: ``"engine.sweeps"``, ``"plan.objective"``)
    and yield its :class:`Boundary`.  With a CUDA ``device`` the syncs
    inside the scope, on this thread, are counted through PyTorch's sync
    debug mode; with ``all_threads`` also those of threads without a
    scope of their own (see module docstring)."""
    b = Boundary(tag)
    cuda = device is not None and getattr(device, "type", device) == "cuda"
    obs = getattr(_LOCAL, "observer", None)
    if cuda:
        _open_scope(b, all_threads)
    if obs is not None:
        obs.opened(b)
    try:
        yield b
    finally:
        if obs is not None:
            obs.closed(b)
        if cuda:
            _close_scope(b)
