"""The port's host-boundary scopes (``runtime/boundary.py``) across
threads, on the CPU.

PyTorch's sync debug mode is stubbed by a Python variable
(``torch.cuda.get_sync_debug_mode`` / ``set_sync_debug_mode``) and a sync
by the warning PyTorch raises for one ("called a synchronizing CUDA
operation"), so a ``host_boundary(..., "cuda")`` scope runs here as it
does on a card.  Two threads open overlapping scopes in both orders of
leaving: each scope counts exactly its own thread's sync warnings, the
mode is back at its start value once both have closed, and no other
warning is swallowed — a sync warning from a thread outside every scope,
another kind of warning from inside one, and a warning raised after both
closed all reach the caller.  Nested scopes on one thread count a sync
in the innermost CUDA scope, as before.  An all-thread scope also takes
the syncs of threads without a scope.  The card's counterpart (two
device-engine ``MappingService`` s at once) is in
``tests/test_torch_card.py``.
"""

import contextlib
import threading
import warnings

import pytest
import torch

from repro_torch.runtime import boundary
from repro_torch.runtime.boundary import host_boundary

SYNC = "called a synchronizing CUDA operation"


@pytest.fixture
def mode(monkeypatch):
    """The stubbed sync debug mode: a one-element list holding it."""
    state = [0]
    names = {"default": 0, "warn": 1, "error": 2}
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: state[0])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: state.__setitem__(0, names.get(m, m)))
    return state


def sync(n=1):
    """``n`` syncs as PyTorch reports them in mode "warn"."""
    for _ in range(n):
        warnings.warn(SYNC, UserWarning)


def _synced(caught):
    return sum(SYNC in str(w.message) for w in caught)


def _run(a_script, b_script):
    """Run two threads through their scripts in lock step: step i of
    each runs before step i + 1 of either.  A script is a list of
    callables taking that thread's ExitStack."""
    steps = max(len(a_script), len(b_script))
    gate = threading.Barrier(2)
    errors = []

    def worker(script):
        with contextlib.ExitStack() as stack:
            for i in range(steps):
                try:
                    if i < len(script) and script[i] is not None:
                        script[i](stack)
                except BaseException as exc:        # noqa: BLE001
                    errors.append(exc)
                gate.wait(timeout=30)

    threads = [threading.Thread(target=worker, args=(s,))
               for s in (a_script, b_script)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors


@pytest.mark.parametrize("first_out", ["a", "b"])
def test_overlapping_scopes_count_their_own_syncs(mode, first_out):
    """A opens first; B opens inside A's scope; one leaves first (both
    orders), and the other keeps syncing after that.  Each scope counts
    exactly its own thread's syncs, the mode ends where it started, a
    non-sync warning and a sync from an unscoped thread reach the
    caller, and so does a sync after both closed."""
    scopes = {}

    def enter(name):
        def step(stack):
            scopes[name] = stack.enter_context(host_boundary(name, "cuda"))
            assert mode[0] == 1             # "warn" while any scope is open
        return step

    def leave(stack):
        stack.close()

    def other(stack):
        sync(2)
        warnings.warn("not a sync", RuntimeWarning)

    def unscoped(stack):
        t = threading.Thread(target=sync)
        t.start()
        t.join(timeout=30)

    a_after, b_after = (0, 3) if first_out == "a" else (4, 0)
    a = [enter("a"), lambda s: sync(1), lambda s: sync(1), None,
         leave if first_out == "a" else None,
         (lambda s: sync(a_after)) if a_after else None, leave]
    b = [None, enter("b"), other, unscoped,
         leave if first_out == "b" else None,
         (lambda s: sync(b_after)) if b_after else None, leave]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        hook = warnings.showwarning
        _run(a, b)
        assert warnings.showwarning is hook
        assert scopes["a"].syncs == 2 + a_after
        assert scopes["b"].syncs == 2 + b_after
        assert mode[0] == 0
        assert _synced(caught) == 1         # the unscoped thread's
        assert [str(w.message) for w in caught
                if w.category is RuntimeWarning] == ["not a sync"]
        sync(1)                             # after both scopes closed
        assert _synced(caught) == 2
    assert boundary._open == 0 and boundary._saved is None


def test_nested_scopes_on_one_thread_count_in_the_innermost(mode):
    mode[0] = 2                             # "error" before the scopes
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with host_boundary("outer", "cuda") as outer:
            sync(1)
            with host_boundary("inner", "cuda") as inner:
                assert mode[0] == 1
                sync(2)
            with host_boundary("host side") as plain:   # not a CUDA scope
                sync(1)
            assert mode[0] == 1
        assert (outer.syncs, inner.syncs, plain.syncs) == (2, 2, None)
        assert mode[0] == 2
        assert _synced(caught) == 0
        sync(1)
        assert _synced(caught) == 1


def test_a_sync_repeated_on_one_line_counts_every_time(mode):
    """The default filter shows a warning once per source line; a scope
    counts each sync."""
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("default")
        with host_boundary("loop", "cuda") as hb:
            for _ in range(5):
                sync(1)
    assert hb.syncs == 5


def test_scope_left_by_an_exception_restores_everything(mode):
    filters = list(warnings.filters)
    hook = warnings.showwarning
    with pytest.raises(ValueError):
        with host_boundary("failing", "cuda") as hb:
            sync(1)
            raise ValueError("inside the scope")
    assert hb.syncs == 1
    assert mode[0] == 0
    assert warnings.showwarning is hook
    assert warnings.filters == filters
    assert boundary._open == 0


def test_all_thread_scope_takes_unscoped_threads_syncs(mode):
    """While an all-thread scope is open, a sync from a thread with no
    scope of its own (as the autograd engine's device thread, which runs
    a training step's backward) is charged to it; a thread with its own
    scope keeps its syncs; once the all-thread scope has closed, an
    unscoped thread's sync reaches the caller again."""
    def in_thread(fn):
        t = threading.Thread(target=fn)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()

    own = {}

    def scoped():
        with host_boundary("own", "cuda") as hb:
            sync(3)
        own["hb"] = hb

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with host_boundary("train.step", "cuda", all_threads=True) as step:
            sync(1)
            in_thread(lambda: sync(2))
            in_thread(scoped)
            with host_boundary("inner", "cuda") as inner:   # this thread's
                in_thread(lambda: sync(1))
                sync(1)
        assert (step.syncs, inner.syncs, own["hb"].syncs) == (4, 1, 3)
        assert _synced(caught) == 0
        in_thread(lambda: sync(1))
        assert _synced(caught) == 1
    assert boundary._ALL == [] and boundary._open == 0 and mode[0] == 0


def test_host_scope_counts_reads_and_no_syncs():
    with host_boundary("engine.readback") as hb:
        assert hb.read(torch.tensor(3)) == 3
        assert hb.read(torch.arange(2)).tolist() == [0, 1]
    assert (hb.reads, hb.syncs) == (2, None)
