"""Runtime audit: run every registered construction x topology through
the plan's entry points under an op recorder, and hold the run to the
port's sync discipline — the eager counterpart of the JAX package's
jaxpr audit (``repro/staticcheck/jaxpr_audit.py``), which walks traced
programs the port does not have.

The recorder is a ``torch.utils._python_dispatch.TorchDispatchMode``
that sees every aten op the run makes, and the observer of
:func:`repro_torch.runtime.boundary.set_observer`, which tells it of
every ``host_boundary`` scope opened and closed and brackets every
``Boundary.read``.  What it asserts, per run:

- **counted reads only** — every ``aten._local_scalar_dense`` (what
  ``.item()``, ``bool()``, ``int()`` and ``float()`` of a tensor reach)
  happens inside a ``Boundary.read``, one per 0-d read, and the reads
  the recorder saw equal the reads the scopes counted;
- **no copy between devices in a loop** — inside a counted scope (a
  ``host_boundary`` on a CUDA device: the sweep, contraction and round
  loops) a copy between devices happens only in a ``Boundary.read`` or
  in a scope named ``*.upload`` (the plan's named uploads);
- **accumulator dtype discipline** — every floating intermediate has
  the plan's ``KernelConfig.acc_dtype``; in particular no float64 leaks
  in.

On a card (``device="cuda"``) the run is also under PyTorch's sync debug
mode from end to end, and every sync it reports must be a counted read:
inside a counted scope the scope's observed syncs equal its reads (the
check ``chip_smoke.py`` makes of every engine call), and anywhere else a
sync must come from a ``Boundary.read`` or a ``*.upload`` scope.  On the
CPU there is no copy between devices and no sync to observe, so the
first and third assertions carry the audit there.

Entry points run per plan: ``execute`` of one graph; ``execute_batch``
of 2 graphs (2 lanes of one sweep loop); and the portfolio's
shared-graph lanes (``PortfolioSpec(lanes=2, rounds=2)``: its upload,
lane refinement over one graph, a kick and a round, its readback).
Combos a construction cannot run (hierarchy constructions on a non-tree
machine: the port lowers them and refuses them at construction, which
the audit asks once before it records) are reported as skipped, not
failed.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# one small instance per registered topology kind (16 PEs each)
SMALL_TOPOLOGIES: dict[str, dict] = {
    "tree": {"factors": [4, 4], "distances": [1.0, 10.0]},
    "fattree": {"arities": [4, 4]},
    "torus": {"dims": [4, 4]},
    "dragonfly": {"pes_per_router": 2, "routers_per_group": 2,
                  "n_groups": 4},
    "matrix": {"matrix": [[float(abs(i - j)) for j in range(16)]
                          for i in range(16)]},
}

# what PyTorch's sync warning says; its one-time notice on entering the
# debug mode ("... does not yet detect all synchronizing operations") is
# no sync
_SYNC = "called a synchronizing"
_COPIES = {"_to_copy", "copy_", "_copy_from", "_copy_from_and_resize"}


class Recorder(TorchDispatchMode):
    """Records the ops of one run and what the boundary tells it."""

    def __init__(self, acc_dtype: str):
        super().__init__()
        self.acc = getattr(torch, acc_dtype)
        self.open: list = []            # open scopes, innermost last
        self.depth = 0                  # reads in progress
        self.reads = self.scalar_reads = self.counted = 0
        self.syncs = 0                  # _local_scalar_dense ops
        self.problems: set[str] = set()

    # ---- the boundary's observer
    def opened(self, b):
        self.open.append(b)

    def closed(self, b):
        self.open.remove(b)
        self.counted += b.reads
        if b.syncs is not None and b.syncs != b.reads:
            self.problems.add(
                f"scope {b.tag}: {b.syncs} syncs observed against "
                f"{b.reads} counted reads")

    @contextlib.contextmanager
    def reading(self, b, t):
        self.reads += 1
        self.scalar_reads += t.dim() == 0
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1

    def where(self) -> str:
        return "/".join(b.tag for b in self.open) or "no scope"

    def named_upload(self) -> bool:
        return any(b.tag.endswith(".upload") for b in self.open)

    # ---- the op recorder
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name == "_local_scalar_dense":
            self.syncs += 1
            if not self.depth:
                self.problems.add(
                    f"aten._local_scalar_dense outside Boundary.read "
                    f"({self.where()})")
        tensors = [t for t in tree_leaves((args, kwargs, out))
                   if isinstance(t, torch.Tensor)]
        if name in _COPIES and not self.depth \
                and len({t.device.type for t in tensors}) > 1 \
                and any(b.syncs is not None for b in self.open) \
                and not self.named_upload():
            self.problems.add(
                f"aten.{name} between devices inside a counted scope "
                f"({self.where()})")
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) \
                    and t.dtype.is_floating_point and t.dtype != self.acc:
                self.problems.add(
                    f"floating intermediate dtype "
                    f"{str(t.dtype).removeprefix('torch.')} from "
                    f"aten.{name} != KernelConfig acc_dtype "
                    f"{str(self.acc).removeprefix('torch.')}")
        return out

    def sync_warning(self) -> None:
        """A sync PyTorch reported outside every counted scope."""
        if not self.depth and not self.named_upload():
            self.problems.add(
                f"a sync outside Boundary.read and the named uploads "
                f"({self.where()})")

    def check_totals(self) -> None:
        if self.syncs != self.scalar_reads:
            self.problems.add(
                f"{self.syncs} aten._local_scalar_dense against "
                f"{self.scalar_reads} reads of 0-d tensors")
        if self.reads != self.counted:
            self.problems.add(
                f"{self.reads} reads seen against {self.counted} "
                f"counted by the scopes")


def audit_run(fn, acc_dtype: str = "float32", device: str = "cpu") -> list:
    """Run ``fn()`` under the recorder; the problems found (empty =
    clean).  On ``cuda`` PyTorch's sync debug mode is on for the whole
    run and every sync it reports outside a counted scope is checked."""
    from ..runtime.boundary import set_observer
    rec = Recorder(acc_dtype)
    cuda = device == "cuda"
    with contextlib.ExitStack() as stack:
        if cuda:
            stack.enter_context(warnings.catch_warnings())
            warnings.filterwarnings("always", message=_SYNC)
            prev = warnings.showwarning

            def showwarning(message, category, filename, lineno, file=None,
                            line=None):
                if _SYNC in str(message).lower():
                    rec.sync_warning()
                    return
                prev(message, category, filename, lineno, file, line)
            warnings.showwarning = showwarning
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            stack.callback(torch.cuda.set_sync_debug_mode, mode)
        before = set_observer(rec)
        stack.callback(set_observer, before)
        with rec:
            fn()
        if cuda:
            torch.cuda.synchronize()
    rec.check_totals()
    return sorted(rec.problems)


def _ring_graph(n: int, stride: int = 1):
    from ..core.graph import from_edges
    u = np.arange(n, dtype=np.int64)
    v = (u + stride) % n
    w = np.ones(n, dtype=np.float64)
    return from_edges(n, u, v, w)


def audit_plan(topo, g, construction: str, device: str) -> dict:
    """Audit one construction on one machine through the three entry
    points; ``{"status", "problems"}``."""
    from ..core import Mapper, MappingSpec
    from ..core.spec import PortfolioSpec
    g2 = _ring_graph(g.n, stride=3)
    problems: list[str] = []
    runs = []
    for kind, extra in (("plan", {}),
                        ("portfolio", {"portfolio": PortfolioSpec(
                            lanes=2, rounds=2)})):
        spec = MappingSpec(construction=construction, engine="device",
                           backend="pallas", **extra).validate()
        try:
            plan = Mapper(topo, spec, device=device).lower_for(g)
            # the port lowers every combo and refuses an incompatible
            # construction when it runs: ask it once, outside the audit
            plan._construct_one(g, spec.seed)
        except (ValueError, TypeError, NotImplementedError) as exc:
            return {"status": "skipped", "problems": [f"lower: {exc}"]}
        acc = plan.kernel_configs[0].acc_dtype
        if kind == "plan":
            runs += [("execute", acc, lambda p=plan: p.execute(g)),
                     ("execute_batch", acc,
                      lambda p=plan: p.execute_batch([g, g2]))]
        else:
            runs.append(("portfolio lanes", acc,
                         lambda p=plan: p.execute(g)))
    for label, acc, fn in runs:
        problems += [f"{label}: {p}" for p in audit_run(fn, acc, device)]
    return {"status": "failed" if problems else "ok", "problems": problems}


def run_audit(constructions: list[str] | None = None,
              topologies: list[str] | None = None,
              device: str = "cuda") -> dict:
    """Audit every construction x topology combo on ``device``; returns
    a JSON-friendly report dict."""
    from ..core import list_constructions
    from ..runtime.device import resolve_device
    from ..topology import list_topologies, make_topology
    device = resolve_device(device).type
    constructions = constructions or list_constructions()
    topologies = topologies or list_topologies()
    entries: list[dict] = []
    for topo_kind in topologies:
        params = SMALL_TOPOLOGIES.get(topo_kind)
        if params is None:
            entries.append({"construction": "*", "topology": topo_kind,
                            "status": "skipped",
                            "problems": ["no small instance registered "
                                         "for this topology kind"]})
            continue
        topo = make_topology(topo_kind, **params)
        g = _ring_graph(topo.n_pe)
        for cons in constructions:
            entry = {"construction": cons, "topology": topo_kind}
            entry.update(audit_plan(topo, g, cons, device))
            entries.append(entry)
    failed = [e for e in entries if e["status"] == "failed"]
    return {"device": device, "entries": entries, "ok": not failed}
