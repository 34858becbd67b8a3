"""One run of one cell: load its files by name, set up, measure, judge,
and assemble the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
The configuration's file is the ``file`` of its ``configs`` entry; the
mix is ``traffic/<traffic>.json``, whose ``kind`` names the traffic kind
``kinds/<kind>.py`` that makes its inputs, drives the program and judges
the window; the limits of the cell's comparison are
``limits/<workload>.json``; a per-layer metric is the ``read(ctx)`` of
``metrics/<metric>.py`` (:mod:`portbench.plugins`).  Nothing here names
a cell, a configuration, a mix, a kind or a metric: adding one is adding
files and entries.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path

from . import graphs, plugins
from .trace import Capture, KernelCalls, device_summary

__all__ = ["Cell", "judge_window", "kind_of", "load_benchmark", "load_cell",
           "metric_reader", "run_cell"]


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list        # the BENCHMARK.json entries this cell reports
    per_layer: list
    judge_params: dict          # the definitions the limits rest on


def _reports(entry: dict, cell: str, e2e_names=None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return e2e_names is None or entry["moves"] in e2e_names


def load_cell(root: Path, bench: dict, name: str) -> Cell:
    """The cell ``name`` of ``bench`` with its configuration read from
    ``root`` (the checkout) and its traffic and limits found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / cfg_entry["file"]) as fh:
        config = json.load(fh)
    with open(plugins.find("traffic", w["traffic"], ".json")) as fh:
        traffic = json.load(fh)
    with open(plugins.find("limits", name, ".json")) as fh:
        limits = json.load(fh)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, limits["limits"],
                e2e, per_layer, limits.get("params", {}))


def kind_of(cell: Cell):
    """The module of the cell's traffic kind, ``kinds/<kind>.py``."""
    return plugins.load("kinds", cell.traffic["kind"])


def metric_reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``, or, where there is no
    such file, of ``metrics/<name less its last .suffix>.py``: one reader
    serves a metric that several cells report under their own names."""
    try:
        return plugins.load("metrics", name).read
    except FileNotFoundError:
        if "." not in name:
            raise
        return plugins.load("metrics", name.rsplit(".", 1)[0]).read


class Context:
    """What a per-layer metric reader may read: the traced window's
    program spans, the kernel calls, the device summary, the driver's
    counters, the configuration, the traffic parameters, the sizes of the
    traffic's structures (:func:`portbench.graphs.shape_of`) and the
    window."""

    def __init__(self, cell: Cell, capture: Capture, window, device,
                 traffic):
        self.config = cell.config
        self.traffic = cell.traffic
        self.structures = {name: graphs.shape_of(s)
                           for name, s in traffic.structures.items()}
        self.spans = capture.spans
        self.kernel_calls = capture.calls
        self.device = device
        self.window = window
        self.t0, self.t1 = capture.t0, capture.t1

    def spans_named(self, name: str) -> list:
        return [sp for sp in self.spans if sp.name == name]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """Set up, measure, judge; the result line as a dict (``checks``
    last) and, under ``"stderr"``, the lines to print there."""
    t_enter = time.perf_counter()
    t_start = t_enter if t_start is None else t_start
    kind = kind_of(cell)
    calls = KernelCalls()
    if trace:
        calls.install()
    try:
        t_cuda = time.perf_counter()
        if device == "cuda":
            import torch
            torch.ones(1, device=device).sum().item()
        t_cuda = time.perf_counter() - t_cuda
        driver = kind.Driver(cell.config, cell.traffic, device)
        traffic = kind.Traffic(cell.traffic, seed)
        calls.structure_of = driver.structure_of
        driver.setup(traffic, seed)
        driver.phases.update(imports=t_enter - t_start, cuda_init=t_cuda)
        if device == "cuda":
            import torch
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        capture = Capture(calls, device) if trace else None
        window = driver.window(traffic, seconds, capture)
        if device == "cuda":
            import torch
            torch.cuda.synchronize()
            peak = int(torch.cuda.max_memory_allocated())
        else:
            peak = 0
        driver.close()
    finally:
        calls.uninstall()
    verdict = judge_window(cell, window, traffic, seed)
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": _device_name(device), "count": 1,
           "memory_peak_bytes": peak}
    metrics, breakdown = {}, None
    if not trace:
        values = kind.end_to_end(window, verdict, setup_s)
        for m in cell.end_to_end:
            if values.get(m["name"]) is None:
                raise RuntimeError(f"end-to-end metric {m['name']} has no "
                                   f"value in this run")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        t0 = time.perf_counter()
        summary = device_summary(capture)
        capture.cost["summary_s"] = time.perf_counter() - t0
        if capture.dropped:
            raise RuntimeError(f"the span ring dropped {capture.dropped} "
                               f"spans in the traced window")
        ctx = Context(cell, capture, window, summary, traffic)
        for m in cell.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if summary is not None:
            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["window_s"]
            breakdown = {"device_ops": summary["device_ops"],
                         "idle_gaps": summary["idle_gaps"]}
    result = {"correct": verdict.correct, "attempted": verdict.attempted,
              "failed": verdict.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = verdict.checks()
    lines = [f"check {k}: {v['value']!r} limit {v['limit']!r}"
             for k, v in result["checks"].items()]
    lines.insert(0, "readings: " + json.dumps(
        {"setup": driver.phases, **verdict.notes,
         **({"trace": capture.cost} if trace else {})}))
    lines.append(f"correct: {verdict.correct} ({verdict.failed} of "
                 f"{verdict.attempted} failed)")
    return {"result": result, "stderr": lines, "verdict": verdict,
            "window": window, "traffic": traffic}


def judge_window(cell: Cell, window, traffic, seed: int,
                 control: bool = False):
    """The cell's window against the reference (or the control)."""
    return kind_of(cell).judge(window, traffic, cell, seed, control=control)


def _device_name(device: str) -> str:
    if device == "cuda":
        import torch
        return torch.cuda.get_device_name(0)
    import platform
    return platform.processor() or platform.machine()

