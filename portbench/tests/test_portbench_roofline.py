"""The roofline counts against PERF.md's bounds, and the harness finding
a new traffic mix, kind, structure, cell and metric by name."""

import json

import pytest

from portbench import harness, plugins, roofline
from tinycells import ROOT, TINY_CONFIG, TINY_TRAFFIC


def test_k2_bound_of_the_main_path():
    # tree form, P = 1,824,768 (1,824,720 pairs padded to 128), K = 8
    t, by = roofline.least_seconds(*roofline.k2_work(1, 1824768, 8, 4096))
    assert by == "bytes"
    assert t * 1e3 == pytest.approx(0.00662, abs=5e-6)


def test_k1_bound_of_the_main_path():
    t, by = roofline.least_seconds(*roofline.k1_work(1, 11520, 4096))
    assert by == "bytes"
    assert t * 1e3 == pytest.approx(0.0000462, abs=5e-8)


def test_lanes_and_a_shared_graph():
    # lanes of one structure read its pair ids and neighbour ids once
    one = roofline.k2_work(1, 1000, 8, 64)
    four = roofline.k2_work(4, 1000, 8, 64)
    shared = 2 * 1000 * 4 + 64 * 8 * 4
    assert four[0] == shared + 4 * (one[0] - shared)
    assert four[1] == 4 * one[1]
    assert roofline.k1_work(4, 100, 64)[0] == \
        100 * 8 + 4 * (100 * 4 + 64 * 4 + 4)


def _add_files(tmp_path, monkeypatch, files: dict):
    pb = tmp_path / "portbench"
    for rel, text in files.items():
        (pb / rel).parent.mkdir(parents=True, exist_ok=True)
        (pb / rel).write_text(text)
    monkeypatch.setattr(plugins, "ROOTS", [pb, plugins.BENCH_DIR])
    return pb


def _tiny_bench(tmp_path, cell: str, traffic: str, per_layer=()):
    """BENCHMARK.json with a cell ``cell`` of ``traffic`` on the tiny
    tree (a new configuration file) beside the real cells."""
    bench = harness.load_benchmark(ROOT)
    cfg = json.loads((ROOT / bench["configs"][0]["file"]).read_text())
    cfg.update(TINY_CONFIG)
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append(dict(bench["configs"][0], name="tiny",
                                 file="tiny.json"))
    bench["workloads"].append({"name": cell, "config": "tiny",
                               "traffic": traffic, "chips": 1,
                               "why": "a new cell"})
    bench["per_layer"].extend(per_layer)
    for m in bench["end_to_end"]:
        if "tree4096.svc8" in m.get("workloads", ()):
            m["workloads"].append(cell)
    return bench


def test_a_new_mix_cell_and_metric_are_found_by_name(tmp_path, monkeypatch):
    """A later change adds a traffic file, a limits file, a metric file
    and BENCHMARK.json entries; no file already there changes."""
    svc1 = json.loads((plugins.BENCH_DIR / "traffic" / "svc_closed8.json")
                      .read_text())
    svc1.update(TINY_TRAFFIC, clients=1)
    _add_files(tmp_path, monkeypatch, {
        "traffic/svc_closed1.json": json.dumps(svc1),
        "limits/tiny.svc1.json": (plugins.BENCH_DIR / "limits"
                                  / "tree4096.svc8.json").read_text(),
        "metrics/answers.svc1.py":
            "def read(ctx):\n    return float(len(ctx.window.requests))\n"})
    bench = _tiny_bench(tmp_path, "tiny.svc1", "svc_closed1", [
        {"name": "answers.svc1", "unit": "requests", "better": "higher",
         "source": "host_clock", "layer": "service", "moves": "maps_per_s",
         "workloads": ["tiny.svc1"]},
        {"name": "device_idle_pct.svc1", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "maps_per_s", "workloads": ["tiny.svc1"]}])
    cell = harness.load_cell(tmp_path, bench, "tiny.svc1")
    assert cell.traffic["clients"] == 1
    assert [m["name"] for m in cell.per_layer] == ["answers.svc1",
                                                   "device_idle_pct.svc1"]
    # a suffixed name with no file of its own takes the shared reader
    assert harness.metric_reader("device_idle_pct.svc1") is \
        harness.metric_reader("device_idle_pct")
    traced = harness.run_cell(cell, 11, 1.0, True, device="cpu")["result"]
    assert traced["correct"]
    assert traced["metrics"]["answers.svc1"]["value"] >= 1
    plain = harness.run_cell(cell, 11, 1.0, False, device="cpu")["result"]
    assert set(plain["metrics"]) == {"maps_per_s", "j_rel", "setup_s"}


_REPEAT_KIND = '''
from portbench.kinds import service

Driver, judge, end_to_end = service.Driver, service.judge, service.end_to_end


class Traffic(service.Traffic):
    """Every second request repeats the one before it."""

    def structure_of(self, k):
        return super().structure_of(k - k % 2)

    def weights(self, k):
        return super().weights(k - k % 2)
'''

_PATH_STRUCTURE = '''
import numpy as np


def build(params):
    n = int(params["n"])
    return n, np.arange(n - 1), np.arange(1, n)
'''


def test_a_new_kind_and_structure_are_found_by_name(tmp_path, monkeypatch):
    """A mix of a new traffic kind over a new structure generator: new
    files only."""
    mix = json.loads((plugins.BENCH_DIR / "traffic" / "svc_closed8.json")
                     .read_text())
    mix.update(kind="svc_repeat", structures=[
        TINY_TRAFFIC["structures"][0],
        {"name": "path-64", "generator": "path", "n": 64}])
    _add_files(tmp_path, monkeypatch, {
        "kinds/svc_repeat.py": _REPEAT_KIND,
        "structures/path.py": _PATH_STRUCTURE,
        "traffic/svc_repeat.json": json.dumps(mix),
        "limits/tiny.repeat.json": (plugins.BENCH_DIR / "limits"
                                    / "tree4096.svc8.json").read_text()})
    bench = _tiny_bench(tmp_path, "tiny.repeat", "svc_repeat")
    cell = harness.load_cell(tmp_path, bench, "tiny.repeat")
    out = harness.run_cell(cell, 12, 1.0, False, device="cpu")
    assert out["result"]["correct"], out["result"]["checks"]
    assert out["traffic"].names == ["grid3d-4", "path-64"]
    reqs = out["window"].requests
    assert len(reqs) >= 2
    assert all(a.structure == b.structure and
               list(a.answer.perm) == list(b.answer.perm)
               for a, b in zip(reqs[0::2], reqs[1::2]) if b.answer)


def test_unknown_names_are_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(plugins, "ROOTS", [tmp_path])
    for folder, name in (("kinds", "service"), ("structures", "stencil")):
        with pytest.raises(FileNotFoundError):
            plugins.load(folder, name)
