"""Import hygiene: the harness runs nothing of JAX or the JAX package,
the reference nothing of the program, and a run without a card or
without the port prints no result."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")))
def test_no_source_imports_jax_or_the_jax_package(path):
    # whole top-level names: repro_torch is the port, repro the JAX package
    assert not _top_names(BENCH / path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    p.relative_to(BENCH / "reference").as_posix()
    for p in (BENCH / "reference").rglob("*.py")))
def test_reference_imports_nothing_of_the_program(path):
    assert not _top_names(BENCH / "reference" / path) & (
        FORBIDDEN | {"repro_torch", "portbench"})


_PROBE = """
import sys
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
from portbench import control, faults, harness, reference
from tinycells import tiny_cell
cell = tiny_cell()
harness.run_cell(cell, 5, 0.5, True, device="cpu")
for m in cell.per_layer:
    harness.metric_reader(m["name"])
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_run_loads_no_jax_module():
    """Every module a (CPU, tiny) run and its metric readers load, by
    whole top-level name."""
    code = _PROBE.format(root=str(ROOT), src=str(ROOT / "src"),
                         tests=str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_no_program_module():
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]\n"
            "import portbench.reference\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    loaded = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not loaded & (FORBIDDEN | {"repro_torch"})


def _run(cwd: Path):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tree4096.svc8",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=600)


def test_without_a_card_no_result(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""


def test_without_the_port_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
