"""``python -m repro_torch.launch.dryrun`` on the hybrid (jamba-v0.1-52b,
one period: 7 Mamba layers and one attention, 4 MoE and 4 MLP FFNs) and
RWKV (rwkv6-3b, one layer) kinds at full width, in a subprocess.  The
traced Mamba and WKV scans run one meta op at a time (a prefill_32k cell
of jamba's period traces for ~80 s), so this file takes each step kind
of each kind once on the single-pod mesh and decode on both; the
committed ``--all`` table in PERF.md has every cell.  Rows are held as in
``tests/test_torch_dryrun.py``."""

import pytest

from _dryrun_cells import check_rows, run

CELLS = {
    # (arch, overrides, shapes, mesh)
    "rwkv-single": ("rwkv6-3b", {"n_layers": 1},
                    ("train_4k", "prefill_32k", "decode_32k"), "single"),
    "rwkv-multi": ("rwkv6-3b", {"n_layers": 1}, ("decode_32k",), "multi"),
    "hybrid-single": ("jamba-v0.1-52b", {"n_layers": 8},
                      ("train_4k", "decode_32k"), "single"),
    "hybrid-multi": ("jamba-v0.1-52b", {"n_layers": 8}, ("decode_32k",),
                     "multi"),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_hybrid_and_rwkv_cells(cell, tmp_path):
    arch, overrides, shapes, mesh = CELLS[cell]
    rows = run([arch], shapes, mesh, overrides, tmp_path)
    check_rows(rows, mesh, overrides)
