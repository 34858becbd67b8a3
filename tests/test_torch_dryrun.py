"""``python -m repro_torch.launch.dryrun`` on the dense and MoE layer
kinds: granite-3-2b and mixtral-8x7b at one period of layers (full
width), each step kind (train_4k, prefill_32k, decode_32k), on both
production meshes over a fake process group of 256 or 512 ranks, in a
subprocess; and long_500k on a full-attention config, skipped with the
reference's reason.  ``tests/test_torch_dryrun_kinds.py`` has the hybrid
and RWKV kinds.  Each ``ok`` row's ``arg_bytes`` and ``out_bytes`` equal
the shard sums of the JAX package's stand-ins (``_dryrun_cells``)."""

import pytest

from repro.configs import supports_shape
from repro.configs import get_config as jax_config

from _dryrun_cells import check_rows, run

ONE_LAYER = {"n_layers": 1}
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dense_and_moe_cells(mesh, tmp_path):
    rows = run(["granite-3-2b", "mixtral-8x7b"], SHAPES, mesh, ONE_LAYER,
               tmp_path)
    check_rows(rows, mesh, ONE_LAYER)
    assert {r["kind"] for r in rows.values()} == {
        "train_step", "prefill_step", "serve_step"}


def test_long_context_on_full_attention_is_skipped(tmp_path):
    out = {}
    for mesh in ("single", "multi"):
        out.update({(k, mesh): v for k, v in run(
            ["granite-3-2b"], ["long_500k"], mesh, ONE_LAYER,
            tmp_path).items()})
    _, why = supports_shape(jax_config("granite-3-2b"), "long_500k")
    for r in out.values():
        assert r["status"] == "skipped" and r["reason"] == why, r
