"""rwkv6-3b's sharded steps on a real mesh (RWKV time mix and channel
mix): 4 ``gloo`` ranks spawned on the CPU (``tests/_shard_gloo.py``), a
(2, 2) ("data", "model") mesh and a (2, 1, 2) ("pod", "data", "model")
one, at its smoke width.

Per rank: two sharded train steps (microbatches 2, float32) against the
unsharded port's — each parameter and moment within the limit of
``_shard_gloo.KIND_SPREAD``, so the RWKV ``local_map`` region's partial
weight gradients are held to numbers — the sharded prefill's logits and
four sharded decode steps (tokens equal, the WKV and shift states
written back within 1e-5) against the unsharded ones, and no parameter
that the reference keeps over "model" gathered whole but the named
exceptions (``_shard_gloo.KNOWN``)."""

import pytest

from _shard_gloo import KIND_SPREAD, MESHES, check_arch, spawn

ARCH = "rwkv6-3b"


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_rwkv_on_four_gloo_ranks(mesh_name, tmp_path):
    outs = spawn(tmp_path, mesh_name, (ARCH,), spread=KIND_SPREAD)
    for r, out in enumerate(outs):
        o = out[ARCH]
        print(r, o["worst"])
        check_arch(r, ARCH, o, moe=False)
