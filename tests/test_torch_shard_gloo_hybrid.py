"""jamba-v0.1-52b's sharded steps on a real mesh (Mamba, attention, MoE
and MLP layers): 4 ``gloo`` ranks spawned on the CPU
(``tests/_shard_gloo.py``), a (2, 2) ("data", "model") mesh and a
(2, 1, 2) ("pod", "data", "model") one, at its smoke width.

Per rank: two sharded train steps (microbatches 2, float32) against the
unsharded port's — each parameter and moment within 1e-5, so the Mamba
``local_map`` region's partial weight gradients are held to numbers — the MoE routes equal, the sharded
prefill's logits and four sharded decode steps (tokens equal, the Mamba
states written back within 1e-5) against the unsharded ones, and no
parameter that the reference keeps over "model" gathered whole but the
named exceptions (``_shard_gloo.KNOWN``), the Mamba mixers' weights
(item 11) among them."""

import pytest

from _shard_gloo import MESHES, check_arch, spawn

ARCH = "jamba-v0.1-52b"


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_hybrid_on_four_gloo_ranks(mesh_name, tmp_path):
    outs = spawn(tmp_path, mesh_name, (ARCH,))
    for r, out in enumerate(outs):
        o = out[ARCH]
        print(r, o["worst"])
        check_arch(r, ARCH, o, moe=True)
        assert "layers.0.mixer.w_out" in o["whole_gathers"].get(
            "item 11", []), o["whole_gathers"]
