"""jamba-v0.1-52b's sharded steps on a real mesh (Mamba, attention, MoE
and MLP layers): 4 ``gloo`` ranks spawned on the CPU
(``tests/_shard_gloo.py``), a (2, 2) ("data", "model") mesh and a
(2, 1, 2) ("pod", "data", "model") one, at its smoke width.

Per rank: two sharded train steps (microbatches 2, float32) against the
unsharded port's — each parameter and moment within max(1e-5,
``KIND_SPREAD`` × the unsharded float32 step's own error against the
same steps in float64), so the Mamba regions' partial projections and
weight gradients are held to numbers — the MoE routes equal, the sharded
prefill's logits and four sharded decode steps (tokens equal, the Mamba
states written back into their d_inner slices within 1e-5) against the
unsharded ones, a rank's matmul flops a quarter of the step's, and no
parameter that the reference keeps over "model" gathered whole, the
Mamba mixers' weights among them.

The train steps are held as rwkv6-3b's are: with d_inner split over
"model" the projections' sums over d_inner are two partial sums
all-reduced, which float32 rounds otherwise than one sum, and at these
widths the unsharded float32 step itself lies 1.1e-5 from float64 on a
layer's ``conv_b`` (an Adam update of gradients near zero)."""

import pytest

from _shard_gloo import KIND_SPREAD, MESHES, cfg_of, check_arch, spawn

ARCH = "jamba-v0.1-52b"


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_hybrid_on_four_gloo_ranks(mesh_name, tmp_path):
    cfg = cfg_of(ARCH)
    outs = spawn(tmp_path, mesh_name, (ARCH,), spread=KIND_SPREAD)
    for r, out in enumerate(outs):
        o = out[ARCH]
        print(r, o["worst"])
        check_arch(r, ARCH, o, moe=True)
        # no Mamba mixer weight is gathered whole, and the mixer's compute
        # is split like the rest
        whole = [n for names in o["whole_gathers"].values() for n in names]
        assert not [n for n in whole if n.split(".")[0] == "layers"
                    and n.split(".")[2] == "mixer"
                    and cfg.layer_kind(int(n.split(".")[1]))[0] == "mamba"], \
            o["whole_gathers"]
        assert 0.24 <= o["flops_share"] <= 0.26, (r, o["flops_share"])
