"""The port's sharded steps on a real mesh: 4 ``gloo`` ranks spawned on
the CPU, a (2, 2) ("data", "model") mesh and a (2, 1, 2) ("pod", "data",
"model") one, for granite-3-2b's and mixtral-8x7b's smoke widths
(``tests/_shard_gloo.py`` runs the ranks; the recurrent layer kinds are
``tests/test_torch_shard_gloo_hybrid.py``'s and
``tests/test_torch_shard_gloo_rwkv.py``'s).

Per config and rank: sharded train steps, prefill and decode against the
unsharded port within 1e-5, MoE routes equal, no parameter that the
reference keeps over "model" gathered whole (on the (2, 2) mesh the LM
head and granite's MLP ``w1``, stored over ("data", "model"), come to
each rank as its model block through an all-to-all), and a rank's matmul
flops a quarter of the step's (the smoke widths divide every axis, so
the reference replicates nothing but the router).  Then:
  * on each mesh, the backward of the layer's settle (``transformer.
    _Settled``) on a gradient placed ``Partial`` over "model": summed
    over the model group into the row layout;
  * on the pod mesh, ``cross_pod_mean`` over the pod dim, held bit for
    bit to the JAX package's ``jax.vmap(cross_pod_mean,
    axis_name="pod")`` on the same numpy gradients;
  * on the (2, 2) spawn, a checkpoint that the JAX package's
    ``CheckpointManager`` saved restored onto the (2, 2) mesh and onto a
    (4, 1) mesh of the same ranks, each leaf's ``full_tensor()`` equal to
    the saved array bit for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _shard_gloo import GRAD_SHAPES, MESHES, check_arch, spawn
from repro.checkpoint.checkpoint import CheckpointManager as JaxManager
from repro.configs import get_smoke_config as jax_smoke_config
from repro.train import compression as jcomp
from repro.train.steps import init_train_state as jax_init_train_state

TRAIN_ARCHS = ("granite-3-2b", "mixtral-8x7b")


def _reference_inputs(tmp):
    """The JAX package's side, made before the ranks start: per-pod numpy
    gradients and error buffers, the reference's compressed mean over a
    vmapped pod axis, and a checkpoint saved by the reference."""
    rng = np.random.default_rng(11)

    def draw(shape_tree, prefix, out):
        for k, v in shape_tree.items():
            if isinstance(v, dict):
                draw(v, f"{prefix}{k}.", out)
            else:
                out[prefix + k] = rng.standard_normal(
                    (2,) + v).astype(np.float32)
    arrays = {}
    draw(GRAD_SHAPES, "g.", arrays)
    draw(GRAD_SHAPES, "e.", arrays)
    arrays = {k: (v * 1e-3 if k.startswith("e.") else v)
              for k, v in arrays.items()}
    np.savez(os.path.join(tmp, "grads.npz"), **arrays)

    def tree(prefix):
        return {"a": jnp.asarray(arrays[f"{prefix}a"]),
                "b": {"c": jnp.asarray(arrays[f"{prefix}b.c"]),
                      "d": jnp.asarray(arrays[f"{prefix}b.d"])}}
    mean, err = jax.vmap(jcomp.cross_pod_mean, axis_name="pod")(
        tree("g."), tree("e."))
    ref = {"a": np.asarray(mean["a"]), "b.c": np.asarray(mean["b"]["c"]),
           "b.d": np.asarray(mean["b"]["d"]), "err.a": np.asarray(err["a"])}
    cfg = dataclasses.replace(jax_smoke_config("granite-3-2b"),
                              dtype="float32")
    state = jax_init_train_state(jax.random.PRNGKey(4), cfg)
    JaxManager(os.path.join(tmp, "ckpt")).save(7, state,
                                               mesh_shape=(1, 1))
    return ref


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_steps_on_four_gloo_ranks(mesh_name, tmp_path):
    ref = _reference_inputs(str(tmp_path))
    outs = spawn(tmp_path, mesh_name, TRAIN_ARCHS, extras=True)
    for r, out in enumerate(outs):
        for arch in TRAIN_ARCHS:
            o = out[arch]
            check_arch(r, arch, o, moe=arch == "mixtral-8x7b")
            # a rank's local matmul flops: a quarter of the step's
            assert 0.24 <= o["flops_share"] <= 0.26, (r, arch,
                                                      o["flops_share"])
            # the LM head and granite's w1 and w3 are stored over ("data",
            # "model"): never gathered whole, each rank's model block
            # assembled by an all-gather over "data" and an all-to-all
            # over "model" where the data dim is real
            whole = [n for names in o["whole_gathers"].values()
                     for n in names]
            assert "embeddings.lm_head" not in whole, o["whole_gathers"]
            assert "layers.0.ffn.w1" not in whole, o["whole_gathers"]
            if arch == "granite-3-2b":
                a2a = [any("all_to_all" in k for k in c) for c in o["comm"]]
                assert (all(a2a) if mesh_name == "single"
                        else not any(a2a)), o["comm"]
    for r, out in enumerate(outs):
        # the settle's backward all-reduces a gradient that arrives
        # partial over "model" (the Mamba projection's) and passes one in
        # the row layout as it is
        s = out["settled"]
        assert s["placements"] and s["err"] == 0.0 and s["passed_as_is"], \
            (r, s)
    if mesh_name == "multi":
        port = np.load(tmp_path / "port_mean.npz")
        for k, want in ref.items():          # rank 0 is pod 0
            got = port[k]
            assert got.dtype == want.dtype and np.array_equal(got, want[0]), k
    else:
        for out in outs:
            assert [x[0] for x in out["restore"]] == [[2, 2], [4, 1]]
            for shape, same, sharded, n in out["restore"]:
                assert same and 0 < sharded < n, (shape, sharded, n)
