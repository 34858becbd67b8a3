"""Training through the RWKV kind (rwkv6-3b's smoke config) against the
JAX package on the CPU, the decay clip's gradient and the WKV chunk's
gradients at full head size; the checks and their limits are
``tests/_train_kinds.py``'s."""

import pytest

from _train_kinds import (PLANTED, STEP_CASES, _case_id,
                          _one_torch_thread, reference)  # noqa: F401
import _train_kinds as k

KIND = ('rwkv6-3b',)

STEPS = [c for c in STEP_CASES if c[0][0] in KIND]


@pytest.mark.parametrize("reference,mb", STEPS, indirect=["reference"],
                         ids=[_case_id(c) for c in STEPS])
def test_train_step_matches_jax(reference, mb):
    k.check_train_step_matches_jax(reference, mb)


@pytest.mark.parametrize("reference", [(a, "float32") for a in KIND],
                         indirect=True, ids=list(KIND))
def test_float64_steps_match_the_references_float64_steps(reference):
    k.check_float64_steps_match_the_references_float64_steps(reference)


@pytest.mark.parametrize("arch", KIND)
def test_convert_train_state_carries_every_new_leaf(arch):
    k.check_convert_train_state_carries_every_new_leaf(arch)


@pytest.mark.parametrize("reference,leaf",
                         [((a, "float32"), PLANTED[a]) for a in KIND],
                         indirect=["reference"], ids=list(KIND))
def test_a_planted_gradient_fault_exceeds_the_limits(reference, leaf):
    k.check_a_planted_gradient_fault_exceeds_the_limits(reference, leaf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", KIND)
def test_remat_policies_give_equal_gradients_over_the_new_kinds(arch,
                                                                 dtype):
    k.check_remat_policies_give_equal_gradients_over_the_new_kinds(arch,
                                                                   dtype)


def test_clip_gradient_at_the_bounds_is_the_references():
    k.check_clip_gradient_at_the_bounds_is_the_references()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_gradients_finite_at_full_head_size(dtype):
    k.check_wkv_gradients_finite_at_full_head_size(dtype)
