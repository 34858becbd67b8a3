"""Training with the modality frontends' embeddings in the batch
(llava-next-34b's and musicgen-medium's smoke configs) against the JAX
package on the CPU; the checks and their limits are
``tests/_train_kinds.py``'s."""

import pytest

from _train_kinds import (STEP_CASES, _case_id,
                          _one_torch_thread, reference)  # noqa: F401
import _train_kinds as k

KIND = ('llava-next-34b', 'musicgen-medium')

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
