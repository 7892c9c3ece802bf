"""The port's LM train step against the JAX reference's at microbatch 2
with bfloat16 gradient accumulation on both sides, for the five LM
archs (tolerances and their reasons: ``test_torch_train_step.py``)."""
import pytest

from test_torch_train_step import (  # noqa: F401
    ARCHS, check_against_reference, one_torch_thread)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_lm_bf16_accumulated_train_step_matches_reference(arch_id):
    check_against_reference(arch_id, "mb2_bf16")
