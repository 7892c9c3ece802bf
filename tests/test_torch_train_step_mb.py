"""The port's LM train step against the JAX reference's at microbatch 2
with float32 accumulation and ``remat=True``, for the five LM archs
(tolerances and their reasons: ``test_torch_train_step.py``)."""
import pytest

from test_torch_train_step import (  # noqa: F401
    ARCHS, check_against_reference, one_torch_thread)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_lm_microbatched_remat_train_step_matches_reference(arch_id):
    check_against_reference(arch_id, "mb2_fp32_remat")
