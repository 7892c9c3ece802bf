"""The port's roofline arithmetic (``repro_torch.launch.roofline``, the
single-device half of the reference's) against the reference's.

``model_flops`` must equal the reference's exactly for every LM (arch,
shape): the same integers (parameter counts on meta tensors there,
``jax.eval_shape`` here) in the same formula.  ``roofline_terms`` and
``wire_bytes`` are the reference's formulas over the H100 SXM's
constants, not the v5e's.

Importing the reference's module sets ``XLA_FLAGS`` (512 host devices)
when unset; the backend is started first and the variable restored, so
this test changes nothing for the tests after it in the process.
"""
import os

import jax
import pytest

from repro.configs import list_archs as jax_list_archs
from repro_torch.launch import roofline

from test_torch_train_step import one_torch_thread  # noqa: F401

jax.devices()
_saved = os.environ.get("XLA_FLAGS")
from repro.launch import roofline as jroof  # noqa: E402
if _saved is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved

LM_CELLS = [(a, s) for a, arch in sorted(jax_list_archs().items())
            if arch.family == "lm" for s in arch.shapes]


@pytest.mark.parametrize("arch_id,shape", LM_CELLS)
def test_model_flops_equal_reference(arch_id, shape):
    got = roofline.model_flops(arch_id, shape)
    assert got == jroof.model_flops(arch_id, shape)
    assert got["n_active"] <= got["n_params"]


def test_model_flops_of_other_families_is_undefined():
    for arch_id, shape in (("graphsage-reddit", "ogb_products"),
                           ("wide-deep", "train_batch"),
                           ("websearch-rl", "serve_queries")):
        assert (roofline.model_flops(arch_id, shape)
                == jroof.model_flops(arch_id, shape))


def test_roofline_terms_use_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    t = roofline.roofline_terms(989e12, 3.35e12 * 2, 450e9 * 0.5)
    assert (t["compute_s"], t["memory_s"], t["collective_s"]) == (1.0, 2.0, 0.5)
    assert t["bound"] == "memory" and t["roofline_frac"] == 0.5
    assert roofline.roofline_terms(0, 0, 0)["roofline_frac"] == 0.0
    coll = {"bytes": {"all-reduce": 10.0, "all-gather": 3.0,
                      "collective-permute": 1.0}}
    assert roofline.wire_bytes(coll) == jroof.wire_bytes(coll) == 24.0
    assert roofline.COLL_MULT == jroof.COLL_MULT
    # the reference's formula, its constants swapped for the H100's
    ref = jroof.roofline_terms(197e12, 819e9, 50e9)
    assert ref["compute_s"] == 1.0 and ref["memory_s"] == 1.0
