import numpy as np
import pytest

try:  # Property tests prefer real hypothesis; fall back to the local shim
    import hypothesis  # noqa: F401
except ModuleNotFoundError:  # offline image — install the minimal shim
    # plain module import: tests/ is on sys.path via pytest's conftest
    # rootdir insertion, which also covers bare `pytest` invocations
    from _hypothesis_shim import install as _install_hypothesis_shim

    _install_hypothesis_shim()

from repro.system import RetrievalSystem, SystemConfig
from repro.index.corpus import CorpusConfig
from repro.data.querylog import QueryLogConfig


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU with CUDA; skipped without one")


@pytest.fixture(scope="session")
def tiny_system() -> RetrievalSystem:
    """Small but fully functional retrieval system shared across tests."""
    cfg = SystemConfig(
        corpus=CorpusConfig(n_docs=2048, vocab_size=1024, seed=0),
        querylog=QueryLogConfig(n_queries=300, seed=0),
        block_docs=256,
        p_bins=256,
        u_budget=2048,
        rule_du_scale=4,
        rule_dv_scale=20,
        l1_steps=1000,      # an undertrained L1 collapses the policy
        l1_hidden=64,       # (EXPERIMENTS.md §Paper) — keep it strong
    )
    sys_ = RetrievalSystem(cfg)
    sys_.fit_l1(n_queries=96, batch=16)
    sys_.fit_state_bins(n_queries=48, batch=24)
    return sys_


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
