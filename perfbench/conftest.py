"""Fixtures of the benchmark's CPU tests: cells at a reduced width (16
blocks of 256 docs, p = 256), run through the harness on the CPU with the
program's plain kernel versions."""
import pytest
import torch

from perfbench import harness


def shrink(cell, batch=8):
    """``cell`` at the reduced width: the program's own reduced sizes
    (``configs/websearch_rl.py`` ``model_cfg(reduced=True)``), ``batch``
    queries from a pool of three variants, reset in every 4th of the
    16 v bins, and training runs of 8 steps
    with the late step at 5."""
    cfg = cell.config
    cfg.update(n_blocks=16, block_docs=256, words_per_block=8, docs=4096,
               p_bins=256, u_budget=512, query_batch=batch)
    cfg["state_bins"]["u_edges_log2"] = [1, 9]
    if "reset_every_v_bin" in cfg["q_init"]:        # 16 v bins, not 100
        cfg["q_init"]["reset_every_v_bin"] = 4
    cell.traffic.update(query_pool=2 * batch, pool_stride=batch // 2)
    if "learner" in cfg:
        cfg["learner"].update(draw_steps=16, restart_every=8, replay_at=5)
    return cell


@pytest.fixture(scope="session")
def program():
    return harness.import_program()


@pytest.fixture
def small(program):
    """A factory of reduced cells: ``small(name, batch=8)``."""
    return lambda name, batch=8: shrink(harness.resolve(name), batch)


@pytest.fixture
def cpu():
    return torch.device("cpu")
