"""Match environment, rules, scan backends, rollout, plans, telescope.

The names the reference's ``repro.core`` exports, each loaded from its
submodule on first use: ``core.scan_backends`` imports the block-scan
kernels, whose plain version imports ``core.match_rules``, so an eager
import here would close that cycle.
"""
import importlib

_EXPORTS = {
    "match_rules": ("RuleSet", "default_rule_library", "scan_block",
                    "block_cost"),
    "match_plan": ("MatchPlan", "make_plan", "plan_rollout",
                   "production_plans"),
    "environment": ("EnvConfig", "EnvState", "env_reset", "env_step",
                    "execute_rule", "batched_env_step"),
    "scan_backends": ("ScanBackend", "available_backends", "get_scan_backend",
                      "register_scan_backend"),
    "state_bins": ("StateBins", "fit_bins", "bin_index"),
    "reward": ("r_agent", "step_reward"),
    "rollout": ("PolicyAction", "RolloutResult", "USE_RULE_QUOTA",
                "policy_env_step", "unified_rollout"),
    "qlearning": ("QConfig", "init_q", "td_update", "train_batch"),
    "telescope": ("l1_prune", "merge_shard_candidates"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)
