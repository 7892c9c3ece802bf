"""Synthetic query log, its query classifier and eval-set sampler (numpy)."""
