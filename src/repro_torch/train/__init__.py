"""Optimizers (AdamW, as the L1 ranker's fit uses it)."""
