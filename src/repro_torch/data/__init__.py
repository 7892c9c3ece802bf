"""Synthetic query log (numpy)."""
