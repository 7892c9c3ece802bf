"""Serving: the sharded rollout executor."""
