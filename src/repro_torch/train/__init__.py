"""Optimizers (``optimizer.py``) over nested trees of tensors (``tree.py``)."""
