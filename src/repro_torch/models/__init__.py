"""LM models: layers, GQA attention and the dense transformer."""
