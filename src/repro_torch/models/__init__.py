"""Models: layers, GQA attention, the dense transformer LM and the
recsys ranking models."""
