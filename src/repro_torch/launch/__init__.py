"""Command-line entry points of the port (training so far)."""
