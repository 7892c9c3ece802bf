"""Runners: one module per kind of configuration, named by the
configuration file's ``runner`` key."""
