"""Plain references: one module per family of configurations, named by
the configuration file's ``reference`` key."""
