"""Match environment, rules, scan backends, rollout, plans, telescope."""
