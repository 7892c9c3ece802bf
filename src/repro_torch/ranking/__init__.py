"""Query-document features, the L1 ranker (forward and fit), NCG and
Table 1's paired deltas."""
