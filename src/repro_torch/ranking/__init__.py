"""Query-document features, the L1 ranker (forward) and NCG."""
