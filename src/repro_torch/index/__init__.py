"""Host data layer: corpus, bitpacked blocks, inverted index (numpy)."""
