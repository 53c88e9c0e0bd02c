"""Models: the DLRM built on the embedding bag, and the dense LM."""
