"""Models built on the embedding bag."""
