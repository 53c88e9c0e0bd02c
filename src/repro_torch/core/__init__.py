"""Single-device embedding bag, jagged batches, the cache config and the
remote cold tier's row fetch."""
