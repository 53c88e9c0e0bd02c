"""Single-device embedding bag, jagged batches and the cache config."""
