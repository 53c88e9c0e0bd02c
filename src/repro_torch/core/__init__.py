"""The embedding bag (local and sharded over simulated ranks), jagged
batches, the cache config, the simulated mesh and the collectives."""
