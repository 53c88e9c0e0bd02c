"""Embedding-bag kernels: the CUDA TBE gather+pool kernel, its plain
versions, and the ops over them."""
