"""The port's kernels: the CUDA TBE gather+pool kernel, the one-sided
chunk-put kernel of the remote cold tier and the distributed embedding
bag, the flash-attention kernel of the LM prefill, their plain versions,
and the ops over them."""
