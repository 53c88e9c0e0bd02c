"""The port's kernels: the CUDA TBE gather+pool kernel and the one-sided
row-put kernel of the remote cold tier, their plain versions, and the ops
over them."""
