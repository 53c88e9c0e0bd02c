"""PyTorch / CUDA port of the ``repro`` DLRM embedding-bag system and of
its dense-family LM serving path.

A second package beside ``repro`` (the JAX reference, which it never
imports).  Module names mirror ``repro``'s.  Entry points take
``device=None``, meaning the CUDA card, and raise when none is present;
CPU runs ask for ``device="cpu"`` and every kernel then takes its plain
PyTorch version.  The kernels are hand-written CUDA under ``csrc/``, built
with ``nvcc`` at first use (``kernels/build.py``).
"""
