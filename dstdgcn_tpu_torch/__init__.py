"""PyTorch/CUDA port of the DSTD-GCN motion-prediction framework.

Mirrors the module layout of :mod:`dstdgcn_tpu` (the JAX reference) so each
port module has an obvious counterpart.  Plain tensor code is PyTorch; the
DSTD-GC ops on the serving path run through hand-written CUDA kernels for
Hopper (``csrc/``, built at first use by :mod:`.kernels.build`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
