"""PyTorch/CUDA port of the FSP compaction system (``repro``).

The same pipeline as the JAX package -- object-matrix extraction,
G.FSP/E.FSP detection over bucketed candidate sweeps, factorization
into a ``FactorizedGraph``, star queries on G' -- with the device path
on torch tensors and the TPU kernels rewritten by hand for Hopper
(``kernels/csrc``).  This package imports neither jax nor ``repro``.
"""
