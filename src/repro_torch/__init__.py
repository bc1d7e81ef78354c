"""WarpFlow on PyTorch and CUDA: the port of the JAX package ``repro``.

It mirrors ``repro``'s layout module by module, imports nothing of it (the
numpy-only host modules are copied), and runs its hot path — the fused
query wave — through hand-written Hopper kernels (``kernels/csrc``).
"""
