"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), their ctypes
wrappers, plain PyTorch versions (``ref``) and the fused wave composition.
Nothing is compiled at import: ``_build`` runs ``nvcc`` at first launch."""
