"""Hand-written CUDA kernels (``csrc/``, built by ``_build``) and their
plain PyTorch versions, one module per kernel; and the FDFD building blocks
as torch ops (``helmholtz``, ``fdm``, ``dst``, ``krylov``, ``sparse``)."""
