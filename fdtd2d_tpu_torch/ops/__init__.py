"""Hand-written CUDA kernels (``csrc/``, built by ``_build``) and their
plain PyTorch versions; one module per kernel."""
