"""Applications built on the solvers (counterpart of ``fdtd2d_tpu/apps``):
gradient-based inverse design, the surrogate's readout, and the JAX repo's
example workflows (``examples/``), one module each."""
