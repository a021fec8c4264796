"""Applications built on the solvers (counterpart of ``fdtd2d_tpu/apps``):
gradient-based inverse design."""
