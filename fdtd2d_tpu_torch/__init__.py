"""fdtd2d_tpu_torch — the PyTorch/CUDA port of fdtd2d_tpu.

Module paths mirror the JAX package (``fdtd2d_tpu``), which stays the
reference the port is tested against:

- ``core``  — Yee-grid state, scenes and materials, sources, physics guards.
- ``fdtd``  — the TE leapfrog step as torch ops and the rollout loop.
- ``fdfd``  — steady-state solves: direct, FGMRES, refinement, the adjoint.
- ``apps``  — inverse design on the differentiable FDFD solve.
- ``parallel`` — the sharded FDTD rollout over a mesh of devices.
- ``models`` — the diffusion surrogate: UNet, DDPM schedule and sampler,
              D4 augmentation, datagen with the scene-batched direct factor,
              training with checkpoints.
- ``ops``   — hand-written CUDA kernels (built with nvcc at first use) and
              their plain PyTorch versions; the FDFD operator, preconditioners,
              Krylov solver and sparse-CSR layer as torch ops.
- ``utils`` — timers and the GCells/s counter, timed with CUDA events; the
              train step's FLOP count.
- ``bench`` — the benchmark suite: bench.py's fourteen rows, headline last.
- ``viz``   — snapshot rendering, video export and diagnostic plots.

The package imports ``torch`` and numpy and never ``jax``.
"""

__version__ = "0.1.0"

from fdtd2d_tpu_torch import constants as constants
