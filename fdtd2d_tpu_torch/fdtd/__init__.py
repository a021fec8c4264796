from fdtd2d_tpu_torch.fdtd.step import (
    fdtd_step, fdtd_step_padded, mur_coefficient, precompute_coefficients,
)
from fdtd2d_tpu_torch.fdtd.simulate import simulate, FDTDConfig, resolve_backend

__all__ = [
    "fdtd_step",
    "fdtd_step_padded",
    "mur_coefficient",
    "precompute_coefficients",
    "simulate",
    "FDTDConfig",
    "resolve_backend",
]
