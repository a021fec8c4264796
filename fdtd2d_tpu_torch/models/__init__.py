"""The diffusion surrogate: UNet, DDPM schedule and sampler, D4 augmentation,
datagen and training (counterpart of ``fdtd2d_tpu/models``)."""

from fdtd2d_tpu_torch.models.unet import UNet2D
from fdtd2d_tpu_torch.models.diffusion import (
    DDPMSchedule,
    cosine_beta_schedule,
    snr_gamma_weight,
    importance_sample_timesteps,
    loss_weight,
    sample,
)

__all__ = [
    "UNet2D",
    "DDPMSchedule",
    "cosine_beta_schedule",
    "snr_gamma_weight",
    "importance_sample_timesteps",
    "loss_weight",
    "sample",
]
