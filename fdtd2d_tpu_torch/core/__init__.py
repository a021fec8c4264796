from fdtd2d_tpu_torch.core.grid import grid_init, Scene, scene_from_numpy, state_from_numpy
from fdtd2d_tpu_torch.core.materials import material_init, image_to_permittivity
from fdtd2d_tpu_torch.core.sources import (
    ricker_amplitude, sinusoidal_amplitude, point_source, source_amplitudes,
)
from fdtd2d_tpu_torch.core.guards import check_courant, check_resolution
from fdtd2d_tpu_torch.core.geometry import RegionDrawer

__all__ = [
    "grid_init",
    "Scene",
    "scene_from_numpy",
    "state_from_numpy",
    "material_init",
    "image_to_permittivity",
    "ricker_amplitude",
    "sinusoidal_amplitude",
    "point_source",
    "source_amplitudes",
    "check_courant",
    "check_resolution",
    "RegionDrawer",
]
