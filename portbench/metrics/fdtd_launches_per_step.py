"""fdtd_launches_per_step: device operations an FDTD step (readers.launches_per_step)."""

from portbench.readers import launches_per_step as read  # noqa: F401
