"""fdtd_kernel_roofline: share of the FDTD roofline (readers.fdtd_roofline)."""

from portbench.readers import fdtd_roofline as read  # noqa: F401
