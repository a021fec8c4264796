"""peak_mem_gb: peak device memory in GB (readers.peak_mem_gb)."""

from portbench.readers import peak_mem_gb as read  # noqa: F401
