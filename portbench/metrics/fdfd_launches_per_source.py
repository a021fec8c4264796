"""fdfd_launches_per_source: device operations a source (readers.launches_per_source)."""

from portbench.readers import launches_per_source as read  # noqa: F401
