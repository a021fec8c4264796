"""fdfd_sources_s: FDFD sources solved a second (readers.sources_s)."""

from portbench.readers import sources_s as read  # noqa: F401
