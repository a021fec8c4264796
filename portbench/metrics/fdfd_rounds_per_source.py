"""fdfd_rounds_per_source: refinement rounds a source (readers.rounds_per_source)."""

from portbench.readers import rounds_per_source as read  # noqa: F401
