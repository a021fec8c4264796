"""fdfd_factor_s: seconds of the direct factor in set-up (readers.factor_s)."""

from portbench.readers import factor_s as read  # noqa: F401
