"""setup_s: seconds of set-up (readers.setup_s)."""

from portbench.readers import setup_s as read  # noqa: F401
