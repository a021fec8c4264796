"""fdtd_gcells_s: FDTD cell updates a second, in billions (readers.gcells_s)."""

from portbench.readers import gcells_s as read  # noqa: F401
