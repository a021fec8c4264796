"""invdes_factor_share: the HPS factor's share of the device's busy time (invdes_readers.invdes_factor_share)."""

from portbench.invdes_readers import invdes_factor_share as read  # noqa: F401
