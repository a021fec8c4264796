"""invdes_factor_roofline: share of the HPS factor's roofline (invdes_readers.invdes_factor_roofline)."""

from portbench.invdes_readers import invdes_factor_roofline as read  # noqa: F401
