"""fdfd_hps_roofline: share of the HPS inner solves' roofline (hps_readers.fdfd_hps_roofline)."""

from portbench.hps_readers import fdfd_hps_roofline as read  # noqa: F401
