"""fdfd_hps_sweep_idle_share: device idle under the program's HPS sweep spans (hps_readers.fdfd_hps_sweep_idle_share)."""

from portbench.hps_readers import fdfd_hps_sweep_idle_share as read  # noqa: F401
