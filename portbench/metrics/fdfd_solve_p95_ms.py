"""fdfd_solve_p95_ms: 95th percentile of the solve requests' times (readers.solve_p95_ms)."""

from portbench.readers import solve_p95_ms as read  # noqa: F401
