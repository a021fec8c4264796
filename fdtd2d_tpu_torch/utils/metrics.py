"""Timers and the GCells/s counter, timed on the card.

Counterpart of ``fdtd2d_tpu/utils/metrics.py``:

- :class:`Timer` — wall-clock seconds; synchronizes a CUDA device on entry
  and exit so the time covers the device work queued inside.
- :func:`throughput_gcells` — GCell-updates/s timed with CUDA events after a
  warm-up. A device rate is never taken on the host: without CUDA it raises.
- :func:`device_info` — the card's name and power limit from nvidia-smi, to
  be written beside every number measured on it.
- :func:`trace_profile` — a ``torch.profiler`` trace of the enclosed block,
  written as a Chrome trace (the JAX module's ``jax.profiler`` trace).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Callable

import torch


class Timer:
    """``with Timer(device) as t: ...``; ``t.seconds`` afterwards."""

    def __init__(self, device="cuda"):
        self._device = torch.device(device)
        self.seconds = 0.0

    def _sync(self):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.seconds = time.perf_counter() - self._t0
        return False


def throughput_gcells(cells: int, steps: int, fn: Callable, *,
                      repeats: int = 3, warmup: int = 1) -> float:
    """Best-of-``repeats`` GCell-updates/s of ``fn()`` advancing ``steps``
    steps of a ``cells``-cell grid on the current CUDA device and stream,
    timed with CUDA events after ``warmup`` untimed calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("throughput_gcells times the card with CUDA events; "
                           "no CUDA device is available")
    for _ in range(warmup):
        fn()
    best = 0.0
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
        best = max(best, cells * steps / seconds / 1e9)
    return best


def device_info() -> dict:
    """``{"name", "power_limit", "nvidia_smi"}`` of the first card, from
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (``nvidia_smi`` is its whole output, one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, limit = (part.strip() for part in out.splitlines()[0].rsplit(",", 1))
    return {"name": name, "power_limit": limit, "nvidia_smi": out}


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """Trace the enclosed block with ``torch.profiler`` (the CPU, and the
    card's kernels where CUDA is available) and write it as a Chrome trace,
    ``trace.json`` under ``log_dir`` (made if missing). Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
