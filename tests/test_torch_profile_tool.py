"""The trace summary of tools/profile_fdtd.py, on a synthetic Chrome trace."""

import importlib.util
import json
from pathlib import Path

import pytest

_spec = importlib.util.spec_from_file_location(
    "profile_fdtd", Path(__file__).resolve().parents[1] / "tools" / "profile_fdtd.py")
profile_fdtd = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(profile_fdtd)


@pytest.mark.parametrize("intervals, total", [
    ([], 0.0),
    ([(0.0, 2.0)], 2.0),
    ([(5.0, 6.0), (0.0, 2.0), (1.0, 3.0)], 4.0),   # overlap counts once
    ([(0.0, 10.0), (2.0, 3.0)], 10.0),             # nested
])
def test_union_us(intervals, total):
    assert profile_fdtd.union_us(intervals) == total


def test_summarize_busy_share_and_kernels(tmp_path):
    events = [
        {"cat": "kernel", "name": "a", "ts": 0.0, "dur": 30.0},
        {"cat": "kernel", "name": "b", "ts": 10.0, "dur": 30.0},   # overlaps a by 20
        {"cat": "kernel", "name": "a", "ts": 100.0, "dur": 30.0},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 200.0, "dur": 10.0},
        {"cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 500.0},
    ]
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": events}))
    s = profile_fdtd.summarize(trace, steps=2, wall_s=1e-3)
    assert s["device_busy_ms"] == pytest.approx(0.08)    # 40 + 30 + 10 us
    assert s["busy_share"] == pytest.approx(0.08)
    assert s["memcpy_memset_ms"] == pytest.approx(0.01)
    assert list(s["kernels"]) == ["a", "b"]
    assert s["kernels"]["a"] == {"calls": 2, "total_us": 60.0, "us_per_call": 30.0,
                                 "us_per_step": 30.0}


def test_summarize_refuses_a_trace_without_device_kernels(tmp_path):
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 5.0}]}))
    with pytest.raises(RuntimeError, match="no kernel"):
        profile_fdtd.summarize(trace, steps=1, wall_s=1.0)


def test_idle_gaps():
    gaps = profile_fdtd.idle_gaps([(10.0, 20.0), (0.0, 5.0), (12.0, 25.0), (40.0, 41.0)])
    assert gaps == {"count": 2, "total_us": 20.0, "longest": [[25.0, 15.0], [5.0, 5.0]]}
    assert profile_fdtd.idle_gaps([]) == {"count": 0, "total_us": 0, "longest": []}


def test_backends_option():
    """The K2 profile at 4096^2 is ``--size 4096 --backends ttiled``."""
    args = profile_fdtd.parse_args(["--size", "4096", "--backends", "ttiled,fused"])
    assert args.size == 4096 and args.backends == ["ttiled", "fused"]
    assert profile_fdtd.parse_args([]).backends == ["fused", "torch"]
    with pytest.raises(SystemExit):
        profile_fdtd.parse_args(["--backends", "pallas"])


_spec_fdfd = importlib.util.spec_from_file_location(
    "profile_fdfd", Path(__file__).resolve().parents[1] / "tools" / "profile_fdfd.py")
profile_fdfd = importlib.util.module_from_spec(_spec_fdfd)
_spec_fdfd.loader.exec_module(profile_fdfd)


def test_fdfd_window_summary_counts_launches(tmp_path, monkeypatch):
    """tools/profile_fdfd.py: one solve is one "step"; launches count every
    device kernel, and only the top kernels are kept."""
    monkeypatch.setattr(profile_fdfd, "TOP", 2)
    events = [{"cat": "kernel", "name": name, "ts": 10.0 * i, "dur": dur}
              for i, (name, dur) in enumerate([("gemv", 4.0), ("gemv", 4.0), ("add", 1.0),
                                                ("inv", 9.0), ("add", 1.0)])]
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": events}))
    s = profile_fdfd.window_summary(trace, wall_s=1e-4)
    assert s["launches"] == 5 and s["launches_per_ms"] == pytest.approx(50.0)
    assert s["kernel_names"] == 3 and list(s["kernels"]) == ["inv", "gemv"]
    assert s["kernels"]["gemv"] == {"calls": 2, "total_us": 8.0, "us_per_call": 4.0}
    assert s["busy_share"] == pytest.approx(0.19)


def test_fdfd_paths_option_and_no_card(monkeypatch, capsys):
    args = profile_fdfd.parse_args(["--size", "1024", "--paths", "fgmres"])
    assert args.size == 1024 and args.paths == ["fgmres"]
    assert profile_fdfd.parse_args([]).paths == ["factor", "direct", "fgmres"]
    with pytest.raises(SystemExit):
        profile_fdfd.parse_args(["--paths", "gmres"])
    monkeypatch.setattr(profile_fdfd.torch.cuda, "is_available", lambda: False)
    assert profile_fdfd.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
