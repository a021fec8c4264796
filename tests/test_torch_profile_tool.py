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


def test_bench_ttiled_needs_the_card(capsys):
    """tools/bench_ttiled.py times the card only: without CUDA it prints why
    and returns 1, before importing any checkout."""
    spec = importlib.util.spec_from_file_location(
        "bench_ttiled", Path(__file__).resolve().parents[1] / "tools" / "bench_ttiled.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    args = bench.parse_args(["--root", "elsewhere", "--ksweep", "4,8"])
    assert args.ksweep == "4,8" and args.root == Path("elsewhere")
    assert bench.parse_args([]).root == Path(spec.origin).resolve().parents[1]
    if not bench.torch.cuda.is_available():
        assert bench.main([]) == 1
        assert "no CUDA device" in capsys.readouterr().err


def test_bench_fused_needs_the_card(capsys):
    """tools/bench_fused.py times the card only: without CUDA it prints why
    and returns 1, before importing any checkout; its defaults are the sizes
    and call lengths that simulate's "auto" rule was set from."""
    spec = importlib.util.spec_from_file_location(
        "bench_fused", Path(__file__).resolve().parents[1] / "tools" / "bench_fused.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    args = bench.parse_args([])
    assert args.steps == "5,8,200" and not args.check
    assert {"128", "200", "1034", "2048", "2304"} <= set(args.sizes.split(","))
    assert args.root == Path(spec.origin).resolve().parents[1]
    if not bench.torch.cuda.is_available():
        assert bench.main(["--check"]) == 1
        assert "no CUDA device" in capsys.readouterr().err


def test_profile_fdtd_takes_frames():
    """--frames cuts the profiled rollout into kernel calls of steps / frames
    steps, as the CLI's rollouts are."""
    args = profile_fdtd.parse_args(["--size", "200", "--steps", "1000", "--frames", "200",
                                    "--backends", "fused,ttiled"])
    assert (args.size, args.steps, args.frames) == (200, 1000, 200)
    assert args.backends == ["fused", "ttiled"]
    assert profile_fdtd.parse_args([]).frames == 0


def test_fdfd_invdes_path_takes_the_steps_optimize_takes():
    """``--paths invdes``: its options, and ``invdes_steps`` on the CPU at a
    small size (no trace): the losses of ``optimize``'s first steps, warm
    starts that cut the forward iterations, per-member iterations."""
    import torch

    from fdtd2d_tpu_torch.apps.inverse_design import lowpass_problem, optimize

    args = profile_fdfd.parse_args(["--paths", "invdes", "--freqs", "3", "--decade"])
    assert args.paths == ["invdes"] and args.freqs == 3 and args.decade and args.size is None
    problem = lowpass_problem(N=40, n_freqs=2, device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        steps = profile_fdfd.invdes_steps(problem, 2)
        _, _, history = optimize(problem, steps=2)
    finally:
        torch.set_num_threads(threads)
    assert [s["loss"] for s in steps] == history
    assert all(len(s["forward_iterations"]) == len(s["adjoint_iterations"]) == 2 for s in steps)
    assert steps[1]["forward_iterations"] <= steps[0]["forward_iterations"]
    assert steps[0]["peak_gb"] is None and "profile" not in steps[-1]


def test_bench_batched_dot_forms_agree_and_need_the_card(capsys):
    """tools/bench_batched_dot.py: its four forms of the batched complex dot
    agree on the CPU with a per-member vdot; timing needs the card."""
    import torch

    spec = importlib.util.spec_from_file_location(
        "bench_batched_dot", Path(__file__).resolve().parents[1] / "tools" / "bench_batched_dot.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert bench.shape_list("10x250,1x512") == [(10, 250), (1, 512)]
    g = torch.Generator().manual_seed(0)
    a, c = (torch.randn(3, 5, 5, dtype=torch.complex128, generator=g) for _ in range(2))
    want = torch.stack([torch.vdot(a[f].reshape(-1), c[f].reshape(-1)) for f in range(3)])
    for name, fn in bench.forms(3).items():
        assert torch.allclose(fn(a, c), want, rtol=1e-12, atol=0), name
    if not torch.cuda.is_available():
        assert bench.main([]) == 1
        assert "no CUDA device" in capsys.readouterr().err


def test_fdfd_tiled_and_timedomain_paths():
    """``--paths tiled,tiledapprox,timedomain``: bench.py's block scene of
    those rows, bit for bit; the wave step's bound at 4096^2 is 36 B a cell
    at 3.35 TB/s; the stepping helpers run a step on the CPU."""
    import importlib
    import sys

    import numpy as np
    import torch

    from fdtd2d_tpu_torch.fdfd.timedomain import build_wave_bundle

    args = profile_fdfd.parse_args(["--paths", "tiled,tiledapprox,timedomain"])
    assert args.paths == ["tiled", "tiledapprox", "timedomain"] and args.size is None
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    bench = importlib.import_module("bench")
    for want, got in zip(bench._block_scene(96, contrast=1.5), profile_fdfd.block_scene(96)):
        assert want.dtype == got.dtype and np.array_equal(want, got)
    assert profile_fdfd.WAVE_STEP_BYTES == 36
    assert profile_fdfd.WAVE_STEP_BYTES * 4096**2 / profile_fdfd.HBM_BYTES_S * 1e3 == (
        pytest.approx(0.180, abs=5e-4))
    eps, mu, _ = profile_fdfd.block_scene(32)
    bundle = build_wave_bundle(eps, mu, 1e-3, 1e-3, 17e9, pml_thickness=8, device="cpu")
    b, u, uprev, psi = profile_fdfd._wave_state(bundle)
    assert b.shape == u.shape == uprev.shape == (4, 16, 16) and b.dtype == torch.complex64
    assert not torch.equal(u, uprev) and all(not p.any() for p in psi)


def test_fdfd_compressed_and_hps_paths():
    """``--paths compressed,hps``: bench.py's direct2048 keywords at 2048^2 and
    the HPS mode's at 1024^2 by default; neither is in the default list."""
    args = profile_fdfd.parse_args(["--paths", "compressed,hps"])
    assert args.paths == ["compressed", "hps"] and args.size is None
    assert "compressed" not in profile_fdfd.DEFAULT_PATHS and "hps" not in profile_fdfd.DEFAULT_PATHS
    assert profile_fdfd.DIRECT_MODES["compressed"] == (
        dict(compressed=True, rank=20, leaf=128, power_iters=1), 2048)
    assert profile_fdfd.DIRECT_MODES["hps"] == (dict(hps=True, hps_leaf=8), 1024)

