"""The rows of the port's bench (fdtd2d_tpu_torch/bench.py) at their CPU
sizes, and their scenes against bench.py's.

Each row runs as ``--device cpu`` runs it (bench.py's off-TPU sizes) and
must pass its own check; its metric is the name bench.py prints off the
TPU. The scene functions are held to bench.py's bit for bit: bench.py's
module top level imports the standard library and numpy only, and its
scene functions import the JAX package's constants and scenes. The solves
themselves are held to the JAX package by tests/test_torch_fdtd_step.py,
test_torch_direct.py, test_torch_fdfd_solver.py, test_torch_compressed.py,
test_torch_tiled.py, test_torch_timedomain.py and test_torch_datagen.py,
which this file does not repeat. The train-step rows are in
tests/test_torch_bench_train.py.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fdtd2d_tpu_torch import bench

_spec = importlib.util.spec_from_file_location(
    "jax_bench", Path(__file__).resolve().parents[1] / "bench.py")
jax_bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_bench)

# bench.py's metric names off the TPU (its sizes for on_tpu=False)
OFF_TPU_METRICS = {
    "fdtd4096": "fdtd_yee_updates_256x256_auto",
    "fdtd8192": "fdtd_yee_updates_256x256_ttiled",
    "fdfd512": "fdfd_128sq_solve",
    "fdfd512iter": "fdfd_128sq_iterative_solve",
    "direct1024": "direct_128sq_hard_contrast_warm_solve",
    "direct1024batched": "direct_128sq_batched4_warm_per_source",
    "direct2048": "direct_128sq_compressed_warm_solve",
    "tiled1024": "tiled_160sq_exact_warm_solve",
    "tiled1024approx": "tiled_160sq_refaccuracy_warm_solve",
    "timedomain4096": "timedomain_192sq_warm_solve",
    "datagen": "datagen_64sq_samples_per_s",
    "trainstep": "train_step_b8_64sq",
    "trainstepbf16": "train_step_b8_64sq_bf16",
    "fdtd2048": "fdtd_yee_updates_512x512",
}
# the keys of bench.py's line a row, beyond metric, value, unit, vs_baseline
EXTRAS = {"fdfd512": {"factor_s"}, "direct2048": {"store_gb", "rounds"},
          "timedomain4096": {"steps_per_apply", "rounds"}}
UNITS = {"fdtd": "GCells/s", "datagen": "samples/s", "trainstep": "ms"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # CPU-size rows gain little; workers share the cores
    yield
    torch.set_num_threads(n)


def test_rows_and_order_are_bench_py_s():
    """Fourteen rows, bench.py's names in bench.py's order, headline last."""
    assert [n for n, _ in bench.BENCHES] == [n for n, _ in jax_bench.BENCHES]
    assert [n for n, _ in bench.BENCHES][-1] == "fdtd2048"
    assert set(OFF_TPU_METRICS) == set(dict(bench.BENCHES))
    for name in ("FDTD_BASELINE", "FDFD512_BASELINE_S", "TILED1024_BASELINE_S",
                 "DIRECT1024_BASELINE_S", "TD4096_TRANSITS", "DIRECT2048_RANK",
                 "DIRECT2048_Q", "DATAGEN_BASELINE_SPS", "TRAINSTEP_BASELINE_MS"):
        assert getattr(bench, name) == getattr(jax_bench, name), name


@pytest.mark.parametrize("N", [128, 512])
def test_fdfd512_scene_equals_bench_py(N):
    for got, want in zip(bench._fdfd512_scene(N, 17e9), jax_bench._fdfd512_scene(N, 17e9)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("N", [160, 192, 1024])
def test_block_scene_equals_bench_py(N):
    for got, want in zip(bench._block_scene(N, contrast=1.5),
                         jax_bench._block_scene(N, contrast=1.5)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("N", [128, 1024])
def test_contrast_scene_equals_bench_py(N):
    for got, want in zip(bench._contrast_scene(N), jax_bench._contrast_scene(N)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_direct2048_scene_equals_the_jax_package_s():
    """direct2048 builds ``hard_binary_scene(N, seed=3, source_amp=10.0)``
    (bench.py:288) from the port's copy of core/scenes.py."""
    from fdtd2d_tpu.core.scenes import hard_binary_scene as jax_scene
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene

    for got, want in zip(hard_binary_scene(128, seed=3, source_amp=10.0),
                         jax_scene(128, seed=3, source_amp=10.0)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("N", [256, 512, 2048])
def test_fdtd_scene_equals_bench_py(N):
    """bench.py builds the FDTD rows' scene inline (bench.py:85-88): a float32
    4x block at rows N/4..N/2, columns N/4..N/3, and float32 mu."""
    from fdtd2d_tpu import constants

    eps = np.full((N, N), constants.EPSILON_0, np.float32)
    eps[N // 4 : N // 2, N // 4 : N // 3] *= 4.0
    mu = np.full((N, N), constants.MU_0, np.float32)
    got_eps, got_mu = bench._fdtd_scene(N)
    assert got_eps.dtype == np.float32 and np.array_equal(got_eps, eps)
    assert got_mu.dtype == np.float32 and np.array_equal(got_mu, mu)


def _block_jax(monkeypatch):
    """``jax`` and the JAX package blocked in sys.modules: an import of
    either, or of a submodule already loaded, raises."""
    for name in list(sys.modules):
        if name.split(".")[0] in ("jax", "jaxlib", "fdtd2d_tpu"):
            monkeypatch.setitem(sys.modules, name, None)
    for name in ("jax", "jaxlib", "fdtd2d_tpu"):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.mark.parametrize("name", [n for n, _ in bench.BENCHES
                                  if not n.startswith("trainstep")])
def test_row_at_cpu_size(name, monkeypatch):
    """The row's check passes (it raises otherwise); its line has bench.py's
    off-TPU metric, unit and keys, and the CPU's card. The row runs with JAX
    blocked."""
    _block_jax(monkeypatch)
    with pytest.raises(ImportError):
        import fdtd2d_tpu.core.scenes  # noqa: F401
    row = bench.run_row(name, "cpu")
    assert row["metric"] == OFF_TPU_METRICS[name]
    unit = next((u for k, u in UNITS.items() if name.startswith(k)), "s")
    assert row["unit"] == unit
    assert np.isfinite(row["value"]) and row["value"] >= 0   # rounded as bench.py rounds
    assert EXTRAS.get(name, set()) <= set(row)
    assert row["card"] == "cpu" and row["power_limit"] is None
    if name.startswith("fdtd"):
        assert row["backend"] == "torch" and row["float64_rel_err"] <= bench.FDTD_TOL
        assert row["edge_float64_rel_err"] <= bench.FDTD_TOL and row["edge_after_steps"] > 0
    if name == "fdfd512iter":
        assert 0 < row["iterations"] <= 3000 and row["c128_residual"] < 1e-4
    if name in ("direct2048", "timedomain4096"):
        assert row["vs_baseline"] is None and row["rounds"] >= 1


def test_fdtd_drift_tool_at_a_small_size(capsys):
    """tools/fdtd_drift.py, the yardstick of the FDTD rows' second window:
    one line a start and window, float32 within the bench's tolerance of
    float64 over that window at 64^2."""
    spec = importlib.util.spec_from_file_location(
        "fdtd_drift", Path(__file__).resolve().parents[1] / "tools" / "fdtd_drift.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.main(["--size", "64", "--starts", "100,600", "--windows", str(bench.FDTD_EDGE_STEPS)])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    errs = [float(line.split("float32 vs float64 ")[1].split(",")[0]) for line in lines]
    assert all(0 < e <= bench.FDTD_TOL for e in errs)
