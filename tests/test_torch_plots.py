"""The port's diagnostic plots (fdtd2d_tpu_torch/viz/plots.py, a copy of the
JAX package's) write the same pixels as the JAX module's."""

import numpy as np
import scipy.sparse as sp

from fdtd2d_tpu.ops.sparse import from_scipy as jax_from_scipy
from fdtd2d_tpu.viz import plots as jax_plots
from fdtd2d_tpu_torch.ops.sparse import from_scipy
from fdtd2d_tpu_torch.viz import plots


def _pixels(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def _same_png(tmp_path, draw):
    """``draw(module, path)`` with both modules; the decoded images agree."""
    ours, theirs = tmp_path / "ours.png", tmp_path / "theirs.png"
    draw(plots, str(ours))
    draw(jax_plots, str(theirs))
    a, b = _pixels(ours), _pixels(theirs)
    assert a.shape == b.shape and a.size > 0
    assert np.array_equal(a, b)


def test_frequency_response_plot_matches_jax(tmp_path):
    omegas = np.linspace(10e9, 17e9, 6)
    measured = np.abs(np.random.default_rng(0).standard_normal(6)) + 0.1
    ideal = np.array([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
    _same_png(tmp_path, lambda m, p: m.plot_frequency_response(omegas, measured, ideal, p))


def test_convergence_plot_matches_jax(tmp_path):
    traces = {"forward": [1.0, 1e-2, 3e-5, 8e-7], "adjoint": [1.0, 5e-3, 1e-6]}
    _same_png(tmp_path, lambda m, p: m.plot_convergence(traces, p))


def test_sparsity_plot_takes_the_ports_csr(tmp_path):
    A = sp.random(30, 30, density=0.1, random_state=np.random.default_rng(1)).tocsr()
    _same_png(tmp_path, lambda m, p: m.plot_sparsity(
        from_scipy(A, device="cpu") if m is plots else jax_from_scipy(A), p))
