"""The port's inverse design (fdtd2d_tpu_torch/apps/inverse_design.py)
against the JAX package's on the same scenes: the problems' fields, the
response/loss/gradient of ``make_response_fn``, ``optimize`` (Adam and
plain GD) and ``binarize``; complex128 and float64 designs on both sides."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtd2d_tpu.apps import inverse_design as jax_invdes
from fdtd2d_tpu_torch.apps import inverse_design as invdes


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carried(jp):
    """The JAX problem's fields carried across as numpy."""
    return invdes.problem_from_numpy(**{f.name: getattr(jp, f.name)
                                        for f in dataclasses.fields(jp)})


def _same(ours, theirs):
    """Every field of the port's problem equals the JAX problem's."""
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == torch.float64 and np.array_equal(a.numpy(), np.asarray(b)), f.name
        elif isinstance(a, np.ndarray):
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("make,kw", [
    ("lowpass_problem", {}),
    ("lowpass_problem", dict(N=96, n_freqs=5, band=(8e9, 16e9), tol=1e-8, maxiter=90)),
    ("decade_lowpass_problem", {}),
], ids=["lowpass250", "lowpass96", "decade848"])
def test_problems_equal_jax(make, kw):
    _same(getattr(invdes, make)(device="cpu", **kw), getattr(jax_invdes, make)(**kw))


def test_too_coarse_grid_raises():
    with pytest.raises(ValueError, match="too coarse"):
        invdes.lowpass_problem(N=40, band=(10e9, 100e9), device="cpu")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.fixture(scope="module")
def response50():
    """JAX's responses, loss, gradient and fields at N = 50, F = 3, complex128,
    at a seeded design."""
    jp = jax_invdes.lowpass_problem(N=50, n_freqs=3)
    rs, cs = jp.design_region
    design = 2.0 + 0.3 * np.random.default_rng(0).standard_normal(
        (rs.stop - rs.start, cs.stop - cs.start))
    responses, loss = jax_invdes.make_response_fn(jp, dtype=jnp.complex128)
    value, grad, xs = loss.value_and_grad(jnp.asarray(design))
    return jp, design, dict(responses=np.asarray(responses(jnp.asarray(design))),
                            value=float(value), grad=np.asarray(grad), xs=np.asarray(xs))


def test_response_loss_and_gradient_match_jax(response50):
    jp, design, ref = response50
    responses, loss = invdes.make_response_fn(_carried(jp), dtype=torch.complex128)
    d = torch.tensor(design)
    value, grad, xs = loss.value_and_grad(d)
    assert grad.dtype == torch.float64 and grad.shape == design.shape
    assert abs(float(value) - ref["value"]) <= 1e-8
    assert _rel(grad, ref["grad"]) <= 1e-6
    assert _rel(xs, ref["xs"]) <= 1e-6
    assert _rel(responses(d).detach(), ref["responses"]) <= 1e-8
    assert float(loss(d)) == pytest.approx(float(value), abs=1e-14)
    assert len(loss.info["forward_iterations"]) == len(loss.info["adjoint_iterations"]) == 3


def test_warm_start_reaches_the_same_loss(response50):
    """The fields of one call warm-start the next: the same loss and
    gradient in fewer forward iterations."""
    jp, design, ref = response50
    _, loss = invdes.make_response_fn(_carried(jp), dtype=torch.complex128)
    d = torch.tensor(design)
    _, _, xs = loss.value_and_grad(d)
    cold = list(loss.info["forward_iterations"])
    value, grad, _ = loss.value_and_grad(d, xs)
    assert all(w < c for w, c in zip(loss.info["forward_iterations"], cold))
    assert abs(float(value) - ref["value"]) <= 1e-8
    assert _rel(grad, ref["grad"]) <= 1e-6


@pytest.mark.parametrize("optimizer,opt_tol", [("adam", 1e-4), ("gd", None)])
def test_optimize_matches_jax(optimizer, opt_tol):
    """Three steps at N = 40, F = 3, complex128 from the same float64 start:
    the history and the design within 1e-6 of the JAX package's (Adam: the
    loop at opt_tol 1e-4 with warm starts, final responses at the problem's
    tol; GD: the loop at the problem's tol)."""
    jp = jax_invdes.lowpass_problem(N=40, n_freqs=3)
    kw = dict(steps=3, lr=0.05, optimizer=optimizer, opt_tol=opt_tol)
    jdesign, jresp, jhist = jax_invdes.optimize(jp, dtype=jnp.complex128, **kw)
    seen = []
    design, resp, hist = invdes.optimize(_carried(jp), dtype=torch.complex128,
                                         design0=np.full(np.asarray(jdesign).shape, 2.0),
                                         log_every=1, callback=lambda *a: seen.append(a),
                                         **kw)
    assert design.dtype == torch.float64 and not design.requires_grad
    assert np.max(np.abs(np.asarray(hist) - np.asarray(jhist))) <= 1e-6
    assert np.max(np.abs(design.numpy() - np.asarray(jdesign))) <= 1e-6
    assert _rel(resp, jresp) <= 1e-6 and resp.shape == (3,)
    assert [s for s, _, _ in seen] == [0, 1, 2] and [v for _, v, _ in seen] == hist
    assert float(design.min()) >= 1.0 and float(design.max()) <= 3.0


def test_optimize_takes_the_default_dtype_and_refuses_unknown_optimizers():
    problem = invdes.lowpass_problem(N=40, n_freqs=2, device="cpu")
    design, resp, hist = invdes.optimize(problem, steps=1, dtype=torch.complex64)
    assert design.dtype == torch.get_default_dtype() and design.shape == (16, 16)
    assert resp.dtype == torch.float32 and np.isfinite(hist[0])
    with pytest.raises(ValueError, match="unknown optimizer"):
        invdes.optimize(problem, steps=1, optimizer="lbfgs")


def test_binarize_matches_jax():
    d = np.random.default_rng(1).uniform(1.0, 3.0, (9, 7))
    d[0, 0] = 2.0  # the midpoint goes to the lower bound, as in JAX
    for clip in ((1.0, 3.0), (1.5, 2.5)):
        ours = invdes.binarize(torch.tensor(d), clip)
        assert ours.dtype == torch.float64
        assert np.array_equal(ours.numpy(), np.asarray(jax_invdes.binarize(d, clip)))
    assert invdes.binarize(torch.tensor(d, dtype=torch.float32)).dtype == torch.float32
