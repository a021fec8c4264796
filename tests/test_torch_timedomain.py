"""The port's frequency-locked time-domain solver
(fdtd2d_tpu_torch/fdfd/timedomain.py) against the JAX package's
``fdfd/timedomain.py`` on the same inputs, and its refined solve against
scipy's ``spsolve`` of the reference's assembled matrix (the cases of
tests/test_timedomain.py)."""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from fdtd2d_tpu import constants
from fdtd2d_tpu.fdfd import timedomain as jtd
from fdtd2d_tpu_torch.fdfd import timedomain as td
from fdtd2d_tpu_torch.fdfd.direct import merge_sublattices, split_sublattices

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_fdfd_operator import scipy_make_A  # noqa: E402

DX = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(Nx, Ny=None, contrast=1.5, dense=False):
    """tests/test_timedomain.py's scene; ``dense``: a mu perturbed below
    float32 resolution, which forces the dense layout."""
    Ny = Nx if Ny is None else Ny
    eps = np.full((Nx, Ny), constants.EPSILON_0)
    eps[Nx // 3 : 2 * Nx // 3, Ny // 4 : Ny // 2] *= contrast
    mu = np.full((Nx, Ny), constants.MU_0)
    if dense:
        mu[0, 0] *= 1.0 + 1e-13
    src = np.zeros((Nx, Ny), np.complex128)
    src[Nx // 2, Ny // 2] = 1.0
    return eps, mu, src


def _fields(b):
    return {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _c64(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


# (Nx, Ny, omega, pml): square, non-square, and a grid so small that the strips
# are clamped (t = N // 4), the windows of both ends join and the band sponge
# reaches past the strips
SHAPES = [(64, 64, 30e9, 12), (48, 40, 30e9, 10), (12, 12, 60e9, 8)]


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_build_wave_bundle_equals_jax(shape, dense):
    """The host-built fields bit for bit (values and dtypes), and the static
    fields (t, n_main, n_avg, n_ramp, the layout) equal."""
    Nx, Ny, omega, pml = shape
    eps, mu, _ = _scene(Nx, Ny, dense=dense)
    kw = dict(pml_thickness=pml, transits=3.0)
    want = _fields(jtd.build_wave_bundle(eps, mu, DX, DX, omega, **kw))
    got = _fields(td.build_wave_bundle(eps, mu, DX, DX, omega, device="cpu", **kw))
    assert got.keys() == want.keys() and got["dense"] is dense
    for name, a in got.items():
        if isinstance(a, torch.Tensor):
            b = np.asarray(want[name])
            assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b), name
        else:
            assert a == want[name], name


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_one_step_matches_jax(shape, dense):
    """One driven leapfrog step (and the filter state it leaves) from a
    seeded random state and filter state, through both packages on one
    bundle: <= 1e-6 relative. The step writes u[k+1] into u[k-1]'s buffer."""
    Nx, Ny, omega, pml = shape
    eps, mu, _ = _scene(Nx, Ny, dense=dense)
    jb = jtd.build_wave_bundle(eps, mu, DX, DX, omega, pml_thickness=pml, transits=3.0)
    tb = td.wave_bundle_from_numpy(**_fields(jb))
    rng = np.random.default_rng(Nx)
    nr, nc, t = Nx // 2, Ny // 2, jb.t
    u, uprev, b = (_c64(rng, 4, nr, nc) for _ in range(3))
    psi = tuple(_c64(rng, *s) for s in [(4, nr, 2 * t), (4, 2 * t, nc)] * 3)
    for k in (0, 7, jb.n_main + 1):
        jn, ju, jpsi = jtd._step(jb, jnp.asarray(b), jnp.asarray(u), jnp.asarray(uprev),
                                 tuple(map(jnp.asarray, psi)), jnp.asarray(k))
        tprev = torch.tensor(uprev)
        tn, tu, tpsi = td._step(tb, torch.tensor(b), torch.tensor(u), tprev,
                                tuple(map(torch.tensor, psi)), k)
        assert tn is tprev
        assert _rel(tn, jn) <= 1e-6 and np.array_equal(tu.numpy(), u)
        for a, c in zip(tpsi, jpsi):
            assert _rel(a, c) <= 1e-6


def test_phase_tables_match_jax_float32():
    """The drive's phase x ramp and the phasor-average weights of every step:
    JAX's float32 expressions (theta * k rounded to float32 first)."""
    eps, mu, _ = _scene(64)
    jb = jtd.build_wave_bundle(eps, mu, DX, DX, 30e9, pml_thickness=12, transits=3.0)
    plan = td.wave_bundle_from_numpy(**_fields(jb)).plan
    theta, n_ramp = jb.theta, jnp.float32(jb.n_ramp)
    kf = jnp.arange(jb.n_main + jb.n_avg).astype(jnp.float32)
    ramp = jnp.sin(0.5 * jnp.pi * jnp.minimum(kf, n_ramp) / n_ramp) ** 2
    ph = (jnp.cos(theta * kf) - 1j * jnp.sin(theta * kf)).astype(jnp.complex64) * ramp
    kf = (jnp.arange(jb.n_main, jb.n_main + jb.n_avg) + 1).astype(jnp.float32)
    ph_avg = (jnp.cos(theta * kf) + 1j * jnp.sin(theta * kf)).astype(jnp.complex64)
    assert plan.ph.dtype == plan.ph_avg.dtype == torch.complex64
    assert np.abs(plan.ph.numpy() - np.asarray(ph)).max() <= 1e-6
    assert np.abs(plan.ph_avg.numpy() - np.asarray(ph_avg)).max() <= 1e-6


@pytest.mark.parametrize("dense", [False, True])
def test_wave_run_matches_jax(dense):
    """One wave run (a few hundred complex64 steps and the phasor average)
    on one bundle through both packages: <= 1e-4 relative."""
    eps, mu, src = _scene(64, dense=dense)
    jb = jtd.build_wave_bundle(eps, mu, DX, DX, 30e9, pml_thickness=12, transits=3.0)
    assert jb.n_main + jb.n_avg > 250
    b = (-1j * src).astype(np.complex64)
    b_sub = np.stack(split_sublattices(b))
    b_sub = b_sub + 1e-2 * _c64(np.random.default_rng(2), *b_sub.shape)
    want = jtd.wave_run(jb, jnp.asarray(b_sub))
    got = td.wave_run(td.wave_bundle_from_numpy(**_fields(jb)), torch.tensor(b_sub))
    assert _rel(got, want) <= 1e-4


def test_solve_matches_spsolve():
    """The refined solve against scipy's sparse LU of the reference's
    assembled matrix (tests/test_timedomain.py::test_solve_matches_spsolve):
    the iterate's true residual <= 1e-8, the field within 1e-5."""
    N, omega, pml = 96, 30e9, 16
    eps, mu, src = _scene(N)
    s = td.TimeDomainSolver(eps, mu, DX, DX, omega, pml_thickness=pml, transits=4.0,
                            device="cpu")
    x, trace = s.solve(src, refine_target=1e-8)
    assert trace[-2] <= 1e-8, f"refine trace: {trace}"
    assert s.steps_per_apply == s.bundle.n_main + s.bundle.n_avg
    A = scipy_make_A(eps, mu, DX, DX, N, N, float(omega), pml_thickness=pml)
    want = spla.spsolve(A.tocsc(), (-1j * omega * src).ravel()).reshape(N, N)
    assert x.dtype == torch.complex64 and _rel(x, want) <= 1e-5


def test_dense_and_separable_paths_agree():
    """The dense (general-mu) layout reproduces the separable (constant-mu)
    one when mu is uniform below float32 resolution: <= 1e-4."""
    N, omega, pml = 64, 30e9, 12
    eps, mu, src = _scene(N)
    b = torch.tensor(-1j * omega * src, dtype=torch.complex64)
    bs = torch.stack(split_sublattices(b / torch.linalg.vector_norm(b)))
    sep = td.build_wave_bundle(eps, mu, DX, DX, omega, pml_thickness=pml, transits=3.0,
                               device="cpu")
    den = td.build_wave_bundle(eps, _scene(N, dense=True)[1], DX, DX, omega,
                               pml_thickness=pml, transits=3.0, device="cpu")
    assert not sep.dense and den.dense
    assert _rel(td.wave_run(den, bs), td.wave_run(sep, bs)) <= 1e-4
    assert torch.equal(merge_sublattices(bs, torch.zeros_like(b)), b / torch.linalg.vector_norm(b))


def test_solver_warns_on_stall():
    """An undersized settling budget warns, not silently returns."""
    N, omega, pml = 64, 30e9, 12
    eps, mu, src = _scene(N)
    s = td.TimeDomainSolver(eps, mu, DX, DX, omega, pml_thickness=pml, steps_override=8,
                            device="cpu")
    with pytest.warns(RuntimeWarning, match="time-domain solve stalled"):
        x, trace = s.solve(src, refine_target=1e-10, max_refine_rounds=3)
    assert bool(torch.isfinite(x).all()) and trace[-2] > 1e-10


def test_odd_grid_is_refused():
    eps, mu, _ = _scene(63)
    with pytest.raises(ValueError, match="even grid"):
        td.build_wave_bundle(eps, mu, DX, DX, 30e9, device="cpu")


@pytest.mark.parametrize("N, omega, transits", [
    (192, 30e9, 4.0),   # bench.py's timedomain4096 off the TPU (4 rounds)
    (128, 17e9, 2.5),   # bench.py's frequency and transits on the TPU (9 rounds)
])
def test_refinement_trace_matches_jax(N, omega, transits):
    """Both packages' ``TimeDomainSolver.solve(refine_target=1e-6)`` on the
    same scene (bench.py's 1.5x block): the same number of rounds, and each
    round's contraction within 10% of JAX's."""
    eps, mu, src = _scene(N)
    src = src.real
    kw = dict(transits=transits)
    _, want = jtd.TimeDomainSolver(eps, mu, DX, DX, omega, **kw).solve(src,
                                                                      refine_target=1e-6)
    _, got = td.TimeDomainSolver(eps, mu, DX, DX, omega, device="cpu", **kw).solve(
        src, refine_target=1e-6)
    want, got = np.asarray(want[:-1], np.float64), np.asarray(got[:-1], np.float64)
    assert len(got) == len(want) >= 4, (got, want)
    contraction, want_contraction = got[1:] / got[:-1], want[1:] / want[:-1]
    assert np.all(np.abs(contraction / want_contraction - 1) <= 0.1), (got, want)
