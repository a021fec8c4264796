"""The port's tiled Schwarz solver (fdtd2d_tpu_torch/fdfd/tiled.py) and the
patch axis of its operator and FDM preconditioner against the JAX package's
``fdfd/tiled.py`` on the same inputs (the shapes of tests/test_tiled.py:
160^2, patches of 64 with padding 24, local PML 10, 9 patches), and the
unbatched and omega-stacked operator held bit for bit to the code before
the patch axis."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fdtd2d_tpu import constants
from fdtd2d_tpu.fdfd import tiled as jt
from fdtd2d_tpu.ops.fdm import fdm_preconditioner as jax_fdm
from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
from fdtd2d_tpu_torch.fdfd import tiled as tt
from fdtd2d_tpu_torch.ops.fdm import (FDMPreconditioner, fdm_preconditioner,
                                      fdm_preconditioner_for, stack_preconditioners)
from fdtd2d_tpu_torch.ops.helmholtz import make_operator, operator_from_numpy, stack_operators

N, DX, OMEGA = 160, 1e-3, 17e9
PATCH, PAD, PML = 64, 24, 10
W = PATCH + 2 * PAD
C64, C128 = torch.complex64, torch.complex128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    """tests/test_tiled.py's scene: a 2.5x block, a point source of 10."""
    eps = np.full((N, N), constants.EPSILON_0)
    eps[60:100, 40:70] *= 2.5
    mu = np.full((N, N), constants.MU_0)
    source = np.zeros((N, N))
    source[N // 2, N // 2] = 10.0
    return eps, mu, source


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _field(shape, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("n,patch,pad", [(160, 64, 24), (160, 64, 16), (200, 50, 20)])
def test_host_helpers_equal_jax(n, patch, pad):
    """generate_patches, bfs_order, pou_weights, patch_flat_indices,
    _ring_mask and RING_WIDTH: the JAX module's, bit for bit."""
    w = patch + 2 * pad
    origins = tt.generate_patches(n, n, patch, pad)
    assert np.array_equal(origins, jt.generate_patches(n, n, patch, pad))
    src = np.zeros((n, n))
    src[n // 3, 2 * n // 3] = 1.0
    for halo in (8, 10):
        assert np.array_equal(tt.bfs_order(origins, w, src, halo),
                              jt.bfs_order(origins, w, src, halo))
        assert np.array_equal(tt._ring_mask(w, halo), jt._ring_mask(w, halo))
    assert np.array_equal(tt.pou_weights(origins, w, n, n, PML, pad),
                          jt.pou_weights(origins, w, n, n, PML, pad))
    assert np.array_equal(tt.patch_flat_indices(origins, w, n),
                          jt.patch_flat_indices(origins, w, n))
    assert tt.RING_WIDTH == jt.RING_WIDTH


@pytest.mark.parametrize("dtype", [C64, C128])
def test_patch_stacked_apply_matches_jax_vmap(dtype):
    """stack_patch_operators' apply and diagonal on a (P, W, W) batch against
    the JAX stack under ``vmap``; ``operator_from_numpy`` of the JAX stack
    is the port's stack, field for field."""
    eps, mu, _ = _scene()
    jdtype = jnp.complex128 if dtype == C128 else jnp.complex64
    origins = tt.generate_patches(N, N, PATCH, PAD)
    jops = jt.stack_patch_operators(eps, mu, origins, W, DX, DX, OMEGA, PML, jdtype)
    ops = tt.stack_patch_operators(eps, mu, origins, W, DX, DX, OMEGA, PML, dtype, device="cpu")
    assert ops.batch_shape == (len(origins),) and ops.shape == (W, W)
    names = ("eps", "inv_mu", "inv_s_row", "inv_s_col", "omega", "inv_2dx", "inv_2dy")
    got = operator_from_numpy(*(np.asarray(getattr(jops, n)) for n in names),
                              pml_thickness=PML, sigma_max=2.0, m=3)
    for n in names:
        a, b = getattr(got, n), getattr(ops, n)
        assert a.dtype == b.dtype and torch.equal(a, b), n
    x = _field((len(origins), W, W))
    want = jax.vmap(lambda op, v: op.apply(v))(jops, jnp.asarray(x, jdtype))
    bound = 1e-12 if dtype == C128 else 1e-6
    assert _rel(ops.apply(torch.tensor(x).to(dtype)), want) <= bound
    assert _rel(ops.diagonal(), jax.vmap(lambda op: op.diagonal())(jops)) <= bound


def test_shared_fdm_on_a_patch_batch_matches_jax_vmap():
    """One unstacked FDM preconditioner applied to a (P, W, W) batch (batched
    matmuls) against the JAX preconditioner under ``vmap``, and against its
    own apply patch by patch."""
    eps, mu, _ = _scene()
    kw = dict(eps_ref=float(np.mean(eps)), mu_ref=1.0 / float(np.mean(1.0 / mu)))
    M = fdm_preconditioner(W, W, DX, DX, OMEGA, PML, dtype=C64, device="cpu", **kw)
    jM = jax_fdm(W, W, DX, DX, OMEGA, PML, dtype=jnp.complex64, **kw)
    x = torch.tensor(_field((9, W, W))).to(C64)
    got = M(x)
    assert got.shape == x.shape
    assert _rel(got, jax.vmap(jM)(jnp.asarray(x.numpy()))) <= 1e-6
    assert max(_rel(got[p], M(x[p])) for p in range(9)) <= 1e-6


def _parent_apply(op, x):
    """ops/helmholtz.py's apply before the patch axis, verbatim."""
    w2 = op.omega**2
    if w2.ndim:
        w2 = w2[:, None, None]
    isc, isr = op.inv_s_col[..., None, :], op.inv_s_row[..., :, None]

    def dcol(f, inv2d):
        return (F.pad(f[..., 1:], (0, 1)) - F.pad(f[..., :-1], (1, 0))) * inv2d

    def drow(f, inv2d):
        return (F.pad(f[..., 1:, :], (0, 0, 0, 1)) - F.pad(f[..., :-1, :], (0, 0, 1, 0))) * inv2d

    tc = dcol(x * isc, op.inv_2dx)
    tc = dcol(tc * op.inv_mu, op.inv_2dx) * isc
    tr = drow(x * isr, op.inv_2dy)
    tr = drow(tr * op.inv_mu, op.inv_2dy) * isr
    return -(tc + tr) - w2 * op.eps * x


def _parent_diagonal(op):
    w2 = op.omega**2
    if w2.ndim:
        w2 = w2[:, None, None]
    isc, isr = op.inv_s_col[..., None, :], op.inv_s_row[..., :, None]
    im = op.inv_mu
    im_cm = F.pad(im[:, :-1], (1, 0))
    im_cp = F.pad(im[:, 1:], (0, 1))
    im_rm = F.pad(im[:-1, :], (0, 0, 1, 0))
    im_rp = F.pad(im[1:, :], (0, 0, 0, 1))
    return ((isc**2) * op.inv_2dx**2 * (im_cm + im_cp)
            + (isr**2) * op.inv_2dy**2 * (im_rm + im_rp) - w2 * op.eps)


def _parent_fdm(M, r):
    R = r.reshape(M.D.shape).to(M.Pr.dtype)
    return (M.Pr @ ((M.Pri @ R @ M.PcTi) * M.D) @ M.PcT).reshape(r.shape)


@pytest.mark.parametrize("dtype", [C64, C128])
def test_unbatched_and_omega_stacked_unchanged_by_the_patch_axis(dtype):
    """The unbatched and omega-stacked operators (apply, diagonal) and FDM
    preconditioners give, bit for bit, what the code before the patch axis
    gives on the same inputs."""
    n = 36
    rng = np.random.default_rng(3)
    eps = constants.EPSILON_0 * (1.0 + 2.0 * rng.random((n, n - 4)))
    mu = constants.MU_0 * (1.0 + rng.random((n, n - 4)))
    ops = [make_operator(eps, mu, DX, 1.1 * DX, om, pml_thickness=6, dtype=dtype,
                         device="cpu") for om in (12e9, 17e9)]
    stacked = stack_operators(ops)
    Ms = [fdm_preconditioner_for(op) for op in ops]
    # the third case: leading batch dims through the unbatched apply
    for op, M, x in ((ops[0], Ms[0], _field((n, n - 4))),
                     (stacked, stack_preconditioners(Ms), _field((2, n, n - 4))),
                     (ops[1], None, _field((3, n, n - 4)))):
        x = torch.tensor(x).to(dtype)
        assert torch.equal(op.apply(x), _parent_apply(op, x))
        assert torch.equal(op.diagonal(), _parent_diagonal(op))
        if M is not None:
            assert torch.equal(M(x), _parent_fdm(M, x))
    assert isinstance(fdm_preconditioner_for(stacked), FDMPreconditioner)
    assert fdm_preconditioner_for(stacked).D.shape == (2, n, n - 4)


def _probe_scene(name):
    """The block scene (the probe drops the patch level) and a 10x binary
    medium at 25 GHz (it keeps it)."""
    if name == "block":
        eps, mu, source = _scene()
        return eps, mu, source, OMEGA
    eps, mu, _ = hard_binary_scene(N, seed=7, contrast=10.0)
    return eps, mu, _scene()[2], 25e9


@pytest.mark.parametrize("name,decision", [("block", False), ("binary", True)])
def test_oras_apply_and_probe_match_jax(name, decision):
    """One ORAS patch correction of a random residual, and the probe's
    contractions and decision, against the JAX package's."""
    eps, mu, source, omega = _probe_scene(name)
    kw = dict(patch_size=PATCH, padding=PAD, pml_thickness=PML)
    js = jt.TiledSolver(eps, mu, DX, DX, omega, **kw)
    ts = tt.TiledSolver(eps, mu, DX, DX, omega, device="cpu", **kw)
    r2 = _field((N, N), seed=4).astype(np.complex64)
    want = jax.jit(jt._oras_apply, static_argnames=("W", "inner", "real"))(
        jnp.asarray(r2), js.gop, js.ops_stacked, js.M, js.weights, js.flat_idx,
        js.origins_dev, W=W, inner=js.inner_iters, real=jnp.float32)
    got = tt._oras_apply(torch.tensor(r2), ts.gop, ts.ops_stacked, ts.M, ts.weights,
                         ts.flat_idx, W=W, inner=ts.inner_iters)
    assert _rel(got, want) <= 1e-4
    b = (-1j * omega * source).astype(np.complex64)
    assert js._probe_use_patches(jnp.asarray(b)) == decision
    assert ts._probe_use_patches(torch.tensor(b)) == decision
    assert np.allclose(ts._patch_probe, js._patch_probe, rtol=0, atol=1e-4), (
        ts._patch_probe, js._patch_probe)


@pytest.fixture(scope="module")
def jax_solves():
    """The JAX TiledSolver's refined solve of tests/test_tiled.py's scene
    (outer restart 10), adaptive and forced two-level, each with the outer
    FGMRES iterations of its first refinement round."""
    eps, mu, source = _scene()
    out = {}
    for adaptive in (True, False):
        js = jt.TiledSolver(eps, mu, DX, DX, OMEGA, patch_size=PATCH, padding=PAD,
                            pml_thickness=PML, outer_restart=10)
        x, trace = js.solve(source, solver_tol=1e-5, solver_maxiter=60, refine_target=1e-7,
                            adaptive=adaptive)
        b = -1j * OMEGA * source
        first = jt._solve_global_two_level(
            jnp.asarray((b / np.linalg.norm(b)).astype(np.complex64)), js.gop,
            js.ops_stacked, js.M, js.Mg, js.weights, js.flat_idx, js.origins_dev, W=W,
            maxiter=60, tol=1e-5, inner=js.inner_iters, restart=10,
            use_patches=js._patch_decision if adaptive else True)
        out[adaptive] = (np.asarray(x), trace, int(first.iterations))
    return out


@pytest.mark.parametrize("adaptive", [True, False])
def test_tiled_solver_refined_matches_jax(jax_solves, adaptive):
    """TiledSolver.solve with complex128 refinement to 1e-7: the iterate's
    true residual below the target, the returned field within 1e-5 of the
    JAX package's, and the first round's outer FGMRES iterations EQUAL to
    JAX's (whole restart cycles of 10)."""
    eps, mu, source = _scene()
    want, jtrace, j_iters = jax_solves[adaptive]
    ts = tt.TiledSolver(eps, mu, DX, DX, OMEGA, patch_size=PATCH, padding=PAD,
                        pml_thickness=PML, outer_restart=10, device="cpu")
    x, trace = ts.solve(source, solver_tol=1e-5, solver_maxiter=60, refine_target=1e-7,
                        adaptive=adaptive)
    assert trace[-2] < 1e-7 and jtrace[-2] < 1e-7, (trace, jtrace)
    assert trace[-1] < 5e-5
    assert x.dtype == C64 and _rel(x, want) <= 1e-5
    assert ts.outer_iterations[0] == j_iters, (ts.outer_iterations, j_iters)
    assert len(ts.outer_iterations) == len(trace) - 2


def test_tiled_solver_raw_solve_and_restart_rule():
    """Without refinement the trace is the raw solve's residual; the default
    outer restart follows the JAX package's memory rule."""
    eps, mu, source = _scene()
    ts = tt.TiledSolver(eps, mu, DX, DX, OMEGA, patch_size=PATCH, padding=PAD,
                        pml_thickness=PML, outer_restart=10, device="cpu")
    x, trace = ts.solve(source, solver_tol=1e-2, solver_maxiter=60, refine_target=None)
    assert len(trace) == 1 and trace[0] < 1e-2 and x.shape == (N, N)
    assert tt.TiledSolver(eps, mu, DX, DX, OMEGA, patch_size=PATCH, padding=PAD,
                          device="cpu").outer_restart == 60
    ours = tt.TiledSolver.__init__.__kwdefaults__
    theirs = jt.TiledSolver.__init__.__kwdefaults__
    assert {k: v for k, v in ours.items() if k not in ("dtype", "device")} == {
        k: v for k, v in theirs.items() if k != "dtype"}


@pytest.fixture(scope="module")
def jax_stationary():
    """JAX run_fdfd_tiled in the stationary modes, complex128, 2 passes."""
    eps, mu, source = _scene()
    return {mode: tuple(map(np.asarray, jt.run_fdfd_tiled(
        eps, mu, DX, DX, OMEGA, source, mode=mode, dtype=jnp.complex128, **STATIONARY)))
        for mode in ("additive", "multiplicative")}


STATIONARY = dict(patch_size=PATCH, padding=PAD, pml_thickness=PML, n_passes=2, relax=0.5,
                  tol=1e-9, solver_tol=1e-6, solver_maxiter=60)


@pytest.mark.parametrize("mode", ["additive", "multiplicative"])
def test_run_fdfd_tiled_stationary_matches_jax(jax_stationary, mode):
    """The reference's stationary sweeps (damped RAS and the source-outward
    sequential sweep) in complex128: each sweep's max delta within 1e-6
    relative of JAX's, the field within 1e-6."""
    eps, mu, source = _scene()
    want, jdeltas = jax_stationary[mode]
    got, deltas = tt.run_fdfd_tiled(eps, mu, DX, DX, OMEGA, source, mode=mode, dtype=C128,
                                    device="cpu", **STATIONARY)
    assert len(deltas) == len(jdeltas) == 2
    assert np.allclose(deltas, jdeltas, rtol=1e-6, atol=0), (deltas, jdeltas)
    assert _rel(got, want) <= 1e-6
    with pytest.raises(ValueError, match="unknown mode"):
        tt.run_fdfd_tiled(eps, mu, DX, DX, OMEGA, source, mode="sweep", device="cpu")


def test_patch_of_a_stack_is_a_stack_of_one():
    eps, mu, _ = _scene()
    origins = tt.generate_patches(N, N, PATCH, PAD)
    ops = tt.stack_patch_operators(eps, mu, origins, W, DX, DX, OMEGA, PML, C128, device="cpu")
    x = torch.tensor(_field((len(origins), W, W)))
    one = tt._patch(ops, 4)
    assert one.batch_shape == (1,)
    assert torch.equal(one.apply(x[4:5])[0], ops.apply(x)[4])
    assert dataclasses.replace(one, eps=ops.eps).batch_shape == (len(origins),)
