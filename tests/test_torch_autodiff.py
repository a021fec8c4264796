"""The port's adjoint solve (fdtd2d_tpu_torch/fdfd/autodiff.py) and its
batched FGMRES against dense ``torch.linalg.solve`` autograd, the JAX
package's ``solve_helmholtz_differentiable`` under ``jax.grad``, and
``jax.vmap`` of the JAX FGMRES (the cases of tests/test_fdfd_autodiff.py,
and the stacked-over-omega path of inverse design)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtd2d_tpu import constants
from fdtd2d_tpu.fdfd.autodiff import solve_helmholtz_differentiable as jax_solve_diff
from fdtd2d_tpu.ops.fdm import fdm_preconditioner_for as jax_fdm_for
from fdtd2d_tpu.ops.helmholtz import make_operator as jax_make_operator
from fdtd2d_tpu.ops.krylov import fgmres as jax_fgmres
from fdtd2d_tpu_torch.fdfd.autodiff import solve_helmholtz_differentiable
from fdtd2d_tpu_torch.fdfd.solver import solve_fdfd
from fdtd2d_tpu_torch.ops.fdm import fdm_preconditioner_for, stack_preconditioners
from fdtd2d_tpu_torch.ops.helmholtz import make_operator, stack_operators
from fdtd2d_tpu_torch.ops.krylov import fgmres

N, DX, OMEGA, PML = 24, 1e-3, 17e9, 6
OMEGAS = (12e9, 17e9, 23e9)
C128 = torch.complex128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    """tests/test_fdfd_autodiff.py's scene, as numpy."""
    rng = np.random.default_rng(5)
    eps = constants.EPSILON_0 * (1.0 + rng.random((N, N)))
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N))
    src[N // 2, N // 2] = 1.0
    return eps, mu, -1j * OMEGA * src


def _op(eps, mu, omega=OMEGA):
    return make_operator(eps, mu, DX, DX, omega, pml_thickness=PML, dtype=C128, device="cpu")


@pytest.fixture(scope="module")
def prebuilt():
    """The FDM preconditioner of the concrete scene, built once (as the JAX
    test's ``_M``)."""
    eps, mu, _ = _scene()
    return fdm_preconditioner_for(_op(eps, mu))


def _dense_A(eps, mu):
    """The operator densified column by column, differentiable in eps and mu."""
    op = _op(eps, mu)
    return op.apply(torch.eye(N * N, dtype=C128).reshape(N * N, N, N)).reshape(N * N, -1).T


def _loss_custom(eps, mu, b, M):
    x = solve_helmholtz_differentiable(_op(eps, mu), b, preconditioner=M, tol=1e-12,
                                       maxiter=200)
    return (x.abs() ** 2).mean() * 1e-10  # scale to O(1)


def _loss_dense(eps, mu, b):
    x = torch.linalg.solve(_dense_A(eps, mu), b.reshape(-1).to(C128))
    return (x.abs() ** 2).mean() * 1e-10


def _grads(fn, *args, wrt):
    args = [torch.tensor(a) if not isinstance(a, torch.Tensor) else a for a in args]
    leaves = [args[i].detach().requires_grad_(True) for i in wrt]
    for i, leaf in zip(wrt, leaves):
        args[i] = leaf
    return torch.autograd.grad(fn(*args), leaves)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def test_primal_matches_dense_solve(prebuilt):
    eps, mu, b = (torch.tensor(a) for a in _scene())
    custom = float(_loss_custom(eps, mu, b, prebuilt))
    assert custom == pytest.approx(float(_loss_dense(eps, mu, b)), rel=1e-8)


@pytest.mark.parametrize("argnum", [0, 1], ids=["eps", "mu"])
def test_material_gradient_matches_dense_autograd(prebuilt, argnum):
    eps, mu, b = _scene()
    (g_custom,) = _grads(lambda e, m, s: _loss_custom(e, m, s, prebuilt), eps, mu, b,
                         wrt=[argnum])
    (g_dense,) = _grads(_loss_dense, eps, mu, b, wrt=[argnum])
    assert g_custom.dtype == torch.float64
    assert _rel(g_custom, g_dense) < 1e-6


def test_source_gradient_matches_dense_autograd(prebuilt):
    """A real parameter fed into the source, as tests/test_fdfd_autodiff.py
    does (it cannot see a conjugation error). That test takes Re(b), which
    is zero there, so both of its gradients are zero; Im(b) is not."""
    eps, mu, b = (torch.tensor(a) for a in _scene())

    def through(loss):
        return lambda br: loss(eps, mu, br + 0.5j * br)

    br = b.imag
    (g_custom,) = _grads(through(lambda e, m, s: _loss_custom(e, m, s, prebuilt)), br, wrt=[0])
    (g_dense,) = _grads(through(_loss_dense), br, wrt=[0])
    assert _rel(g_custom, g_dense) < 1e-6


def test_complex_source_gradient_matches_dense_autograd(prebuilt):
    """A complex leaf as the source, under a loss that is not invariant to a
    global phase (Re of a weighted sum of x): a conjugated b_bar fails."""
    eps, mu, _ = (torch.tensor(a) for a in _scene())
    rng = np.random.default_rng(9)
    b = torch.tensor(rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))
    w = torch.tensor(rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))

    def custom(s):
        x = solve_helmholtz_differentiable(_op(eps, mu), s, preconditioner=prebuilt,
                                           tol=1e-12, maxiter=200)
        return (w * x).sum().real + (x.abs() ** 2).sum() * 1e-3

    def dense(s):
        x = torch.linalg.solve(_dense_A(eps, mu), s.reshape(-1)).reshape(N, N)
        return (w * x).sum().real + (x.abs() ** 2).sum() * 1e-3

    (g_custom,) = _grads(custom, b, wrt=[0])
    (g_dense,) = _grads(dense, b, wrt=[0])
    assert g_custom.dtype == C128
    assert _rel(g_custom, g_dense) < 1e-6
    assert _rel(g_custom.conj().resolve_conj(), g_dense) > 1e-2  # it would see a conjugation


@pytest.fixture(scope="module")
def jax_material_grads():
    """jax.grad of the JAX package's differentiable solve, in eps and mu."""
    from fdtd2d_tpu.ops.fdm import fdm_preconditioner_for

    eps, mu, b = (jnp.asarray(a) for a in _scene())
    M = fdm_preconditioner_for(jax_make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=PML,
                                                 dtype=jnp.complex128))

    def loss(e, m):
        op = jax_make_operator(e, m, DX, DX, OMEGA, pml_thickness=PML, dtype=jnp.complex128)
        x = jax_solve_diff(op, b, preconditioner=M, tol=1e-12, maxiter=200)
        return jnp.mean(jnp.abs(x) ** 2) * 1e-10

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(eps, mu)]


@pytest.mark.parametrize("argnum", [0, 1], ids=["eps", "mu"])
def test_material_gradient_matches_jax(prebuilt, jax_material_grads, argnum):
    eps, mu, b = _scene()
    (g,) = _grads(lambda e, m, s: _loss_custom(e, m, s, prebuilt), eps, mu, b, wrt=[argnum])
    assert _rel(g, jax_material_grads[argnum]) < 1e-6


# -- the batch over omega ------------------------------------------------------------

def _stacked_scene(N2=32, pml=8):
    rng = np.random.default_rng(21)
    eps = constants.EPSILON_0 * (1.0 + 2.0 * rng.random((N2, N2)))
    mu = np.full((N2, N2), constants.MU_0)
    src = np.zeros((N2, N2))
    src[N2 // 3, N2 // 2] = 1.0
    bs = np.stack([-1j * w * src for w in OMEGAS])
    return eps, mu, bs, pml


def _stacked_ops(eps, mu, pml, dtype=C128):
    ops = [make_operator(eps, mu, DX, DX, w, pml_thickness=pml, dtype=dtype, device="cpu")
           for w in OMEGAS]
    return ops, stack_operators(ops), stack_preconditioners([fdm_preconditioner_for(o)
                                                             for o in ops])


def test_stacked_operator_applies_each_member():
    eps, mu, bs, pml = _stacked_scene()
    ops, op, M = _stacked_ops(eps, mu, pml)
    assert op.batch_shape == (3,) and op.field_shape == (3, 32, 32)
    assert op.eps.shape == (32, 32) and op.inv_s_row.shape == (3, 32)
    x = torch.tensor(np.random.default_rng(2).standard_normal((3, 32, 32)) + 0.5j)
    for f, single in enumerate(ops):
        assert torch.equal(op.apply(x)[f], single.apply(x[f]))
        assert torch.equal(op.diagonal()[f], single.diagonal())
        assert _rel(M(x)[f].numpy(), fdm_preconditioner_for(single)(x[f]).numpy()) < 1e-13
    with pytest.raises(ValueError, match="differ in more than omega"):
        stack_operators([ops[0], dataclasses.replace(ops[1], eps=ops[1].eps * 2)])


@pytest.mark.parametrize("dtype,bound", [(C128, 1e-12), (torch.complex64, 1e-5)],
                         ids=["c128", "c64"])
def test_batched_solve_matches_single_solves_and_jax_vmap(dtype, bound):
    """A stacked F = 3 solve: each member's field, residual and iterations
    equal its own unbatched solve and the JAX package's vmapped FGMRES."""
    eps, mu, bs, pml = _stacked_scene()
    ops, op, M = _stacked_ops(eps, mu, pml, dtype)
    kw = dict(tol=1e-10 if dtype == C128 else 1e-5, maxiter=400, restart=10)
    res = solve_fdfd(op, torch.as_tensor(bs), preconditioner=M, **kw)
    singles = [solve_fdfd(o, torch.as_tensor(b), **kw) for o, b in zip(ops, bs)]
    assert res.x.shape == (3, 32, 32) and len(res.iterations) == 3
    assert res.iterations == [s.iterations for s in singles]
    if dtype == C128:
        assert len(set(res.iterations)) > 1, res.iterations  # members stop apart
    assert res.converged == [True] * 3
    for f, s in enumerate(singles):
        assert _rel(res.x[f].numpy(), s.x.numpy()) < bound
        assert res.relative_residual[f] == pytest.approx(s.relative_residual, rel=0.5)

    jdt = jnp.complex128 if dtype == C128 else jnp.complex64
    jops = [jax_make_operator(eps, mu, DX, DX, w, pml_thickness=pml, dtype=jdt) for w in OMEGAS]
    stack = lambda *xs: jnp.stack(xs)  # noqa: E731
    jop, jM = jax.tree.map(stack, *jops), jax.tree.map(stack, *[jax_fdm_for(o) for o in jops])
    jres = jax.vmap(lambda o, m, b: jax_fgmres(o.apply, b, m, **kw))(
        jop, jM, jnp.asarray(bs, jdt))
    assert res.iterations == [int(i) for i in jres.iterations]
    assert _rel(res.x.numpy(), jres.x) < bound


@pytest.mark.parametrize("name", ["dst", "jacobi"])
def test_batched_solve_takes_the_builtin_preconditioners(name):
    """The "dst" and "jacobi" preconditioners of a stacked operator apply
    each member's own, bit for bit, and a batched solve with them follows
    the single solves (one restart cycle: these preconditioners barely
    converge here, and past a cycle the stagnating iterates amplify the
    rounding of the batched reductions)."""
    from fdtd2d_tpu_torch.fdfd.solver import (jacobi_preconditioner,
                                              shifted_laplacian_preconditioner)

    make = {"dst": shifted_laplacian_preconditioner, "jacobi": jacobi_preconditioner}[name]
    eps, mu, bs, pml = _stacked_scene()
    ops, op, _ = _stacked_ops(eps, mu, pml)
    r = torch.tensor(np.random.default_rng(0).standard_normal((3, 32, 32)) + 0.5j)
    kw = dict(preconditioner=name, tol=1e-14, maxiter=10, restart=10)
    res = solve_fdfd(op, torch.as_tensor(bs), **kw)
    assert res.iterations == [10] * 3
    for f, (o, b) in enumerate(zip(ops, bs)):
        assert torch.equal(make(op)(r)[f], make(o)(r[f]))
        single = solve_fdfd(o, torch.as_tensor(b), **kw)
        assert _rel(res.x[f].numpy(), single.x.numpy()) < 1e-8
        assert res.relative_residual[f] == pytest.approx(single.relative_residual, rel=1e-8)


def test_batched_solve_issues_the_same_ops_for_any_batch():
    """The ops a batched restart cycle dispatches (each a launch on the
    card) do not grow with the number of members."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            return func(*args, **(kwargs or {}))

    eps, mu, bs, pml = _stacked_scene()
    _, op, M = _stacked_ops(eps, mu, pml)
    counts = []
    for F in (1, 3):
        sub = dataclasses.replace(op, omega=op.omega[:F], inv_s_row=op.inv_s_row[:F],
                                  inv_s_col=op.inv_s_col[:F])
        Ms = dataclasses.replace(M, **{k: getattr(M, k)[:F]
                                       for k in ("Pr", "Pri", "PcT", "PcTi", "D")})
        with Count() as count:
            fgmres(sub.apply, torch.as_tensor(bs[:F]), Ms, restart=10, maxiter=10,
                   tol=1e-14, batched=True)
        counts.append(count.ops)
    assert counts[0] == counts[1] > 0


def test_stopped_member_keeps_its_field_exactly():
    """A member that has converged is frozen: its field after the whole
    batched solve is the one it had when it stopped, bit for bit."""
    eps, mu, bs, pml = _stacked_scene()
    _, op, M = _stacked_ops(eps, mu, pml)
    b = torch.as_tensor(bs)
    kw = dict(tol=1e-10, restart=10, batched=True)
    full = fgmres(op.apply, b, M, maxiter=400, **kw)
    first = min(full.iterations)
    stopped = full.iterations.index(first)
    early = fgmres(op.apply, b, M, maxiter=first, **kw)
    assert max(full.iterations) > first
    assert torch.equal(full.x[stopped], early.x[stopped])
    assert full.relative_residual[stopped] == early.relative_residual[stopped]


def test_gradient_of_a_sum_over_omega_is_the_sum_of_single_gradients():
    """The shared eps and 1/mu of a stacked solve get the sum of the
    members' gradients; the stacked source gets each member's own."""
    eps, mu, bs, pml = _stacked_scene()
    ops, op, M = _stacked_ops(eps, mu, pml)
    rng = np.random.default_rng(3)
    w = torch.tensor(rng.standard_normal((32, 32)) + 1j * rng.standard_normal((32, 32)))

    def loss_of(x):
        return (x.abs() ** 2).mean() * 1e-10 + (w * x).sum().real * 1e-5

    def grads(o, b, M_):
        e = o.eps.clone().requires_grad_(True)
        m = o.inv_mu.clone().requires_grad_(True)
        b = torch.as_tensor(b).clone().requires_grad_(True)
        x = solve_helmholtz_differentiable(dataclasses.replace(o, eps=e, inv_mu=m), b,
                                           preconditioner=M_, tol=1e-12, maxiter=400)
        members = x if o.batch_shape else [x]
        return torch.autograd.grad(sum(loss_of(xf) for xf in members), (e, m, b))

    stacked = grads(op, bs, M)
    singles = [grads(o, b, "fdm") for o, b in zip(ops, bs)]
    for k in range(2):
        assert _rel(stacked[k], sum(s[k] for s in singles)) < 1e-9
    assert stacked[2].shape == (3, 32, 32)
    for f, s in enumerate(singles):
        assert _rel(stacked[2][f], s[2]) < 1e-9


def test_entry_points_default_to_the_card():
    """The slice's new public constructors run on the card unless asked;
    ``problem_from_numpy`` carries JAX's arrays across on the CPU, as the
    other ``*_from_numpy`` helpers do."""
    import inspect

    from fdtd2d_tpu_torch.apps import inverse_design
    from fdtd2d_tpu_torch.ops import sparse

    def default(fn):
        return inspect.signature(fn).parameters["device"].default

    for fn in (inverse_design.lowpass_problem, inverse_design.decade_lowpass_problem,
               sparse.from_scipy, sparse._eye):
        assert default(fn) == "cuda", fn
    assert default(inverse_design.problem_from_numpy) == "cpu"
    assert sparse._device([np.zeros(2)], None) == torch.device("cuda")
