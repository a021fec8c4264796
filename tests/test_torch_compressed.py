"""The port's HODLR-compressed block-Thomas factors (fdfd/compressed.py)
against the JAX package's, on the hard binary scene of tests/test_direct.py.

The range finder's Q comes out of torch's and JAX's QR with a different unit
phase on each column, so U and V differ between the packages while Q Q^H B
does not: the tests hold solutions to each other, never U or V."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtd2d_tpu.fdfd import compressed as jcomp
from fdtd2d_tpu.ops.helmholtz import make_operator as jax_make_operator
from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
from fdtd2d_tpu_torch.fdfd import compressed as comp
from fdtd2d_tpu_torch.fdfd.direct import (
    DirectSolver, StackedFactors, factor, factor_stacked, solve_factored, stack_coefficients,
)
from fdtd2d_tpu_torch.ops.helmholtz import make_operator

DX = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hard_scene(N, seed=3):
    return hard_binary_scene(N, seed=seed, sigma=4.0, source_amp=10.0)


def _op(N, omega, pml, dtype=torch.complex64):
    eps, mu, src = _hard_scene(N)
    op = make_operator(eps, mu, DX, DX, omega, pml_thickness=pml, dtype=dtype, device="cpu")
    return op, torch.tensor(-1j * omega * src).to(dtype)


def _rel(x, ref):
    x, ref = torch.as_tensor(np.array(x)), torch.as_tensor(np.array(ref))
    return float(torch.linalg.vector_norm(x - ref) / torch.linalg.vector_norm(ref))


@pytest.mark.parametrize("nc, leaf, rank", [(1024, 128, 20), (80, 16, 10), (32, 8, 4),
                                            (100, 16, 10), (64, 64, 20)])
def test_plan_and_test_matrices_equal_jax(nc, leaf, rank):
    L = comp.hodlr_plan(nc, leaf=leaf, rank=rank)
    assert L == jcomp.hodlr_plan(nc, leaf=leaf, rank=rank)
    got = comp.make_test_matrices(nc, L, rank, device="cpu")
    want = jcomp.make_test_matrices(nc, L, rank, dtype=jnp.complex64)
    assert len(got) == len(want) == L
    for g, w in zip(got, want):
        assert g.dtype == torch.complex64 and np.array_equal(g.numpy(), np.asarray(w))
    if (nc, leaf, rank) == (1024, 128, 20):
        # direct2048's store: 253,952 complex64 entries a row
        m = nc >> L
        row = (1 << L) * m * m + sum(4 * (1 << (lev - 1)) * (nc >> lev) * rank
                                    for lev in range(1, L + 1))
        assert (L, row, 4 * 1024 * row * 8) == (3, 253952, 8_321_499_136)


@pytest.mark.parametrize("dtype, bound", [(torch.complex128, 1e-10), (torch.complex64, 1e-5)])
def test_solve_compressed_matches_jax(dtype, bound):
    """The same Omega_l, the same scene: the port's compressed backsolve
    against JAX's, per sublattice loop (factor_compressed) and q = 1."""
    N, omega = 64, 24e9
    jdtype = jnp.complex128 if dtype == torch.complex128 else jnp.complex64
    op, b = _op(N, omega, 12, dtype)
    nc = N // 2
    L = comp.hodlr_plan(nc, leaf=8, rank=4)
    x = comp.solve_compressed(
        comp.factor_compressed(op, comp.make_test_matrices(nc, L, 4, dtype=dtype, device="cpu"),
                               L=L, q=1), b)
    eps, mu, _ = _hard_scene(N)
    jop = jax_make_operator(eps, mu, DX, DX, omega, pml_thickness=12, dtype=jdtype)
    jf = jcomp.factor_compressed(jop, jcomp.make_test_matrices(nc, L, 4, dtype=jdtype), L=L, q=1)
    want = np.asarray(jcomp.solve_compressed(jf, jnp.asarray(b.numpy())))
    err = _rel(x.numpy(), want)
    print(f"port vs JAX compressed solve, {dtype}: {err:.3e}")
    assert err <= bound


@pytest.mark.parametrize("q, bound", [(0, 1e-2), (1, 3e-3)])
def test_compressed_backsolve_near_the_full_store(q, bound):
    """JAX's checks (tests/test_direct.py) on the port: 160^2, rank 10,
    leaf 16; the raw backsolve within the range finder's tolerance of the
    dense store, and a smaller store. (JAX also asserts q = 1 beats q = 0:
    at this rank both sit at the complex64 floor, ~1e-6, where the order is
    rounding's, so the port holds each to its bound instead.)"""
    N, omega = 160, 24e9
    op, b = _op(N, omega, 20)
    nc = N // 2
    L = comp.hodlr_plan(nc, leaf=16, rank=10)
    assert L >= 2
    f = comp.factor_compressed(op, comp.make_test_matrices(nc, L, 10, device="cpu"), L=L, q=q)
    x_dense = solve_factored(factor(op), b)
    assert _rel(comp.solve_compressed(f, b), x_dense) < bound
    assert comp.compressed_bytes(f) < 4 * (N // 2) * nc * nc * 8


def test_stacked_against_loop():
    """The stacked factor (one batched recursion, what DirectSolver uses on
    even grids) against the per-sublattice loop at 160^2, q = 1: <= 1e-6 in
    complex128, and the stacked factors solved stacked and as a loop over
    their four sublattices <= 1e-6 in complex64. Two complex64 factor runs
    differ more: torch's CPU complex multiply rounds the Schur update
    n W s differently for a (4, nc, nc) batch than for one block (vector
    body against scalar tail), and the pivotless recursion amplifies that
    over 80 rows to a few 1e-6; JAX's XLA rounds both alike. That pair is
    held to 1e-5."""
    N, omega = 160, 24e9
    nc = N // 2
    L = comp.hodlr_plan(nc, leaf=16, rank=10)
    for dtype in (torch.complex128, torch.complex64):
        op, b = _op(N, omega, 20, dtype)
        om = comp.make_test_matrices(nc, L, 10, dtype=dtype, device="cpu")
        x_loop = comp.solve_compressed(comp.factor_compressed(op, om, L=L, q=1), b)
        st = comp.factor_compressed_stacked(stack_coefficients(op), om, L=L, q=1)
        x_st = comp.solve_compressed(StackedFactors(stacked=st, shape=(N, N)), b)
        x_views = comp.solve_compressed(comp.sublattice_views(st, (N, N)), b)
        if dtype == torch.complex128:
            assert _rel(x_st, x_loop) < 1e-6
        else:
            assert _rel(x_views, x_st) < 1e-6
            assert _rel(x_st, x_loop) < 1e-5
        assert comp.compressed_bytes(st) == comp.compressed_bytes(
            comp.sublattice_views(st, (N, N)))


@pytest.mark.parametrize("stacked", [True, False])
def test_compressed_against_the_dense_store_of_the_same_batching(stacked):
    """The compressed factor keeps the dense carry, so against the stored
    factor built the same way (stacked, or one sublattice at a time) its raw
    complex64 backsolve differs by its truncation alone: <= 1e-5 at 160^2,
    rank 10, q = 1. (Batched and single inverses round differently, and the
    pivotless recursion carries that into both modes alike.)"""
    N, omega = 160, 24e9
    nc = N // 2
    L = comp.hodlr_plan(nc, leaf=16, rank=10)
    op, b = _op(N, omega, 20)
    om = comp.make_test_matrices(nc, L, 10, device="cpu")
    if stacked:
        f = StackedFactors(stacked=comp.factor_compressed_stacked(stack_coefficients(op), om,
                                                                  L=L, q=1), shape=(N, N))
        dense = StackedFactors(stacked=factor_stacked(op).stacked, shape=(N, N))
    else:
        f, dense = comp.factor_compressed(op, om, L=L, q=1), factor(op)
    err = _rel(comp.solve_compressed(f, b), solve_factored(dense, b))
    print(f"compressed vs stored, {'stacked' if stacked else 'one sublattice a call'}: {err:.3e}")
    assert err <= 1e-5


def test_direct_solver_compressed_refines():
    """DirectSolver(compressed=True) with complex128 refinement reaches the
    true residual of the dense store (JAX: trace[-2] < 1e-8, trace[-1] <
    5e-5, the returned complex64 array's floor); its store is smaller."""
    N, omega = 160, 24e9
    eps, mu, src = _hard_scene(N)
    solver = DirectSolver(eps, mu, DX, DX, omega, pml_thickness=20, compressed=True, rank=10,
                          leaf=16, device="cpu")
    assert solver.compressed_bytes < 4 * (N // 2) ** 3 * 8
    assert 0 < solver.factor_growth < 1e6
    x, trace = solver.solve(src, refine_target=1e-8)
    assert x.dtype == torch.complex64
    assert trace[-2] < 1e-8, trace
    assert trace[-1] < 5e-5


@pytest.mark.parametrize("stacked_solve", [True, False])
def test_solve_batched_compressed_matches_single(stacked_solve):
    """solve_batched in the compressed mode: the sources ride the last axis
    of every HODLR matvec; each field against its single solve <= 1e-5 and
    every sample refined below 1e-8 (JAX's test_solve_batched_matches_single_rhs)."""
    N, omega = 64, 24e9
    eps, mu, src0 = _hard_scene(N)
    rng = np.random.default_rng(7)
    srcs = np.zeros((3, N, N), np.complex128)
    srcs[0] = src0
    for i in (1, 2):
        r, c = rng.integers(16, N - 16, 2)
        srcs[i, r, c] = 1.0
    solver = DirectSolver(eps, mu, DX, DX, omega, pml_thickness=12, compressed=True, rank=8,
                          leaf=16, stacked_solve=stacked_solve, device="cpu")
    xb, per_sample, trace = solver.solve_batched(srcs, refine_target=1e-8)
    assert xb.shape == (3, N, N)
    assert np.all(per_sample < 1e-8) and trace[-1] < 1e-8
    for i in range(3):
        xi, _ = solver.solve(srcs[i], refine_target=1e-8)
        assert _rel(xb[i], xi) < 1e-5
