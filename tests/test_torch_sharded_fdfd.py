"""The sharded FDFD solve of the port (fdtd2d_tpu_torch/parallel/sharded.py:
shard_operator, sharded_matvec_shardmap, solve_fdfd_sharded) on meshes of
CPU entries, against the JAX package's own functions on the 8 virtual CPU
devices of tests/conftest.py, on the shapes, seeds and bounds of
tests/test_sharded.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from fdtd2d_tpu import constants
from fdtd2d_tpu.ops.helmholtz import make_operator as jax_make_operator
from fdtd2d_tpu.parallel import make_mesh as jax_make_mesh
from fdtd2d_tpu.parallel import sharded_matvec_shardmap as jax_matvec
from fdtd2d_tpu.parallel import solve_fdfd_sharded as jax_solve_sharded
from fdtd2d_tpu_torch.fdfd.solver import solve_fdfd
from fdtd2d_tpu_torch.ops.helmholtz import make_operator
from fdtd2d_tpu_torch.parallel import (BlockLayout, make_mesh, shard_operator,
                                       sharded_matvec_shardmap, solve_fdfd_sharded)
from fdtd2d_tpu_torch.parallel import sharded

OMEGA = 17e9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(N):
    """tests/test_sharded.py's scene: seed 21, eps in [1, 2) eps0, a point
    source of 5 at (N/2, N/3)."""
    rng = np.random.default_rng(21)
    eps = constants.EPSILON_0 * (1.0 + rng.random((N, N)))
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N))
    src[N // 2, N // 3] = 5.0
    return eps, mu, src


def _cpu_mesh(shape, names=("x", "y")):
    return make_mesh(shape, axis_names=names, devices=["cpu"] * math.prod(shape))


def _x(N, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))


@pytest.mark.parametrize("shape,spec", [((8,), P("x", None)), ((4, 2), P("x", "y"))])
def test_matvec_matches_jax_shardmap(shape, spec):
    """64^2, complex128: the block matvec on (8,) and (4, 2) meshes against
    JAX's sharded_matvec_shardmap on the same meshes (<= 1e-13), and against
    the single-device apply; every halo is one strip copy a seam side a
    difference (four differences a matvec)."""
    N = 64
    eps, mu, _ = _scene(N)
    op = make_operator(eps, mu, 1e-3, 1e-3, OMEGA, pml_thickness=10, dtype=torch.complex128,
                       device="cpu")
    jop = jax_make_operator(eps, mu, 1e-3, 1e-3, OMEGA, pml_thickness=10, dtype=jnp.complex128)
    x = _x(N)
    jmesh = jax_make_mesh(shape, axis_names=("x", "y")[: len(shape)])
    want = np.asarray(jax_matvec(jop, jmesh)(jax.device_put(jnp.asarray(x),
                                                           NamedSharding(jmesh, spec))))
    mv = sharded_matvec_shardmap(op, _cpu_mesh(shape))
    layout = BlockLayout.of(_cpu_mesh(shape), (N, N))
    sharded.strip_copies = 0
    got = layout.gather(mv(layout.scatter(torch.tensor(x)))).numpy()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-13
    single = op.apply(torch.tensor(x)).numpy()
    assert np.max(np.abs(got - single)) / np.max(np.abs(single)) < 1e-15
    Dr, Dc = (*shape, 1)[:2]
    seams = 2 * ((Dr - 1) * Dc + (Dc - 1) * Dr)
    assert sharded.strip_copies == 2 * seams


@pytest.mark.parametrize("N,shape", [(67, (3, 5)), (9, (9,)), (10, (4, 3))])
def test_matvec_uneven_blocks_equal_single_device(N, shape):
    """A grid that the mesh does not divide (the last blocks one line
    shorter, down to one-line blocks) gives the single-device matvec."""
    eps, mu, _ = _scene(N)
    op = make_operator(eps, mu, 1e-3, 1e-3, OMEGA, pml_thickness=min(10, N // 3),
                       dtype=torch.complex128, device="cpu")
    sop = shard_operator(op, _cpu_mesh(shape))
    x = torch.tensor(_x(N))
    got = sop.layout.gather(sop.apply(sop.layout.scatter(x)))
    want = op.apply(x)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-15


def test_layout_refuses_empty_blocks_and_stacked_operators():
    eps, mu, _ = _scene(8)
    op = make_operator(eps, mu, 1e-3, 1e-3, OMEGA, pml_thickness=2, device="cpu")
    with pytest.raises(ValueError, match="without cells"):
        shard_operator(op, _cpu_mesh((9,)))
    from fdtd2d_tpu_torch.ops.helmholtz import stack_operators

    op2 = make_operator(eps, mu, 1e-3, 1e-3, 2 * OMEGA, pml_thickness=2, device="cpu")
    with pytest.raises(ValueError, match="stacked"):
        shard_operator(stack_operators([op, op2]), _cpu_mesh((2,)))


def test_sharded_solve_matches_jax():
    """96^2 on a (2, 4) mesh, complex128, tol 1e-10, maxiter 120 (FDM-FGMRES):
    residual < 1e-9 and <= 1e-8 from JAX's solve_fdfd_sharded; the FDM
    gathers the residual once an application."""
    N = 96
    eps, mu, src = _scene(N)
    b = -1j * OMEGA * src
    op = make_operator(eps, mu, 1e-3, 1e-3, OMEGA, pml_thickness=16, dtype=torch.complex128,
                       device="cpu")
    jop = jax_make_operator(eps, mu, 1e-3, 1e-3, OMEGA, pml_thickness=16, dtype=jnp.complex128)
    want = jax_solve_sharded(jop, jnp.asarray(b), jax_make_mesh((2, 4)), tol=1e-10, maxiter=120)
    sharded.fdm_gathers = sharded.fdm_gather_bytes = 0
    got = solve_fdfd_sharded(op, torch.tensor(b), _cpu_mesh((2, 4)), tol=1e-10, maxiter=120)
    assert got.x.shape == (N, N) and got.relative_residual < 1e-9 and got.converged
    jx = np.asarray(want.x)
    assert np.max(np.abs(got.x.numpy() - jx)) / np.max(np.abs(jx)) < 1e-8
    # FGMRES applies the preconditioner once an iteration
    assert sharded.fdm_gathers == got.iterations
    assert sharded.fdm_gather_bytes == sharded.fdm_gathers * 2 * N * N * 16


@pytest.mark.parametrize("method,pc,maxiter", [
    ("bicgstab", "fdm", 60), ("gmres", None, 2), ("fgmres", "jacobi", 60),
    ("bicgstab", "jacobi", 10)])
def test_sharded_methods_equal_single_device(method, pc, maxiter):
    """Every method of solve_fdfd on block fields follows the single-device
    loop: the same iterations and a field within 1e-8 (summing the dots by
    block changes only their rounding). BiCGSTAB without a strong
    preconditioner amplifies rounding ~1e7-fold every ten iterations here
    (tests/test_torch_fdfd_solver.py), so Jacobi's is held over its first
    10; GMRES's stopping rule ends an FDM-preconditioned solve at x0 here
    (||M b|| < tol ||b||), so it runs 2 cycles unpreconditioned."""
    N = 48
    eps, mu, src = _scene(N)
    op = make_operator(eps, mu, 1e-3, 1e-3, OMEGA, pml_thickness=8, dtype=torch.complex128,
                       device="cpu")
    b = torch.tensor(-1j * OMEGA * src)
    kw = dict(method=method, preconditioner=pc, tol=1e-10, maxiter=maxiter, restart=20)
    want = solve_fdfd(op, b, **kw)
    got = solve_fdfd_sharded(op, b, _cpu_mesh((2, 2)), **kw)
    assert got.iterations == want.iterations
    assert float((got.x - want.x).abs().max() / want.x.abs().max()) < 1e-8
    assert got.relative_residual == pytest.approx(want.relative_residual, rel=1e-3, abs=1e-12)
