"""The port's sublattice-sharded direct solve (parallel/direct_sharded.py):
on meshes of 4, 2 and 1 CPU entries (one process; a mesh may name a device
several times), in the stored, checkpointed and compressed modes, against
the single-device solve of the same mode, as tests/test_direct.py holds the
JAX package's on its virtual 4-device mesh; and against the JAX package's
own sharded factor and solve on the same numpy scene."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtd2d_tpu.ops.helmholtz import make_operator as jax_make_operator
from fdtd2d_tpu.parallel import direct_sharded as jsharded
from fdtd2d_tpu.parallel.mesh import make_mesh as jax_make_mesh

from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
from fdtd2d_tpu_torch.fdfd import compressed as comp
from fdtd2d_tpu_torch.fdfd.direct import (
    StackedFactors, factor_stacked, solve_direct, solve_stacked, stack_coefficients,
)
from fdtd2d_tpu_torch.ops.helmholtz import make_operator
from fdtd2d_tpu_torch.parallel import factor_sharded, make_mesh, solve_factored_sharded

DX = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _op(N, omega=24e9, pml=20, dtype=torch.complex64):
    eps, mu, src = hard_binary_scene(N, seed=3, sigma=4.0, source_amp=10.0)
    op = make_operator(eps, mu, DX, DX, omega, pml_thickness=pml, dtype=dtype, device="cpu")
    return op, torch.tensor(-1j * omega * src, dtype=dtype)


def _rel(x, ref):
    return float(torch.linalg.vector_norm(x.to(ref.dtype) - ref) / torch.linalg.vector_norm(ref))


def _stacked(op, mode):
    """x = A^{-1} b by the single-device stacked path of ``mode``."""
    if mode == "compressed":
        nc = op.shape[1] // 2
        L = comp.hodlr_plan(nc, leaf=16, rank=10)
        om = comp.make_test_matrices(nc, L, 10, dtype=op.dtype, device="cpu")
        f = StackedFactors(stacked=comp.factor_compressed_stacked(
            stack_coefficients(op), om, L=L, q=1), shape=op.shape)
    else:
        f = factor_stacked(op, checkpointed=mode == "checkpointed", stride=16)
    return lambda b: solve_stacked(f, b)


@pytest.mark.parametrize("mode", ["stored", "checkpointed", "compressed"])
@pytest.mark.parametrize("entries", [4, 2, 1])
def test_sharded_matches_single_device(entries, mode):
    """Sublattice k on entry k * len(mesh) // 4, merged on b's device: in
    complex128 <= 1e-6 from the stacked single-device solve of the same mode
    (the JAX bound; any misplaced sublattice is O(1) off), the compressed
    one within its range finder's 1e-2 of the exact solve. In complex64 the
    meshes of 2 and 1 batch as the stacked path does and agree with it to
    <= 1e-6 (bit for bit here); a mesh of 4 factors one sublattice an entry,
    and torch's CPU complex multiply rounds the Schur update n W s of one
    block differently from a batched one (vector body against scalar tail),
    which the pivotless recursion carries to ~1e-6: that case is held to
    1e-5."""
    N = 96 if mode != "compressed" else 160
    mesh = make_mesh((entries,), axis_names=("s",), devices=["cpu"] * entries)
    kw = dict(checkpointed=mode == "checkpointed", stride=16, compressed=mode == "compressed",
              rank=10, leaf=16, power_iters=1)
    for dtype in (torch.complex128, torch.complex64):
        op, b = _op(N, dtype=dtype)
        f = factor_sharded(op, mesh, **kw)
        assert [k0 for _, k0, _ in f.groups] == list(range(0, 4, 4 // entries))
        got = solve_factored_sharded(f, b)
        assert got.shape == b.shape and got.dtype == b.dtype
        err = _rel(got, _stacked(op, mode)(b))
        print(f"{entries} entries, {mode}, {dtype}: {err:.3e} from the single-device solve")
        assert err <= (1e-5 if dtype == torch.complex64 and entries == 4 else 1e-6)
        if mode == "compressed" and dtype == torch.complex128:
            assert _rel(got, solve_direct(op, b)) < 1e-2
        two = solve_factored_sharded(f, torch.stack([b, 2 * b]))  # K right-hand sides
        assert _rel(two[1], 2 * got) < 1e-6


@pytest.mark.parametrize("mode", ["stored", "checkpointed", "compressed"])
@pytest.mark.parametrize("entries", [4, 2])
def test_sharded_matches_jax(entries, mode):
    """The port's factor_sharded / solve_factored_sharded against the JAX
    package's on a mesh of the same length, the same numpy scene and (in
    the compressed mode) the same Omega_l: <= 1e-10 relative in complex128,
    <= 1e-5 in complex64 (the bound of tests/test_torch_compressed.py; the
    two libraries round the pivotless recursion differently)."""
    N, omega, pml = (96, 24e9, 20) if mode != "compressed" else (64, 24e9, 12)
    kw = dict(checkpointed=mode == "checkpointed", stride=16, compressed=mode == "compressed",
              rank=4, leaf=8, power_iters=1)
    eps, mu, src = hard_binary_scene(N, seed=3, sigma=4.0, source_amp=10.0)
    mesh = make_mesh((entries,), axis_names=("s",), devices=["cpu"] * entries)
    jmesh = jax_make_mesh((entries,), axis_names=("s",), devices=jax.devices()[:entries])
    for dtype, jdtype, bound in ((torch.complex128, jnp.complex128, 1e-10),
                                 (torch.complex64, jnp.complex64, 1e-5)):
        op = make_operator(eps, mu, DX, DX, omega, pml_thickness=pml, dtype=dtype, device="cpu")
        b = torch.tensor(-1j * omega * src, dtype=dtype)
        got = solve_factored_sharded(factor_sharded(op, mesh, **kw), b)
        jop = jax_make_operator(eps, mu, DX, DX, omega, pml_thickness=pml, dtype=jdtype)
        want = jsharded.solve_factored_sharded(jsharded.factor_sharded(jop, jmesh, **kw),
                                               jnp.asarray(b.numpy()))
        want = torch.as_tensor(np.array(want))
        err = _rel(got, want)
        print(f"{entries} entries, {mode}, {dtype}: {err:.3e} from the JAX package's")
        assert err <= bound


def test_argument_errors():
    op, _ = _op(32, pml=4)
    mesh4 = make_mesh((4,), axis_names=("s",), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="choose one of"):
        factor_sharded(op, mesh4, checkpointed=True, compressed=True)
    with pytest.raises(ValueError, match="1D mesh"):
        factor_sharded(op, make_mesh((3,), axis_names=("s",), devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="1D mesh"):
        factor_sharded(op, make_mesh((2, 2), devices=["cpu"] * 4))
    odd, _ = _op(33, pml=4)
    with pytest.raises(ValueError, match="even N"):
        factor_sharded(odd, mesh4)
