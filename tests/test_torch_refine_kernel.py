"""The refinement's residual kernels (ops/fdfd_residual.py) on the CPU: their
plain version against torch's chain that fdfd/refine.py runs everywhere
else, the dispatch rule, and refine / refine_batched unchanged on the CPU.
The kernels themselves run in tests/test_torch_cuda.py."""

import importlib

import numpy as np
import pytest
import torch

from fdtd2d_tpu_torch import constants
from fdtd2d_tpu_torch.fdfd.tiled import stack_patch_operators
from fdtd2d_tpu_torch.ops import fdfd_residual as fr
from fdtd2d_tpu_torch.ops.helmholtz import make_operator, stack_operators
from fdtd2d_tpu_torch.utils import trace

refine_mod = importlib.import_module("fdtd2d_tpu_torch.fdfd.refine")
COUNTERS = ("fdfd.kernels.residual_passes", "fdfd.kernels.refine_updates")


def _op(Nx, Ny, pml, dtype=torch.complex128, omega=17e9, seed=0):
    rng = np.random.default_rng(seed)
    eps = rng.uniform(1.0, 4.0, (Nx, Ny)) * constants.EPSILON_0
    mu = rng.uniform(1.0, 1.5, (Nx, Ny)) * constants.MU_0
    return make_operator(eps, mu, 1e-3, 1.3e-3, omega, pml_thickness=pml, dtype=dtype,
                         device="cpu")


def _fields(shape, seed=1, scale=1e10):
    rng = np.random.default_rng(seed)

    def c128():
        return torch.tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape))

    return c128() * scale, c128()


def _chain(op, b, x):
    """Today's residual step: op.residual, scaled_norm, divide, cast."""
    batched = b.dim() == 3
    r = op.residual(b, x)
    rn = refine_mod.scaled_norm(r, batched)
    safe = torch.where(rn == 0, torch.ones_like(rn), rn)
    return (r / (safe[:, None, None] if batched else safe)).to(torch.complex64), rn


def _ulps(got, want):
    """Largest difference of two complex64 tensors in units of the last place
    of ``want``'s parts."""
    g, w = torch.view_as_real(got).numpy(), torch.view_as_real(want).numpy()
    return float(np.max(np.abs(g.astype(np.float64) - w) / np.spacing(np.abs(w))))


# (Nx, Ny, B, pml): odd and even, 5 and 6 where the truncations of both
# differences meet, non-square, more than one tile each way (64 x 256 a tile)
CASES = [(5, 5, None, 0), (6, 6, None, 2), (5, 5, 3, 1), (6, 6, 1, 0), (23, 17, None, 4),
         (23, 17, 3, 0), (17, 23, 1, 5), (70, 300, 2, 8), (70, 300, None, 0)]


@pytest.mark.parametrize("Nx, Ny, B, pml", CASES)
def test_plain_pass_equals_the_chain(Nx, Ny, B, pml):
    """The plain version computes the chain's r (the operator's residual),
    its norm through the kernels' tiles and combine to 1e-14, and r / ||r||
    in complex64 within 2 units of the last place."""
    op = _op(Nx, Ny, pml)
    b, x = _fields((Nx, Ny) if B is None else (B, Nx, Ny))
    rc, rn = fr.residual_pass_reference(op, b, x)
    want_rc, want_rn = _chain(op, b, x)
    assert rn.shape == want_rn.shape and rn.dtype == torch.float64
    assert rc.shape == b.shape and rc.dtype == torch.complex64
    assert float(((rn - want_rn).abs() / want_rn).max()) <= 1e-14
    assert _ulps(rc, want_rc) <= 2.0


@pytest.mark.parametrize("Nx, Ny, B", [(6, 6, None), (23, 17, 3), (70, 300, 2)])
@pytest.mark.parametrize("scale", [1.0, 1e200, 1e-200])
def test_plain_norms_are_overflow_safe(Nx, Ny, B, scale):
    """The tiles' partials square no value above 1: the norm of b scaled by
    1e200 or 1e-200 is the scale times the norm of b, as scaled_norm's."""
    b, _ = _fields((Nx, Ny) if B is None else (B, Nx, Ny), scale=1.0)
    b[..., 0, 0] = 0.0      # one entry zero, one tile's partial led by another
    got = fr.norms_reference(b * scale)
    want = refine_mod.scaled_norm(b, B is not None) * scale
    assert bool(torch.isfinite(got).all())
    assert float(((got - want).abs() / want).max()) <= 1e-14


def test_plain_pass_of_a_zero_residual():
    """r = 0 gives norm 0 and a zero right-hand side, as the chain's."""
    op = _op(6, 6, 0)
    x = torch.zeros((2, 6, 6), dtype=torch.complex128)
    rc, rn = fr.residual_pass_reference(op, torch.zeros_like(x), x)
    assert torch.equal(rn, torch.zeros(2, dtype=torch.float64))
    assert torch.equal(rc, torch.zeros_like(rc))


@pytest.mark.parametrize("B", [None, 3])
def test_plain_update_equals_the_chain(B):
    """x += ||r|| d in place, bit for bit as the chain's x + ||r|| d."""
    shape = (23, 17) if B is None else (B, 23, 17)
    _, x = _fields(shape)
    d = _fields(shape, seed=2)[1].to(torch.complex64)
    rn = torch.tensor(np.random.default_rng(3).uniform(1e-3, 1e6, B or ()))
    want = x + (rn[:, None, None] if B else rn) * d.to(torch.complex128)
    got = x.clone()
    assert fr.update_reference(got, rn, d) is got
    assert torch.equal(got, want)


def _on_card(monkeypatch):
    """Stand in for the card: the rules' device clause holds for CPU tensors."""
    monkeypatch.setattr(fr, "_on_card", lambda t: True)


@pytest.mark.parametrize("B", [None, 4])
def test_rule_takes_contiguous_complex128_fields(monkeypatch, B):
    """With the device clause met, the rule takes (B, Nx, Ny) fields, refine's
    batch of one among them, complex128 of an unstacked complex128 operator
    with complex64 inner solves, and no (Nx, Ny) field; on the CPU it takes
    nothing."""
    op = _op(23, 17, 4)
    b, x = _fields((23, 17) if B is None else (B, 23, 17))
    if B is None:   # refine's one field, as the batch of one it refines
        b, x = b[None], x[None]
    assert not fr.takes_kernel(op, b, x, torch.complex64)
    _on_card(monkeypatch)
    assert fr.takes_kernel(op, b, x, torch.complex64)
    assert not fr.takes_kernel(op, b[0], x[0], torch.complex64)


def _stacked():
    ops = [_op(12, 12, 2, omega=w) for w in (15e9, 17e9)]
    return stack_operators(ops)


def _patch_stacked():
    rng = np.random.default_rng(4)
    eps = rng.uniform(1.0, 4.0, (24, 24)) * constants.EPSILON_0
    mu = np.full((24, 24), constants.MU_0)
    return stack_patch_operators(eps, mu, np.array([[0, 0], [12, 12]]), 12, 1e-3, 1e-3, 17e9, 2,
                                 torch.complex128, device="cpu")


@pytest.mark.parametrize("case", ["stacked operator", "patch-stacked operator",
                                  "complex64 operator", "non-contiguous field",
                                  "complex128 inner solves", "complex64 field",
                                  "field of another shape", "one field in a batched refinement",
                                  "empty batch"])
def test_rule_sends_the_rest_to_the_chain(monkeypatch, case):
    """Every input outside the rule goes to torch's chain, even with the
    device clause met."""
    _on_card(monkeypatch)
    op, shape, inner = _op(12, 12, 2), (3, 12, 12), torch.complex64
    if case == "stacked operator":
        op, shape = _stacked(), (2, 12, 12)
    elif case == "patch-stacked operator":
        op, shape = _patch_stacked(), (2, 12, 12)
    elif case == "complex64 operator":
        op = _op(12, 12, 2, dtype=torch.complex64)
    elif case == "complex128 inner solves":
        inner = torch.complex128
    b, x = _fields(shape)
    if case == "non-contiguous field":
        x = x.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif case == "complex64 field":
        x = x.to(torch.complex64)
    elif case == "field of another shape":
        b, x = _fields((3, 12, 13))
    elif case == "one field in a batched refinement":
        b, x = b[0], x[0]
    elif case == "empty batch":
        b, x = b[:0], x[:0]
    assert not fr.takes_kernel(op, b, x, inner)


@pytest.mark.parametrize("case", ["non-contiguous x", "complex128 d", "d of another shape",
                                  "norms of another count"])
def test_update_rule_refuses(monkeypatch, case):
    """The update wrapper raises, before any launch, on what its kernel does
    not take, even with the device clause met."""
    _on_card(monkeypatch)
    _, x = _fields((3, 12, 12))
    d = x.to(torch.complex64)
    rn = torch.ones(3, dtype=torch.float64)
    if case == "non-contiguous x":
        x = x.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif case == "complex128 d":
        d = x.clone()
    elif case == "d of another shape":
        d = d[:2]
    else:
        rn = rn[:2]
    before = trace.counters()
    with pytest.raises(ValueError, match="update kernel"):
        fr.update(x, rn, d)
    assert trace.delta(before, "fdfd.kernels.refine_updates") == 0


@pytest.mark.parametrize("call", ["stacked operator", "patch-stacked operator",
                                  "complex64 operator"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(call):
    """The wrapper refuses a CPU field, a stacked or complex64 operator,
    before any launch."""
    b, x = _fields((2, 12, 12))
    op = {"stacked operator": _stacked, "patch-stacked operator": _patch_stacked,
          "complex64 operator": lambda: _op(12, 12, 2, dtype=torch.complex64)}[call]()
    with pytest.raises(ValueError):
        fr.residual_pass(op, b, x)
    with pytest.raises(ValueError, match="no residual kernel"):
        fr.norms(b)
    with pytest.raises(ValueError, match="update kernel"):
        fr.update(x, torch.ones(2, dtype=torch.float64), x.to(torch.complex64))


def _contracting_solve(op64, seed=5):
    """An inner solve that resolves about two digits a round: the exact
    inverse of the complex128 operator, perturbed, in complex64."""
    N = op64.shape[0] * op64.shape[1]
    eye = torch.eye(N, dtype=torch.complex128).reshape(N, *op64.shape)
    A = op64.apply(eye).reshape(N, N).T
    rng = np.random.default_rng(seed)
    P = torch.tensor(1e-2 * (rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))
                     / np.sqrt(N))
    Ainv = torch.linalg.inv(A) @ (torch.eye(N, dtype=torch.complex128) + P)

    def solve(rhs):
        flat = rhs.reshape(-1, N).to(torch.complex128)
        return (flat @ Ainv.T).reshape(rhs.shape).to(torch.complex64)

    return solve


def _old_refine(op64, b, inner_solve, target, batched, x0=None):
    """The refinement loop as it stood: torch's chain throughout."""
    x = (torch.zeros_like(b) if x0 is None else x0)
    bn = refine_mod.scaled_norm(b, batched).numpy()
    bn = np.where(bn == 0.0, 1.0, bn)
    trace, prev, rounds = [], float("inf"), 0
    for k in range(8):
        rc, rn = _chain(op64, b, x)
        rel = rn.numpy() / bn
        worst = float(np.max(rel))
        trace.append(worst)
        if worst <= target or worst >= 0.9 * prev:
            break
        prev = worst
        x = x + (rn[:, None, None] if batched else rn) * inner_solve(rc).to(torch.complex128)
        rounds = k + 1
    else:
        trace.append(float(np.max(_chain(op64, b, x)[1].numpy() / bn)))
    return x, rounds, trace


@pytest.mark.parametrize("batched", [False, True])
def test_refine_on_cpu_is_unchanged(batched):
    """refine and refine_batched on the CPU return the chain's x, rounds and
    trace bit for bit, and no counter of the kernels moves."""
    op64 = _op(12, 11, 3)
    b, _ = _fields((3, 12, 11) if batched else (12, 11))
    solve = _contracting_solve(op64)
    before = trace.counters()
    if batched:
        out = refine_mod.refine_batched(op64, b, solve, target=1e-13)
    else:
        out = refine_mod.refine(op64, b, solve, target=1e-13)
    assert all(trace.delta(before, name) == 0 for name in COUNTERS)
    x, rounds, tr = _old_refine(op64, b, solve, 1e-13, batched)
    assert rounds >= 3 and out.rounds == rounds
    assert out.trace == tr
    assert torch.equal(out.x, x)


def test_refine_leaves_a_supplied_x0_as_it_was():
    """x0 is copied once: the refinement's updates never write it."""
    op64 = _op(12, 11, 3)
    b, x0 = _fields((12, 11))
    kept = x0.clone()
    solve = _contracting_solve(op64)
    out = refine_mod.refine(op64, b, solve, target=1e-13, x0=x0)
    assert out.rounds >= 2 and torch.equal(x0, kept)
    x, rounds, tr = _old_refine(op64, b, solve, 1e-13, False, x0=kept)
    assert out.rounds == rounds and out.trace == tr and torch.equal(out.x, x)


@pytest.mark.parametrize("with_x0", [False, True])
def test_refine_is_refine_batched_of_one(with_x0):
    """refine(b) is refine_batched(b[None]) bit for bit on the CPU: x, the
    residual, rounds and trace, with and without x0."""
    op64 = _op(12, 11, 3)
    b, x0 = _fields((12, 11))
    solve = _contracting_solve(op64)
    one = refine_mod.refine(op64, b, solve, target=1e-13, x0=x0 if with_x0 else None)
    batch = refine_mod.refine_batched(op64, b[None], solve, target=1e-13,
                                      x0=x0[None] if with_x0 else None)
    assert one.rounds >= 2 and one.rounds == batch.rounds and one.trace == batch.trace
    assert one.relative_residual == float(batch.relative_residual[0])
    assert torch.equal(one.x, batch.x[0])
