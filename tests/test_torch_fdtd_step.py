"""Golden-oracle chain, port leg: the torch step against the NumPy oracle and
the JAX step, on random states made from a numpy seed."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fdtd2d_tpu import constants
from fdtd2d_tpu.fdtd import step as jax_step
from fdtd2d_tpu.fdtd.reference import numpy_step
from fdtd2d_tpu_torch.fdtd import step
from fdtd2d_tpu_torch.ops.fdtd_fused import pad_state

DT, DX = 5e-14, 1e-4


def _random_state(rng, rows, cols):
    Ez = rng.standard_normal((rows, cols))
    Hx = rng.standard_normal((rows, cols - 1))
    Hy = rng.standard_normal((rows - 1, cols))
    eps = constants.EPSILON_0 * (1.0 + 2.0 * rng.random((rows, cols)))
    mu = np.full((rows, cols), constants.MU_0)
    return Ez, Hx, Hy, eps, mu


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_torch_step_matches_numpy_oracle(dtype, tol):
    """5 steps on a random 40x56 state, as tests/test_fdtd_oracle.py does for JAX."""
    rng = np.random.default_rng(1)
    Ez, Hx, Hy, eps, mu = _random_state(rng, 40, 56)
    ce, ch, coef = step.precompute_coefficients(torch.from_numpy(eps), torch.from_numpy(mu),
                                                DT, DX, dtype)
    fields = [torch.tensor(a, dtype=dtype) for a in (Ez, Hx, Hy)]
    for _ in range(5):
        Ez, Hx, Hy = numpy_step(Ez, Hx, Hy, eps, mu, DT, DX)
        fields = step.fdtd_step(*fields, ce, ch, coef)
    for ours, ref in zip(fields, (Ez, Hx, Hy)):
        err = np.max(np.abs(ours.double().numpy() - ref)) / np.max(np.abs(ref))
        assert err < tol, f"relative error {err:.3e}"


def test_torch_step_padded_matches_jax():
    rng = np.random.default_rng(3)
    Ez, Hx, Hy, eps, mu = _random_state(rng, 40, 56)
    jce, jch, jcoef = jax_step.precompute_coefficients(eps, mu, DT, DX, jnp.float32)
    jfields = [jnp.asarray(a, jnp.float32) for a in (Ez, Hx, Hy)]
    jfields = [jfields[0], jnp.pad(jfields[1], ((0, 0), (0, 1))), jnp.pad(jfields[2], ((0, 1), (0, 0)))]
    jch = jnp.pad(jch, ((0, 1), (0, 1)))

    ce, ch, coef = step.precompute_coefficients(torch.from_numpy(eps), torch.from_numpy(mu),
                                                DT, DX, torch.float32)
    fields = pad_state(*(torch.tensor(a, dtype=torch.float32) for a in (Ez, Hx, Hy)))
    ch = torch.nn.functional.pad(ch, (0, 1, 0, 1))
    for _ in range(5):
        jfields = jax_step.fdtd_step_padded(*jfields, jce, jch, jcoef)
        fields = step.fdtd_step_padded(*fields, ce, ch, coef)
    for ours, ref in zip(fields, jfields):
        ref = np.asarray(ref, np.float64)
        err = np.max(np.abs(ours.double().numpy() - ref)) / np.max(np.abs(ref))
        assert err < 1e-5, f"relative error {err:.3e}"
    # the phantom Hx column and Hy row are never written
    assert not fields[1][:, -1].any() and not fields[2][-1, :].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_precompute_coefficients_match_jax(dtype):
    rng = np.random.default_rng(4)
    _, _, _, eps, mu = _random_state(rng, 20, 24)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.float64
    ours = step.precompute_coefficients(torch.from_numpy(eps), torch.from_numpy(mu), DT, DX, dtype)
    ref = jax_step.precompute_coefficients(eps, mu, DT, DX, jdtype)
    for o, r in zip(ours, ref):
        assert o.dtype == dtype and tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-7 if dtype == torch.float32 else 1e-15)


def test_torch_step_updates_in_place():
    rng = np.random.default_rng(5)
    Ez, Hx, Hy, eps, mu = _random_state(rng, 20, 24)
    ce, ch, coef = step.precompute_coefficients(torch.from_numpy(eps), torch.from_numpy(mu),
                                                DT, DX, torch.float64)
    fields = [torch.from_numpy(a.copy()) for a in (Ez, Hx, Hy)]
    out = step.fdtd_step(*fields, ce, ch, coef)
    assert all(o is f for o, f in zip(out, fields))
    # Hx's last row and Hy's last column are never written
    np.testing.assert_array_equal(out[1][-1].numpy(), Hx[-1])
    np.testing.assert_array_equal(out[2][:, -1].numpy(), Hy[:, -1])
