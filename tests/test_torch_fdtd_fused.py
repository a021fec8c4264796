"""K1 module (fdtd2d_tpu_torch.ops.fdtd_fused) on the CPU: its plain path
against the Pallas kernel run in interpret mode, the launch counter, the
input checks and the build's failure mode. The kernel itself runs only on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fdtd2d_tpu import constants
from fdtd2d_tpu.fdtd import step as jax_step
from fdtd2d_tpu.ops.pallas_fdtd import fdtd_multistep_pallas
from fdtd2d_tpu_torch.fdtd.step import precompute_coefficients
from fdtd2d_tpu_torch.ops import _build, fdtd_fused

DT, DX, FC = 5e-14, 1e-4, 30e9


def _coefficients(eps, mu):
    return precompute_coefficients(torch.from_numpy(eps), torch.from_numpy(mu),
                                   DT, DX, torch.float32)


def _zeros(rows, cols):
    return (torch.zeros(rows, cols), torch.zeros(rows, cols - 1),
            torch.zeros(rows - 1, cols))


@pytest.mark.parametrize("kind", ["ricker", "sinusoidal"])
def test_cpu_path_matches_pallas_interpret(kind):
    """The 48x64 case of tests/test_fdtd_pallas.py, from a random state."""
    rows, cols, nsteps = 48, 64, 30
    rng = np.random.default_rng(0)
    eps = np.full((rows, cols), constants.EPSILON_0)
    eps[20:30, 40:50] *= 3.0
    mu = np.full((rows, cols), constants.MU_0)
    state = [rng.standard_normal(s).astype(np.float32)
             for s in ((rows, cols), (rows, cols - 1), (rows - 1, cols))]

    jce, jch, jcoef = jax_step.precompute_coefficients(eps, mu, DT, DX, jnp.float32)
    ref = fdtd_multistep_pallas(*(jnp.asarray(a) for a in state), jce, jch, jcoef,
                                DT, FC, rows // 2, cols // 2, nsteps, kind, 0,
                                interpret=True)
    ce, ch, coef = _coefficients(eps, mu)
    ours = fdtd_fused.fdtd_multistep_fused(
        *(torch.from_numpy(a) for a in state), ce, ch, coef, DT, FC,
        rows // 2, cols // 2, nsteps, kind, 0)
    for o, r in zip(ours, ref):
        r = np.asarray(r, np.float64)
        assert tuple(o.shape) == r.shape  # staggered shapes kept
        err = np.max(np.abs(o.double().numpy() - r)) / np.max(np.abs(r))
        assert err < 1e-5, f"relative error {err:.3e}"


def test_chunked_offsets_match_single_run():
    """Two chunks with a step offset == one contiguous run (source timing)."""
    rows = cols = 32
    eps = np.full((rows, cols), constants.EPSILON_0)
    mu = np.full((rows, cols), constants.MU_0)
    ce, ch, coef = _coefficients(eps, mu)
    run = fdtd_fused.fdtd_multistep_fused
    a = run(*_zeros(rows, cols), ce, ch, coef, DT, FC, 16, 16, 20, "ricker", 0)
    b = run(*_zeros(rows, cols), ce, ch, coef, DT, FC, 16, 16, 10, "ricker", 0)
    b = run(*b, ce, ch, coef, DT, FC, 16, 16, 10, "ricker", 10)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_cpu_tensors_launch_nothing_and_are_not_modified():
    rows, cols = 24, 20
    rng = np.random.default_rng(1)
    eps = np.full((rows, cols), constants.EPSILON_0)
    mu = np.full((rows, cols), constants.MU_0)
    ce, ch, coef = _coefficients(eps, mu)
    fields = [torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
              for t in _zeros(rows, cols)]
    before = [f.clone() for f in fields]
    launches = fdtd_fused.launches
    out = fdtd_fused.fdtd_multistep_fused(*fields, ce, ch, coef, DT, FC, 5, 7,
                                          8, "sinusoidal", 3)
    assert fdtd_fused.launches == launches == 0
    for f, b, o in zip(fields, before, out):
        assert torch.equal(f, b) and not torch.equal(o, b)


def test_pad_unpad_roundtrip():
    Ez, Hx, Hy = (torch.randn(s, generator=torch.Generator().manual_seed(2))
                  for s in ((9, 11), (9, 10), (8, 11)))
    padded = fdtd_fused.pad_state(Ez, Hx, Hy)
    assert all(tuple(p.shape) == (9, 11) and p.is_contiguous() for p in padded)
    assert not padded[1][:, -1].any() and not padded[2][-1].any()
    for a, b in zip(fdtd_fused.unpad_state(*padded), (Ez, Hx, Hy)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case,match", [
    ("float64", "float32 only"),
    ("shape", "Hx has shape"),
    ("small", "smaller than 16"),
    ("source", "outside the grid"),
    ("huge", "32-bit"),
])
def test_kernel_input_checks_raise(case, match):
    N, M = 20, 18
    fields = list(_zeros(N, M))
    ce, ch = torch.ones(N, M), torch.ones(N - 1, M - 1)
    sx, sy = 3, 4
    if case == "float64":
        ce = ce.double()
    elif case == "shape":
        fields[1] = torch.zeros(N, M - 2)
    elif case == "small":
        fields, ce, ch = list(_zeros(12, M)), torch.ones(12, M), torch.ones(11, M - 1)
    elif case == "source":
        sx = N
    elif case == "huge":  # 46341^2 > 2^31 cells, as expanded views of one element
        n = 46341
        fields = [torch.zeros(1, 1).expand(*s) for s in ((n, n), (n, n - 1), (n - 1, n))]
        ce, ch = torch.ones(1, 1).expand(n, n), torch.ones(1, 1).expand(n - 1, n - 1)
    with pytest.raises(ValueError, match=match):
        fdtd_fused.check_kernel_inputs(*fields, ce, ch, sx, sy, 10)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
    assert _build._lib is None
