"""The plain references agree with the port at tiny sizes, and import
nothing of the port or of the JAX package."""

from __future__ import annotations

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

from tiny import PB, REPO
from portbench.cells import load_module
from portbench.reference import fdfd as ref_fdfd
from portbench.reference import fdtd as ref_fdtd

BANNED = {"jax", "jaxlib", "flax", "fdtd2d_tpu", "fdtd2d_tpu_torch"}


def test_fdtd_reference_agrees_with_the_ports_float64_rollout():
    from fdtd2d_tpu_torch.fdtd.simulate import FDTDConfig, simulate

    eps, mu = (torch.as_tensor(a) for a in load_module(PB, "scenes", "block4").make(40))
    cfg = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=300, source_xy=(17, 23), source_fc=30e9,
                     backend="torch", dtype=torch.float64, device="cpu")
    start, _ = simulate(eps, mu, FDTDConfig(**{**cfg.__dict__, "source_xy": (20, 11)}))
    got, _ = simulate(eps, mu, cfg, state=start)
    want = ref_fdtd.rollout(eps, mu, 5e-14, 1e-4, [f[None] for f in start], 300, [(17, 23)],
                            30e9)
    for g, w in zip(got, want):
        assert ref_fdtd.local_error(g[None], w) < 1e-12
    assert ref_fdtd.band_cover(want[0]) > 1e-3


def test_fdfd_reference_operator_agrees_with_the_ports():
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator

    eps, mu = load_module(PB, "scenes", "hard_binary").make(96, seed=7)
    A = ref_fdfd.operator(eps, mu, 1e-3, 1e-3, 17e9, 40, 2.0, 3)
    op = make_operator(eps, mu, 1e-3, 1e-3, 17e9, 40, dtype=torch.complex128, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((96, 96)) + 1j * rng.standard_normal((96, 96))
    want = op.apply(torch.as_tensor(x)).numpy().ravel()
    assert np.abs(A @ x.ravel() - want).max() <= 1e-12 * np.abs(want).max()
    b = ref_fdfd.point_sources((96, 96), [(40, 51)], 17e9)
    assert b[0, 40 * 96 + 51] == -1j * 17e9
    np.testing.assert_allclose(ref_fdfd.relative_residuals(A, b, np.zeros_like(b)), [1.0])


def test_fdfd_exact_solutions_agree_with_scipy_and_the_gate_holds():
    from scipy.sparse.linalg import spsolve

    eps, mu = load_module(PB, "scenes", "hard_binary").make(64, seed=7, contrast=3.0)
    A = ref_fdfd.operator(eps, mu, 1e-3, 1e-3, 17e9, 20, 2.0, 3)
    b = ref_fdfd.point_sources((64, 64), [(20, 31), (40, 22)], 17e9)
    exact = ref_fdfd.Sublattices(A, (64, 64), "cpu")
    x, res = exact.solve(torch.as_tensor(b.reshape(2, 64, 64)))
    want = spsolve(A.tocsc(), b.T).T
    err = np.linalg.norm(x.numpy().reshape(2, -1) - want, axis=1) / np.linalg.norm(want, axis=1)
    assert err.max() < 1e-12 and float(res.max()) < 1e-13
    y = torch.randn(3, 64, 64, dtype=torch.complex128)
    Ay = (A @ y.numpy().reshape(3, -1).T).T
    assert np.abs(exact.apply(y).numpy().reshape(3, -1) - Ay).max() <= 1e-14 * np.abs(Ay).max()
    ref_fdfd.check_resolution(eps, mu, 17e9, 1e-3)       # contrast 3: 0.509-1.018 mm
    eps5, _ = load_module(PB, "scenes", "hard_binary").make(64, seed=7, contrast=5.0)
    with pytest.raises(ValueError, match="outside the upstream's window"):
        ref_fdfd.check_resolution(eps5, mu, 17e9, 1e-3)   # contrast 5: 0.394-0.789 mm


def test_the_scene_copies_agree_with_the_ports_scenes():
    from fdtd2d_tpu_torch.bench import _fdtd_scene
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene

    for got, want in zip(load_module(PB, "scenes", "block4").make(64), _fdtd_scene(64)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(load_module(PB, "scenes", "hard_binary").make(64, seed=7),
                         hard_binary_scene(64, seed=7)[:2]):
        np.testing.assert_array_equal(got, want)


def test_the_references_import_nothing_of_the_port_or_of_jax():
    for path in sorted((PB / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not {n.split(".")[0] for n in names} & BANNED, (path.name, names)
    code = ("import sys; import portbench.reference.fdtd, portbench.reference.fdfd; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True).stdout
    assert not set(ast.literal_eval(out)) & BANNED
