"""The port's CLI (fdtd2d_tpu_torch.cli) against the JAX package's."""

import re

import pytest

from fdtd2d_tpu.cli import main as jax_main
from fdtd2d_tpu_torch.cli import main

ARGS = ["fdtd", "--size", "48", "--steps", "30", "--frames", "0"]


def _printed(out, name):
    return float(re.search(rf"^{re.escape(name)}\s*[:=]\s*(\S+)$", out, re.M).group(1))


def test_cli_fdtd_matches_jax(capsys):
    assert jax_main(ARGS) == 0
    ref = capsys.readouterr().out
    assert main(ARGS + ["--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert _printed(ours, "courant number") == _printed(ref, "courant number")
    a, b = _printed(ours, "max |Ez|"), _printed(ref, "max |Ez|")
    assert a > 0 and abs(a - b) <= 1e-4 * abs(b), (ours, ref)


FDFD_RESIDUAL = re.compile(r"^relative residual: (\S+)(?: \(f64 iterate: (\S+)\))?$", re.M)


@pytest.mark.parametrize("solver", ["direct", "krylov"])
def test_cli_fdfd_matches_jax(capsys, solver):
    """``fdfd --size 48 --out ""``: the same printed lines as the JAX CLI, no
    plot, and residuals inside the CLI's own bounds (direct: the f64 iterate
    at --tol; krylov: < 10 * --tol, the ``converged`` rule)."""
    args = ["fdfd", "--size", "48", "--solver", solver, "--out", ""]
    assert jax_main(args) == 0
    ref = FDFD_RESIDUAL.search(capsys.readouterr().out)
    assert main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    ours = FDFD_RESIDUAL.search(out)
    assert ours and ref and "wrote" not in out
    assert (ours.group(2) is None) == (ref.group(2) is None) == (solver == "krylov")
    if solver == "direct":
        assert float(ours.group(2)) <= 1e-6 and float(ours.group(1)) < 5e-5
    else:
        assert float(ours.group(1)) < 1e-5
        assert float(ours.group(1)) == pytest.approx(float(ref.group(1)), rel=0.5)


def test_cli_fdfd_has_no_timedomain_solver(capsys):
    with pytest.raises(SystemExit):
        main(["fdfd", "--solver", "timedomain"])
    assert "invalid choice" in capsys.readouterr().err


def test_cli_rejects_unknown_backend(capsys):
    with pytest.raises(SystemExit):
        main(ARGS + ["--backend", "pallas"])
    assert "invalid choice" in capsys.readouterr().err
