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


def test_cli_rejects_unknown_backend(capsys):
    with pytest.raises(SystemExit):
        main(ARGS + ["--backend", "pallas"])
    assert "invalid choice" in capsys.readouterr().err
