"""The port's CLI (fdtd2d_tpu_torch.cli) against the JAX package's."""

import os
import re

import numpy as np
import pytest
import torch

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


TIMEDOMAIN_RESIDUAL = re.compile(
    r"^relative residual: (\S+) \(f64 iterate: (\S+); (\d+) wave steps/apply\)$", re.M)


def test_cli_fdfd_has_no_timedomain_solver(capsys):
    """``fdfd --solver timedomain --size 64 --out ""`` prints the JAX CLI's
    line: the same wave steps an application, the f64 iterate at --tol, the
    returned array's residual within 1% of JAX's; no plot. A solver the CLI
    has not is refused."""
    args = ["fdfd", "--size", "64", "--solver", "timedomain", "--out", ""]
    assert jax_main(args) == 0
    ref = TIMEDOMAIN_RESIDUAL.search(capsys.readouterr().out)
    assert main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    ours = TIMEDOMAIN_RESIDUAL.search(out)
    assert ours and ref and "wrote" not in out
    assert ours.group(3) == ref.group(3)
    assert float(ours.group(2)) <= 1e-6
    assert float(ours.group(1)) == pytest.approx(float(ref.group(1)), rel=1e-2)
    with pytest.raises(SystemExit):
        main(["fdfd", "--solver", "hps"])
    assert "invalid choice" in capsys.readouterr().err


def test_cli_tiled_matches_jax(capsys):
    """``tiled --size 128 --patch-size 40 --padding 12 --out ""`` (krylov,
    refined to 1e-6): the JAX CLI's probe decision and number of trace
    entries, the f64 iterate at the target, the returned array's residual
    within 1% of JAX's; no plot."""
    args = ["tiled", "--size", "128", "--patch-size", "40", "--padding", "12", "--out", ""]
    pattern = re.compile(r"^convergence trace: \[(.*)\]$", re.M)
    assert jax_main(args) == 0
    ref = capsys.readouterr().out
    assert main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    probe = re.compile(r"^patch probe: .* -> (\S+)$", re.M)
    assert probe.search(out).group(1) == probe.search(ref).group(1)
    ours, theirs = ([float(v.strip("'")) for v in pattern.search(o).group(1).split(", ")]
                    for o in (out, ref))
    assert len(ours) == len(theirs) and ours[-2] <= 1e-6
    assert ours[-1] == pytest.approx(theirs[-1], rel=1e-2)
    assert "wrote" not in out


def test_cli_rejects_unknown_backend(capsys):
    with pytest.raises(SystemExit):
        main(ARGS + ["--backend", "mosaic"])
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("jax_name,ours", [("jax", "torch"), ("pallas", "fused")])
def test_cli_takes_the_jax_backend_names(capsys, jax_name, ours):
    """``--backend jax`` and ``--backend pallas``, the JAX CLI's names, run the
    port's ``torch`` and ``fused`` backends: the same printed field, and the
    JAX CLI's own run of that backend within 1e-4."""
    assert main(ARGS + ["--device", "cpu", "--backend", jax_name]) == 0
    alias = _printed(capsys.readouterr().out, "max |Ez|")
    assert main(ARGS + ["--device", "cpu", "--backend", ours]) == 0
    assert alias == _printed(capsys.readouterr().out, "max |Ez|") > 0
    assert jax_main(ARGS + ["--backend", jax_name]) == 0
    ref = _printed(capsys.readouterr().out, "max |Ez|")
    assert abs(alias - ref) <= 1e-4 * abs(ref)


def test_cli_invdes_matches_jax(capsys):
    """``invdes --size 40 --steps 2 --freqs 3 --out ""``: the JAX CLI's
    printed lines, each loss within 1e-6 of its own, and no plot."""
    args = ["invdes", "--size", "40", "--steps", "2", "--freqs", "3", "--out", ""]
    assert jax_main(args) == 0
    ref = capsys.readouterr().out
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # a 40^2 grid gains nothing from intra-op threads
    try:
        assert main(args + ["--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    pattern = re.compile(r"^(step \d+: loss|final loss:) (\S+)$", re.M)
    ours, theirs = pattern.findall(out), pattern.findall(ref)
    assert [k for k, _ in ours] == [k for k, _ in theirs] == [
        "step 0: loss", "step 1: loss", "final loss:"]
    assert all(abs(float(a) - float(b)) <= 1e-6 for (_, a), (_, b) in zip(ours, theirs))
    assert out.count("\n") == ref.count("\n") == 3 and "wrote" not in out


SAMPLES = re.compile(r"^(\d+) samples; worst solve residual (\S+)$", re.M)
EPOCH = re.compile(r"^epoch (\d+): loss (\S+)$", re.M)
RESTORED = re.compile(r"^restored epoch (\d+); predicted field std (\S+)$", re.M)


def _surrogate_chain(capsys, data, ckpt, extra=()):
    """The port's ``train`` then ``infer`` on ``data``; returns their output."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # 32^2 batches gain little from more threads
    try:
        assert main(["train", "--data", data, "--epochs", "2", "--batch", "8",
                     "--ckpt-dir", ckpt, "--device", "cpu", *extra]) == 0
        train_out = capsys.readouterr().out
        assert main(["infer", "--ckpt-dir", ckpt, "--data", data, "--steps", "10",
                     "--out", "", "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
    return train_out, capsys.readouterr().out


def test_cli_surrogate_chain(capsys, tmp_path):
    """``datagen --size 32 --samples 16 --batch 8 --pml 8`` then ``train
    --epochs 2 --batch 8`` then ``infer --steps 10 --out ""``, all on the
    CPU: the JAX CLI's printed lines (datagen's residual under 1e-5), a
    checkpoint a run, and a finite field from it."""
    data, ckpt = str(tmp_path / "d.npz"), str(tmp_path / "ck")
    assert main(["datagen", "--size", "32", "--samples", "16", "--batch", "8", "--pml", "8",
                 "--out", data, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    m = SAMPLES.search(out)
    assert m and int(m.group(1)) == 16 and float(m.group(2)) < 1e-5
    assert f"wrote {data}" in out
    train_out, infer_out = _surrogate_chain(capsys, data, ckpt)
    assert train_out.startswith("recipe: prediction_type=epsilon t_sampling=snr "
                                "weighting=snr_gamma ema_decay=0.0 augment=False "
                                "compute_dtype=float32\n")
    losses = EPOCH.findall(train_out)
    assert [e for e, _ in losses] == ["0", "1"] and all(np.isfinite(float(v)) for _, v in losses)
    assert re.search(r"^final loss (\S+)$", train_out, re.M)
    assert sorted(os.listdir(ckpt)) == ["epoch_00001.pt"]
    m = RESTORED.search(infer_out)
    assert m and m.group(1) == "1" and np.isfinite(float(m.group(2))) and float(m.group(2)) > 0
    assert "wrote" not in infer_out


def test_cli_train_reads_a_jax_dataset(capsys, tmp_path):
    """The port's ``train`` and ``infer`` on a compact dataset written by the
    JAX CLI's ``datagen``."""
    data, ckpt = str(tmp_path / "jax.npz"), str(tmp_path / "ck")
    assert jax_main(["datagen", "--size", "32", "--samples", "8", "--batch", "8", "--pml", "8",
                     "--compact", "--out", data]) == 0
    assert float(SAMPLES.search(capsys.readouterr().out).group(2)) < 1e-5
    train_out, infer_out = _surrogate_chain(capsys, data, ckpt,
                                            ("--prediction-type", "x0", "--t-sampling",
                                             "uniform", "--weighting", "uniform"))
    assert len(EPOCH.findall(train_out)) == 2
    assert RESTORED.search(infer_out)



def test_cli_train_eval_does_not_depend_on_drawing(capsys, tmp_path, monkeypatch):
    """``train --epochs 2 --eval-every 1``: the losses and the holdout curve
    are the same whether the eval readouts are drawn (matplotlib installed)
    or saved as npz, since the eval chain draws from the training generator
    either way; without a panel, each eval epoch's pred and true are saved."""
    data = str(tmp_path / "d.npz")
    assert main(["datagen", "--size", "32", "--samples", "16", "--batch", "8", "--pml", "8",
                 "--out", data, "--device", "cpu"]) == 0
    runs = {}
    for draw in (True, False):
        monkeypatch.setattr("fdtd2d_tpu_torch.cli._can_draw", lambda draw=draw: draw)
        evald = tmp_path / f"ev_{draw}"
        train_out, _ = _surrogate_chain(capsys, data, str(tmp_path / f"ck_{draw}"),
                                        ("--eval-every", "1", "--eval-dir", str(evald),
                                         "--holdout", "4"))
        runs[draw] = (EPOCH.findall(train_out), (evald / "holdout_metrics.csv").read_text(),
                      sorted(p.name for p in evald.glob("eval_epoch_*")))
    assert len(runs[True][0]) == 2 and runs[False][:2] == runs[True][:2]
    for draw, kind in ((True, "png"), (False, "npz")):
        assert runs[draw][2] == [f"eval_epoch_00000.{kind}", f"eval_epoch_00001.{kind}"]
    saved = np.load(tmp_path / "ev_False" / "eval_epoch_00001.npz")
    assert saved["pred"].shape == saved["true"].shape == (32, 32)
    assert np.all(np.isfinite(saved["pred"]))
