"""The surrogate's trained deliverable on the card: datagen, training, the
held-out report and the diagnose probe, each a process of the port's
command line, resumable, with their rates and wall times.

    python tools/surrogate_run.py [--deadline SECONDS] [--export DIR]
        [--runs runs] [--out assets/surrogate_torch_x0]

The recipe is fixed (the constants below); the steps run in order
(``RUNS`` = ``--runs``), each resuming what an earlier call left:

- datagen: ``python -m fdtd2d_tpu_torch.cli datagen --size 256 --samples
  10240 --batch 32 --shard-size 1024 --compact --out RUNS/data10k_torch``
  (shards already written are kept), then the worst true residual over all
  shards, which must be < 1e-5;
- train: ``... train --data RUNS/data10k_torch --epochs 100 --batch 8
  --holdout 64 --prediction-type x0 --t-sampling uniform --weighting
  uniform --device-cache f16 --ckpt-dir RUNS/ckpt10k_torch_x0 --ckpt-every 5
  --eval-every 10 --eval-dir RUNS/eval10k_torch_x0`` (float32, TF32
  convolutions; the CLI's defaults otherwise), its output appended to
  ``RUNS/train100_x0.log``; it resumes from the checkpoints. With
  ``--deadline`` the training is stopped once the script has run that many
  seconds, and the report reads out the last checkpoint;
- report: ``python -m fdtd2d_tpu_torch.apps.surrogate_report
  RUNS/data10k_torch RUNS/ckpt10k_torch_x0 RUNS/eval10k_torch_x0 OUT 64 x0``;
- diagnose: ``python -m fdtd2d_tpu_torch.apps.surrogate_diagnose
  RUNS/ckpt10k_torch_x0 RUNS/data10k_torch --prediction-type x0``.

Every line a child prints is stamped with its arrival time, from which the
script takes the datagen rate (samples/s a shard, from the time between
shard lines), ms a train step (the seconds between two epoch lines over the
steps of an epoch) and each step's wall time. It writes them to
``RUNS/surrogate_run.json`` with the card's name and power limit, and prints
that JSON as its last line. ``--export DIR`` copies the logs, the summary,
the report's files and the last checkpoint's weights and scales (no
optimizer moments) into DIR.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# the recipe of the JAX package's banked x0 run: 10,240 scenes at 256^2, the
# last 64 held out, 100 epochs at batch 8; the directories under RUNS are
# named for it, so no other size resumes into them
SIZE, SAMPLES, SHARD_SIZE, DATAGEN_BATCH = 256, 10240, 1024, 32
EPOCHS, BATCH, HOLDOUT, EVAL_EVERY, CKPT_EVERY = 100, 8, 64, 10, 5


def _stream(cmd, log_path, t0, deadline=None):
    """Run ``cmd`` from the repo root, appending its merged output to
    ``log_path`` and echoing it; returns (rc, [(seconds since t0, line)],
    stopped). With ``deadline`` (seconds since t0) the child is terminated
    there."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "PYTHONUNBUFFERED": "1"}
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, bufsize=1)
    stopped = threading.Event()
    timer = None
    if deadline is not None:
        def stop():
            stopped.set()
            proc.terminate()

        timer = threading.Timer(max(deadline - (time.perf_counter() - t0), 0.0), stop)
        timer.start()
    lines = []
    with open(log_path, "a") as log:
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))
            log.write(line)
            log.flush()
            print(line, end="", flush=True)
    rc = proc.wait()
    if timer is not None:
        timer.cancel()
    return rc, lines, stopped.is_set()


def _last_json(lines):
    return json.loads(next(line for _, line in reversed(lines) if line.startswith("{")))


def _cli(*args):
    return [sys.executable, "-m", "fdtd2d_tpu_torch.cli", *args]


def _app(name, *args):
    return [sys.executable, "-m", f"fdtd2d_tpu_torch.apps.{name}", *args]


def _export_checkpoint(ckpt_dir: Path, dest: Path) -> str:
    """The last checkpoint's weights, BatchNorm statistics and scales, with
    the optimizer's state dict emptied of its moments: enough to read the
    model out (``restore_checkpoint``), a third of the file's size."""
    import torch

    path = sorted(ckpt_dir.glob("epoch_*.pt"))[-1]
    payload = torch.load(path, map_location="cpu", weights_only=True)
    payload["opt_state"] = {"state": {}, "param_groups": payload["opt_state"]["param_groups"]}
    dest.mkdir(parents=True, exist_ok=True)
    torch.save(payload, dest / path.name)
    return path.name


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--deadline", type=float, default=None,
                   help="stop the training this many seconds after the script began")
    p.add_argument("--runs", type=Path, default=Path("runs"))
    p.add_argument("--out", type=Path, default=Path("assets/surrogate_torch_x0"))
    p.add_argument("--export", type=Path, default=None)
    args = p.parse_args(argv)
    runs = args.runs if args.runs.is_absolute() else ROOT / args.runs
    out = args.out if args.out.is_absolute() else ROOT / args.out
    runs.mkdir(parents=True, exist_ok=True)
    data, ckpt = runs / "data10k_torch", runs / "ckpt10k_torch_x0"
    evald, train_log = runs / "eval10k_torch_x0", runs / "train100_x0.log"
    summary_path = runs / "surrogate_run.json"
    summary = json.loads(summary_path.read_text()) if summary_path.exists() else {}
    t0 = time.perf_counter()

    rc, lines, _ = _stream(_cli("datagen", "--size", str(SIZE), "--samples", str(SAMPLES),
                                "--batch", str(DATAGEN_BATCH), "--shard-size", str(SHARD_SIZE),
                                "--compact", "--out", str(data), "--device", "cuda"),
                           runs / "datagen10k_torch.log", t0)
    if rc != 0:
        raise SystemExit(f"datagen exited {rc}")
    stamps = [(t, int(line.split(":")[1].split()[0]))
              for t, line in lines if line.startswith("shard ")]
    worst = max(float(np.max(np.load(f)["residuals"]))
                for f in sorted(glob.glob(str(data / "shard_*.npz"))))
    if not worst < 1e-5:
        raise SystemExit(f"worst true residual {worst:.3e} >= 1e-5")
    rates = [n / (t - t_prev) for (t_prev, _), (t, n) in zip(stamps, stamps[1:])]
    if stamps or "datagen" not in summary:  # a call that wrote no shard keeps the rates
        summary["datagen"] = {"seconds": lines[-1][0] if lines else 0.0,
                              "shards_written": len(stamps), "worst_residual": worst,
                              "samples_per_s_warm": rates,
                              "first_shard_s": stamps[0][0] if stamps else None}
    print(f"datagen: worst true residual {worst:.3e}; warm samples/s {rates}", flush=True)

    t_train = time.perf_counter() - t0
    rc, lines, stopped = _stream(
        _cli("train", "--data", str(data), "--epochs", str(EPOCHS), "--batch", str(BATCH),
             "--holdout", str(HOLDOUT), "--prediction-type", "x0", "--t-sampling",
             "uniform", "--weighting", "uniform", "--device-cache", "f16", "--ckpt-dir",
             str(ckpt), "--ckpt-every", str(CKPT_EVERY), "--eval-every", str(EVAL_EVERY),
             "--eval-dir", str(evald), "--device", "cuda"),
        train_log, t0, deadline=args.deadline)
    if rc != 0 and not stopped:
        raise SystemExit(f"train exited {rc}")
    epochs = [(t, int(line.split(":")[0].split()[1])) for t, line in lines
              if line.startswith("epoch ") and ": loss " in line]
    steps_per_epoch = (SAMPLES - HOLDOUT) // BATCH
    epoch_s = [t - t_prev for (t_prev, _), (t, _) in zip(epochs, epochs[1:])]
    ckpts = sorted(ckpt.glob("epoch_*.pt"))
    summary.setdefault("train", []).append({
        "started_s": t_train, "seconds": (lines[-1][0] if lines else t_train) - t_train,
        "stopped_at_deadline": stopped, "epochs_logged": [e for _, e in epochs],
        "first_epoch_end_s": epochs[0][0] - t_train if epochs else None,
        "epoch_s": epoch_s, "steps_per_epoch": steps_per_epoch,
        "ms_per_step_median": (1e3 * float(np.median(epoch_s)) / steps_per_epoch
                               if epoch_s else None),
        "last_checkpoint": ckpts[-1].name if ckpts else None})

    t_rep = time.perf_counter() - t0
    rc, lines, _ = _stream(_app("surrogate_report", str(data), str(ckpt), str(evald),
                                str(out), str(HOLDOUT), "x0", "--device", "cuda"),
                           runs / "report_x0.log", t0)
    if rc != 0:
        raise SystemExit(f"surrogate_report exited {rc}")
    summary["report"] = {"seconds": lines[-1][0] - t_rep,
                         "headline": _last_json(lines)}

    rc, lines, _ = _stream(_app("surrogate_diagnose", str(ckpt), str(data),
                                "--prediction-type", "x0", "--device", "cuda"),
                           runs / "diagnose_x0.log", t0)
    if rc != 0:
        raise SystemExit(f"surrogate_diagnose exited {rc}")
    summary["diagnose"] = _last_json(lines)

    from fdtd2d_tpu_torch.utils.metrics import device_info

    summary["card"] = device_info()["nvidia_smi"]
    summary["wall_s"] = summary.get("wall_s", 0.0) + time.perf_counter() - t0
    summary_path.write_text(json.dumps(summary, indent=1))
    if args.export is not None:
        dest = args.export if args.export.is_absolute() else ROOT / args.export
        dest.mkdir(parents=True, exist_ok=True)
        for f in [summary_path, train_log, evald / "holdout_metrics.csv",
                  *runs.glob("*.log"), *(out.glob("*") if out.exists() else [])]:
            if f.is_file():
                shutil.copy2(f, dest / f.name)
        if ckpt.is_dir() and any(ckpt.glob("epoch_*.pt")):
            _export_checkpoint(ckpt, dest / "ckpt")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
