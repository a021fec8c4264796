"""The diffusion surrogate on the GPU: datagen, the train step, inference and
the CLI, each checked before it is timed.

    python tools/bench_surrogate.py [--parts datagen,train,infer,cli,readout] [--out DIR]

The functions below are phases 24-27 and 38 of chip_smoke.py, which calls them;
run alone, the script runs the ``--parts`` asked for and prints one JSON
line each, then the card's name and power limit as nvidia-smi gives them.

- ``datagen`` (phase 24): the scene-batched direct factor on the card
  (complex64, one refinement round) against the port on the CPU in
  complex128, at 48^2, batch 3, PML 8; then ``generate_dataset`` at the
  CLI's default 250^2, batch 64: one cold run of 64 samples, then 128 samples
  timed (warm samples/s, the worst true float64 residual, < 1e-5), one batch
  split into draws, factor, solve, refinement and host check (the device
  synchronized between parts), and peak device memory.
- ``train`` (phase 25): one small-UNet step on the card against the same
  step on the CPU (float32; cuDNN's TF32 is on, as models/train.py runs it,
  and then off, by swapping ``conv_flags``, for the tight bound); then the
  full-width ``UNet2D()`` at 256^2, batch 8 (bench.py's trainstep cell), in
  float32 (TF32 convolutions) and bf16: ms a step by CUDA events over
  STEPS steps after WARMUP, in turns f32, bf16, bf16, f32; the step's FLOPs
  by ``torch.utils.flop_counter.FlopCounterMode`` (the package's
  ``utils/metrics.step_flops``); the share of the peak of its mode (bf16
  989 TFLOP/s, TF32 495); peak memory; a torch.profiler window (busy
  share, top device kernels); and one ``train_epoch`` of 64 steps on
  device-resident data.
- ``infer`` (phase 26): 50-step chains at 256^2, batch 8, deterministic and
  stochastic (ms a chain), ``regress`` and a two-member
  ``ensemble_inference``: finite and in physical units.
- ``cli`` (phase 27): ``datagen --size 64 --samples 32 --batch 16 --pml 8``,
  ``train --epochs 2 --batch 8`` and ``infer --steps 10 --out ""``, a
  process each, on cuda.
- ``readout`` (phase 38; after ``cli``, whose dataset and checkpoint it
  reads): ``python -m fdtd2d_tpu_torch.apps.surrogate_report`` (holdout 8,
  epsilon) and ``surrogate_diagnose``, a process each, on cuda: rc 0, the
  report's keys, every value finite.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(ROOT))

PARTS = ("datagen", "train", "infer", "cli", "readout")
# H100 SXM peaks at 700 W (NVIDIA's data sheet, dense): the train step's
# mode decides which one bounds it (float32 runs its convolutions in TF32)
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12}
STEPS, WARMUP = 20, 5
SMALL = dict(channels=(8, 16, 32), bottleneck=64, time_embed_dim=64)
TRAIN_SHAPE = (8, 256, 256)


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gb(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 1e9


def _timed(fn, dev):
    """(result, seconds) on the host clock, the device synchronized around."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Phase 24: datagen
# ---------------------------------------------------------------------------


def factor_parity(dev, N: int = 48, B: int = 3, pml: int = 8) -> dict:
    """Scenes drawn on the CPU; labels of the card's batched complex64
    factor (plus its refinement round) against the CPU's complex128 solve of
    the same operator, and their true float64 residuals."""
    from fdtd2d_tpu_torch.fdfd.direct import factor_stacked, solve_factored
    from fdtd2d_tpu_torch.models import datagen as dg

    eps, mu, src, omega = dg.random_scenes(torch.Generator().manual_seed(0), (N, N), B)
    x = dg._solve_scenes(*(a.to(dev) for a in (eps, mu, src, omega)), 1e-3, pml).cpu()
    op = dg.make_operator_traced(eps, mu, 1e-3, 1e-3, omega, pml, dtype=torch.complex128)
    b = (-1j * omega.to(torch.complex128))[:, None, None] * src.to(torch.complex128)
    ref = solve_factored(factor_stacked(op), b)
    err = float((x.to(torch.complex128) - ref).abs().max() / ref.abs().max())
    res = dg._five_point_residual_host(eps.numpy(), mu.numpy(), src.numpy(), omega.numpy(),
                                       x.numpy(), 1e-3, pml)
    out = {"size": N, "batch": B, "pml": pml, "rel_err_vs_cpu_complex128": err,
           "worst_true_residual": float(res.max())}
    if not (err <= 1e-5 and res.max() < 1e-5):
        raise AssertionError(f"batched factor on the card: {out}")
    return out


def datagen_cell(dev, N: int = 250, batch: int = 64, samples: int = 128,
                 pml: int = 40) -> dict:
    """generate_dataset at the CLI's defaults: warm samples/s and the worst
    true residual, the split of one batch, peak memory."""
    from fdtd2d_tpu_torch.models import datagen as dg

    gen = torch.Generator(device=dev).manual_seed(0)
    (_, cold_s) = _timed(lambda: dg.generate_dataset(gen, batch, (N, N), batch=batch,
                                                     pml_thickness=pml, device=dev), dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    data, warm_s = _timed(lambda: dg.generate_dataset(gen, samples, (N, N), batch=batch,
                                                      pml_thickness=pml, device=dev), dev)
    worst = float(data["residuals"].max())
    if not (worst < 1e-5 and np.isfinite(data["Ez"]).all()):
        raise AssertionError(f"datagen {N}^2: worst true residual {worst:.3e}")
    times = {}
    enc = dg._generate_batch_compact_device(gen, batch=batch, shape=(N, N), dx=1e-3,
                                            pml_thickness=pml, device=dev, times=times)
    t0 = time.perf_counter()
    host = dg._finish_batch_host(enc, 1e-3, pml)
    times["host_copy_and_check"] = time.perf_counter() - t0
    if float(host["residuals"].max()) >= 1e-5:
        raise AssertionError(f"datagen split batch: {host['residuals'].max():.3e}")
    return {"size": N, "batch": batch, "samples": samples, "pml": pml,
            "cold_s_first_batch": cold_s, "warm_s": warm_s,
            "warm_samples_per_s": samples / warm_s, "worst_true_residual": worst,
            "split_s_one_batch": times,
            "factor_store_gb": 4 * (N // 2) ** 3 * 8 * batch / 1e9,
            "peak_gb": _peak_gb(dev) if torch.device(dev).type == "cuda" else None}


# ---------------------------------------------------------------------------
# Phase 25: the train step
# ---------------------------------------------------------------------------


def _train_batch(shape, gen, dev):
    """A normalized-looking batch: binary eps and a unit mu as models/train.py
    feeds them, a point source, omega near 2.4, unit-std Ez."""
    B, H, W = shape
    eps = (torch.rand(shape, generator=gen, device=gen.device) > 0.5).float() * 4 + 1
    src = torch.zeros(shape, device=gen.device)
    src[:, H // 2, W // 3] = 1.0
    return {"eps": (eps / 3).to(dev), "mu": torch.ones(shape, device=dev), "src": src.to(dev),
            "omega": (1.8 + 1.2 * torch.rand((B,), generator=gen, device=gen.device)).to(dev),
            "Ez": torch.randn(shape, generator=gen, device=gen.device).to(dev)}


@contextlib.contextmanager
def _tf32_off(tt):
    """models.train.conv_flags with TF32 off, for a parity check in full
    float32."""
    keep = tt.conv_flags
    tt.conv_flags = lambda: torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                                      deterministic=False, allow_tf32=False)
    try:
        yield
    finally:
        tt.conv_flags = keep


def train_parity(dev, H: int = 32) -> dict:
    """One small-UNet step (epsilon/snr/snr_gamma with augment and EMA) on the
    card against the same step on the CPU from the same weights, batch and
    draws: loss, gradients (relative to the largest), BatchNorm running
    statistics and parameters. With TF32 off the card is held to the CPU at
    1e-5 (loss), 1e-4 (gradients), 1e-5 (statistics): the arithmetic. With
    TF32 convolutions (the port's float32 mode) the forward stays close
    (loss 1e-3, statistics 1e-2) but a weight gradient is a long sum of
    products of both signs, and TF32's 10-bit inputs move it by up to 7.5%
    of the largest gradient on the first layer (measured on the H100): bound
    0.2. Parameters after AdamW within 1e-5 of each tensor's largest entry
    plus 2 lr (an entry whose gradient is near zero moves by lr times a sign
    that rounding decides)."""
    from fdtd2d_tpu_torch.models import train as tt
    from fdtd2d_tpu_torch.models.diffusion import DDPMSchedule
    from fdtd2d_tpu_torch.models.unet import UNet2D

    cfg = tt.TrainConfig(batch_size=4, ema_decay=0.5)
    gen = torch.Generator().manual_seed(1)
    batch = _train_batch((4, H, H), gen, "cpu")
    sched = DDPMSchedule.create(1000, device="cpu")
    draws = tt.step_draws(gen, sched, (4, H, H), augment=True)
    out = {}
    for mode, ctx in (("tf32", contextlib.nullcontext()), ("float32", _tf32_off(tt))):
        runs = {}
        with ctx:
            for where in ("cpu", dev):
                st = tt.create_state(3, (H, H), cfg, model=UNet2D(**SMALL), device=where)
                p0 = {n: p.detach().clone() for n, p in st.model.named_parameters()}
                st, loss = tt.train_step(
                    st, DDPMSchedule.create(1000, device=where), None,
                    {k: v.to(where) for k, v in batch.items()}, ema_decay=0.5, augment=True,
                    draws=tt.StepDraws(*(v.to(where) for v in draws)))
                runs[str(where)] = (float(loss), st, p0)
        (l_cpu, s_cpu, p0), (l_dev, s_dev, _) = runs["cpu"], runs[str(dev)]
        g_cpu = {n: p.grad for n, p in s_cpu.model.named_parameters()}
        top = max(float(g.abs().max()) for g in g_cpu.values())
        g_errs = {n: float((p.grad.cpu() - g_cpu[n]).abs().max()) / top
                  for n, p in s_dev.model.named_parameters()}
        own = {n: float((p.grad.cpu() - g_cpu[n]).abs().max() / g_cpu[n].abs().max())
               for n, p in s_dev.model.named_parameters()
               if not (".convs." in n and n.endswith("bias"))}
        sd_cpu, sd_dev = s_cpu.model.state_dict(), s_dev.model.state_dict()
        stat_err = max(float((sd_dev[k].cpu() - v).abs().max() / v.abs().max())
                       for k, v in sd_cpu.items() if "running" in k)
        param_ok = all(float((sd_dev[k].cpu() - v).abs().max())
                       <= 1e-5 * float(v.abs().max()) + 2 * cfg.lr
                       for k, v in sd_cpu.items() if "running" not in k)
        loss_err = abs(l_dev - l_cpu) / abs(l_cpu)
        out[mode] = {"loss_rel_err": loss_err, "grad_err_of_max": max(g_errs.values()),
                     "worst_grad_err_of_max": dict(sorted(g_errs.items(),
                                                          key=lambda kv: -kv[1])[:4]),
                     "worst_grad_err_of_own_max": dict(sorted(own.items(),
                                                              key=lambda kv: -kv[1])[:4]),
                     "batch_stats_rel_err": stat_err, "params_within_bound": param_ok,
                     }
    for mode, (lb, gb, sb) in (("tf32", (1e-3, 0.2, 1e-2)), ("float32", (1e-5, 1e-4, 1e-5))):
        o = out[mode]
        if not (o["loss_rel_err"] <= lb and o["grad_err_of_max"] <= gb
                and o["batch_stats_rel_err"] <= sb and o["params_within_bound"]):
            raise AssertionError(f"train step on the card vs the CPU ({mode}): {out}")
    return out


def _steps(st, sched, gen, batch, n, tt):
    for _ in range(n):
        tt.train_step(st, sched, gen, batch)


def train_cell(dev, trace: Path) -> dict:
    """ms a full-width step in f32 (TF32) and bf16 in turns, FLOPs, share of
    the peak, peak memory, a profiler window and one 64-step epoch."""
    from fdtd2d_tpu_torch.models import train as tt
    from fdtd2d_tpu_torch.models.diffusion import DDPMSchedule
    from fdtd2d_tpu_torch.utils.metrics import step_flops
    from profile_fdfd import ACTIVITIES, window_summary

    sched = DDPMSchedule.create(1000, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = _train_batch(TRAIN_SHAPE, gen, dev)
    states = {dtype: tt.create_state(0, TRAIN_SHAPE[1:], tt.TrainConfig(compute_dtype=dtype),
                                     device=dev) for dtype in ("float32", "bfloat16")}
    for st in states.values():  # the first steps autotune cuDNN's algorithms
        _steps(st, sched, gen, batch, WARMUP, tt)
    ms, peaks = {"float32": [], "bfloat16": []}, {"float32": 0.0, "bfloat16": 0.0}
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _steps(states[dtype], sched, gen, batch, STEPS, tt)
        end.record()
        end.synchronize()
        ms[dtype].append(start.elapsed_time(end) / STEPS)
        peaks[dtype] = max(peaks[dtype], _peak_gb(dev))
    # the count depends on the shapes only
    flops = step_flops(_train_batch(TRAIN_SHAPE, torch.Generator(device=dev).manual_seed(0),
                                    dev))
    out = {"shape": list(TRAIN_SHAPE), "steps_timed": STEPS, "warmup": WARMUP,
           "order": ["float32", "bfloat16", "bfloat16", "float32"], "ms_per_step": ms,
           "flops_per_step": flops, "flops_per_step_estimate_issue": 2.04e12,
           "peak_gb_in_steps": peaks, "conv_mode": {"float32": "tf32", "bfloat16": "bfloat16"}}
    for dtype, mode in out["conv_mode"].items():
        best = min(ms[dtype])
        out[f"mfu_{dtype}_vs_{mode}_peak"] = flops / (best * 1e-3) / PEAK_FLOPS[mode]
        out[f"bound_ms_{dtype}"] = flops / PEAK_FLOPS[mode] * 1e3
    # a profiler window of 5 bf16 and 5 f32 steps
    out["profile"] = {}
    for dtype in ms:
        st = states[dtype]
        torch.cuda.synchronize(dev)
        with torch.profiler.profile(activities=ACTIVITIES) as prof:
            t0 = time.perf_counter()
            _steps(st, sched, gen, batch, 5, tt)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        path = trace.with_name(f"{trace.stem}_{dtype}.json")
        prof.export_chrome_trace(str(path))
        s = window_summary(path, wall)
        path.unlink()
        out["profile"][dtype] = {"busy_share": s["busy_share"], "wall_ms_per_step": wall * 200,
                                 "launches_per_step": s["launches"] / 5,
                                 "top_kernels": {k: round(v["total_us"] / 5, 1) for k, v in
                                                 list(s["kernels"].items())[:8]}}
    # one epoch of 64 steps over device-resident data, one host read at its end
    n = 64 * TRAIN_SHAPE[0]
    data = {k: (v.repeat(n // TRAIN_SHAPE[0], *([1] * (v.ndim - 1)))) for k, v in batch.items()}
    st = states["bfloat16"]
    perm = torch.randperm(n, generator=gen, device=dev)
    (st, loss), epoch_s = _timed(lambda: tt.train_epoch(st, sched, gen, data, perm,
                                                        batch_size=TRAIN_SHAPE[0]), dev)
    if not np.isfinite(loss):
        raise AssertionError(f"train_epoch loss {loss}")
    out["epoch_64_steps_bf16"] = {"seconds": epoch_s, "ms_per_step": epoch_s / 64 * 1e3,
                                  "mean_loss": loss}
    return out, states


# ---------------------------------------------------------------------------
# Phase 26: inference
# ---------------------------------------------------------------------------


def infer_cell(dev, state) -> dict:
    """50-step chains (deterministic, stochastic), regress and a two-member
    ensemble at TRAIN_SHAPE, in physical units through scales."""
    from fdtd2d_tpu_torch.models import train as tt
    from fdtd2d_tpu_torch.models.diffusion import DDPMSchedule

    sched = DDPMSchedule.create(1000, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    b = _train_batch(TRAIN_SHAPE, gen, dev)
    scales = {"eps": torch.tensor(3.0), "mu": torch.tensor(1.0), "Ez": torch.tensor(0.25),
              "omega": torch.tensor(1e10)}
    phys = (b["eps"] * 3.0, b["mu"], b["src"], b["omega"] * 1e10)
    out = {}
    tt.inference(state, sched, gen, *phys, num_inference_steps=5, scales=scales)  # warm-up
    for name, fn in (
            ("chain50_deterministic", lambda: tt.inference(state, sched, gen, *phys,
                                                           scales=scales, stochastic=False)),
            ("chain50_stochastic", lambda: tt.inference(state, sched, gen, *phys,
                                                        scales=scales)),
            ("regress", lambda: tt.regress(state, sched, gen, *phys, scales=scales)),
            ("ensemble2_chain50", lambda: tt.ensemble_inference(state, sched, gen, *phys,
                                                                n_members=2, scales=scales))):
        y, seconds = _timed(fn, dev)
        if not (tuple(y.shape) == TRAIN_SHAPE and bool(torch.isfinite(y).all())):
            raise AssertionError(f"{name}: shape {tuple(y.shape)} or a non-finite value")
        # denormalized: the model's O(1) output times the Ez scale
        std = float(y.std())
        if not 0 < std < 1e3 * float(scales["Ez"]):
            raise AssertionError(f"{name}: std {std} is not in physical units")
        out[name] = {"ms": seconds * 1e3, "std": std}
    return out


# ---------------------------------------------------------------------------
# Phase 27: the CLI
# ---------------------------------------------------------------------------

CLI_LINES = {
    "datagen": re.compile(r"^32 samples; worst solve residual (\S+)$", re.M),
    "train": re.compile(r"^final loss (\S+)$", re.M),
    "infer": re.compile(r"^restored epoch 1; predicted field std (\S+)$", re.M),
}


def cli_cell(workdir: Path) -> dict:
    """datagen -> train -> infer on cuda, a process each, in ``workdir``."""
    workdir.mkdir(parents=True, exist_ok=True)
    data, ckpt = str(workdir / "data.npz"), str(workdir / "ckpt")
    runs = {"datagen": ["datagen", "--size", "64", "--samples", "32", "--batch", "16",
                        "--pml", "8", "--out", data],
            "train": ["train", "--data", data, "--epochs", "2", "--batch", "8",
                      "--ckpt-dir", ckpt],
            "infer": ["infer", "--ckpt-dir", ckpt, "--data", data, "--steps", "10",
                      "--out", ""]}
    out = {}
    for name, args in runs.items():
        cmd = [sys.executable, "-m", "fdtd2d_tpu_torch.cli", *args, "--device", "cuda"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"CLI {name} exited {proc.returncode}: {proc.stderr[-2000:]}")
        m = CLI_LINES[name].search(proc.stdout)
        if not (m and np.isfinite(float(m.group(1)))):
            raise AssertionError(f"CLI {name} printed {proc.stdout!r}")
        # a plumbing check: 64^2 with PML 8 is not the configuration whose
        # residual bound (1e-5) phase 24 holds at 250^2
        if name == "datagen" and not float(m.group(1)) < 1e-4:
            raise AssertionError(f"CLI datagen residual {m.group(1)}")
        out[name] = {"process_s": seconds, "value": float(m.group(1)),
                     "stdout": proc.stdout.strip().splitlines()}
    return out


# the report's keys for an epsilon checkpoint: no one-call readout (x0 only)
READOUT_KEYS = sorted(["rel", "rel_fit", "corr", "rel_d", "rel_fit_d", "corr_d", "rel_fit_e",
                       "corr_e"] + [f"{m}_s{n}" for n in (2, 5, 10, 25)
                                    for m in ("rel_fit", "corr")])


def readout_cell(workdir: Path, holdout: int = 8) -> dict:
    """``apps.surrogate_report`` and ``apps.surrogate_diagnose`` on cuda, a
    process each, on ``cli_cell``'s dataset and checkpoint (epsilon, the
    last ``holdout`` scenes): rc 0, the report's npz keys and shapes, every
    value finite, the headline and the probes' JSON finite."""
    data, ckpt = str(workdir / "data.npz"), str(workdir / "ckpt")
    report = workdir / "report"
    runs = {"report": ["surrogate_report", data, ckpt, str(workdir / "eval"), str(report),
                       str(holdout), "epsilon"],
            "diagnose": ["surrogate_diagnose", ckpt, data, "--prediction-type", "epsilon"]}
    out = {}
    for name, (app, *args) in runs.items():
        cmd = [sys.executable, "-m", f"fdtd2d_tpu_torch.apps.{app}", *args, "--device", "cuda"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{app} exited {proc.returncode}: {proc.stderr[-2000:]}")
        last = json.loads(proc.stdout.strip().splitlines()[-1])
        out[name] = {"process_s": seconds, "last_line": last}
    rep = np.load(report / "holdout_report.npz")
    if sorted(rep.files) != READOUT_KEYS:
        raise AssertionError(f"report keys {sorted(rep.files)} != {READOUT_KEYS}")
    bad = [k for k in rep.files if rep[k].shape != (holdout,) or not np.all(np.isfinite(rep[k]))]
    plots = np.load(report / "holdout_plots.npz")
    bad += [k for k in plots.files if plots[k].dtype.kind == "f"
            and not np.all(np.isfinite(plots[k]))]
    ens = out["report"]["last_line"]["ensemble"]
    bad += [k for k, v in ens.items() if not np.isfinite(v)]
    diag = out["diagnose"]["last_line"]
    for part in ("train", "holdout"):
        bad += [f"{part}.{k}" for k, v in diag[part].items() if not np.all(np.isfinite(v))]
        if len(diag[part]["chain_corr"]) != 8 or len(diag[part]["corr"]) != len(
                diag["timesteps"]):
            bad.append(f"{part} lengths")
    if bad:
        raise AssertionError(f"readout: not finite or misshapen: {bad}")
    out["report"]["corr_mean"] = {k: float(np.mean(rep[k])) for k in rep.files
                                  if k.startswith("corr")}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parts", type=lambda s: [p for p in s.split(",") if p],
                        default=list(PARTS))
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "surrogate")
    args = parser.parse_args(argv)
    bad = [p for p in args.parts if p not in PARTS]
    if bad:
        parser.error(f"--parts must be among {PARTS}, got {bad}")
    if not torch.cuda.is_available():
        print("bench_surrogate: no CUDA device", file=sys.stderr)
        return 1
    from fdtd2d_tpu_torch.utils.metrics import device_info

    dev = torch.device("cuda:0")
    args.out.mkdir(parents=True, exist_ok=True)
    state = None
    for part in args.parts:
        t0 = time.perf_counter()
        if part == "datagen":
            res = {"parity": factor_parity(dev), "cell": datagen_cell(dev)}
        elif part == "train":
            res = {"parity": train_parity(dev)}
            res["cell"], states = train_cell(dev, args.out / "train_step.json")
            state = states["bfloat16"]
        elif part == "infer":
            if state is None:
                from fdtd2d_tpu_torch.models import train as tt

                state = tt.create_state(0, TRAIN_SHAPE[1:], tt.TrainConfig(), device=dev)
            res = infer_cell(dev, state)
        elif part == "cli":
            res = cli_cell(args.out / "cli")
        else:
            res = readout_cell(args.out / "cli")
        res["seconds"] = time.perf_counter() - t0
        print(json.dumps({part: res}), flush=True)
    print(device_info()["nvidia_smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
