"""Diagnose a trained diffusion surrogate: where does the chain lose the
scene? (counterpart of ``examples/surrogate_diagnose.py``)

Probes, per timestep t, from one model call on x_t = sqrt(ab) x0 +
sqrt(1 - ab) noise:
  - the eps-prediction MSE (the training objective, unweighted);
  - corr(x0_hat, x0), x0_hat the model's estimate of the clean field (does
    one call recover the field's structure at this noise level?);
  - the sensitivity to the scene: the same x_t with the scenes rolled by one
    sample, the relative change of the output;
on TRAIN samples (the first 8) and HOLDOUT samples (the last 8; training ran
with a holdout at the tail), then a full deterministic chain on each.

``--prediction-type`` says what the model predicts, as in training: for
``epsilon`` x0_hat = (x_t - sqrt(1 - ab) pred) / sqrt(ab) (the JAX
example's arithmetic); for ``x0`` the output is x0_hat and the eps estimate
is (x_t - sqrt(ab) pred) / sqrt(1 - ab). The draws come from one
``torch.Generator`` seeded 42, as the JAX example's key is; they differ
from JAX's.

Run: python -m fdtd2d_tpu_torch.apps.surrogate_diagnose [CKPT_DIR] [DATA]
        [--prediction-type epsilon|x0] [--device cuda|cpu]
The last line printed is one JSON object of the per-t means.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from fdtd2d_tpu_torch.apps._common import device_of
from fdtd2d_tpu_torch.apps.surrogate_report import load_scenes
from fdtd2d_tpu_torch.models.diffusion import DDPMSchedule
from fdtd2d_tpu_torch.models.train import (TrainConfig, compute_scales_host, conv_flags,
                                           create_state, inference, restore_checkpoint)

TIMESTEPS = (5, 20, 50, 100, 200, 400, 600, 800, 950, 995)
N_PROBE = 8


def _corr(a, b):
    """Per-sample Pearson correlation of (B, ...) tensors."""
    a = a.reshape(a.shape[0], -1)
    b = b.reshape(b.shape[0], -1)
    a = a - a.mean(1, keepdim=True)
    b = b - b.mean(1, keepdim=True)
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1) + 1e-30)


def probe(model, schedule: DDPMSchedule, batch: dict, t: int, noise,
          prediction_type: str = "epsilon"):
    """(eps-MSE, corr(x0_hat, x0), scene sensitivity) a sample at timestep
    ``t`` for the normalized ``batch`` and the forward noise ``noise``."""
    x0 = batch["Ez"]
    B = x0.shape[0]
    tb = torch.full((B,), t, device=x0.device)
    ab = schedule.alphas_cumprod[t]
    xt = torch.sqrt(ab) * x0 + torch.sqrt(1 - ab) * noise
    scene = [batch[k] for k in ("eps", "mu", "src")]
    with torch.no_grad(), conv_flags():
        pred = model(*scene, xt, tb, batch["omega"], train=False)
        # the scenes rolled by one sample, x_t kept
        pred_swap = model(*(torch.roll(v, 1, 0) for v in scene), xt, tb,
                          torch.roll(batch["omega"], 1, 0), train=False)
    if prediction_type == "x0":
        x0_hat, eps_hat = pred, (xt - torch.sqrt(ab) * pred) / torch.sqrt(1 - ab)
    else:
        x0_hat, eps_hat = (xt - torch.sqrt(1 - ab) * pred) / torch.sqrt(ab), pred
    mse = ((eps_hat - noise) ** 2).mean(dim=(1, 2))
    sens = ((pred_swap - pred).reshape(B, -1).norm(dim=1)
            / (pred.reshape(B, -1).norm(dim=1) + 1e-30))
    return mse, _corr(x0_hat, x0), sens


def main(ckpt_dir: str, data_path: str, prediction_type: str = "epsilon",
         device="cuda", model=None) -> dict:
    """The probes of the last checkpoint in ``ckpt_dir`` (see the module's
    docstring); returns the per-t means it prints last. ``model`` is a
    test seam: a checkpoint does not record its UNet's widths, so the tests,
    which train a narrower ``UNet2D``, pass one; the command line always
    builds the full-width one."""
    device = device_of(device) if isinstance(device, str) else device
    z = load_scenes(data_path, head=N_PROBE, tail=N_PROBE)
    config = TrainConfig()
    state = create_state(0, z["Ez"].shape[1:], config, model=model, device=device)
    state, next_epoch, scales = restore_checkpoint(ckpt_dir, state)
    if next_epoch == 0:
        raise SystemExit(f"no checkpoint in {ckpt_dir}")
    print(f"restored epoch {next_epoch - 1}; scales:",
          {k: float(v) for k, v in scales.items()} if scales else None)
    if scales is None:
        scales = compute_scales_host(z)
    scales = {k: torch.as_tensor(v).to(device=device, dtype=torch.float32)
              for k, v in scales.items()}
    schedule = DDPMSchedule.create(config.num_train_timesteps, device=device)
    gen = torch.Generator(device=device).manual_seed(42)
    sets = {"TRAIN": slice(0, N_PROBE), "HOLDOUT": slice(N_PROBE, 2 * N_PROBE)}

    def tensors(sl):
        return {k: torch.tensor(np.asarray(z[k][sl], np.float32), device=device)
                for k in ("eps", "mu", "src", "omega", "Ez")}

    out = {"epoch": next_epoch - 1, "prediction_type": prediction_type,
           "timesteps": list(TIMESTEPS)}
    for name, sl in sets.items():
        raw = tensors(sl)
        batch = {k: raw[k] / scales[k] if k in scales else raw[k] for k in raw}
        batch["omega"] = batch["omega"].reshape(-1)
        print(f"--- {name} ---")
        print(f"{'t':>5} {'eps-MSE':>9} {'corr(x0_hat,x0)':>16} {'cond-sens':>10}")
        rows = {"mse": [], "corr": [], "sens": []}
        for t in TIMESTEPS:
            noise = torch.randn(batch["Ez"].shape, generator=gen, device=device)
            vals = [float(v.mean()) for v in probe(state.model, schedule, batch, t, noise,
                                                    prediction_type)]
            for key, v in zip(rows, vals):
                rows[key].append(v)
            print(f"{t:>5} {vals[0]:>9.4f} {vals[1]:>16.4f} {vals[2]:>10.4f}")
        out[name.lower()] = rows

    # full-chain generation on each set (the reference's own eval protocol)
    for name, sl in sets.items():
        raw = tensors(sl)
        pred = inference(state, schedule, gen, raw["eps"], raw["mu"], raw["src"],
                         raw["omega"].reshape(-1), scales=scales, stochastic=False,
                         prediction_type=prediction_type)
        cs = _corr(pred.double(), raw["Ez"].double()).cpu().numpy()
        print(f"{name} full-chain (deterministic) corr: mean {np.mean(cs):.4f} "
              f"per-sample {[f'{c:.3f}' for c in cs]}")
        out[name.lower()]["chain_corr"] = [float(c) for c in cs]
    print(json.dumps(out), flush=True)
    return out


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ckpt_dir", nargs="?", default="runs/ckpt10k_torch")
    p.add_argument("data", nargs="?", default="runs/data10k_torch")
    p.add_argument("--prediction-type", default="epsilon", choices=("epsilon", "x0"),
                   help="what the checkpoint's model predicts (its training recipe)")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    args = p.parse_args(argv)
    main(args.ckpt_dir, args.data, args.prediction_type, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
