"""Post-training surrogate report: held-out metrics and panels (counterpart
of ``examples/surrogate_report.py``).

Restores the latest checkpoint of a run (weights and normalization scales),
reads it out through the EMA iterate where the checkpoint has one, and runs
on the last HOLDOUT scenes of the dataset:

- the stochastic and the deterministic 50-step chains, 8 scenes a chunk;
- the one-call ``regress`` readout (``x0`` checkpoints only);
- the posterior-mean ensemble of 8 stochastic chains, 8 scenes a chunk;
- the deterministic chain at 2, 5, 10 and 25 steps.

Each readout is scored by :func:`holdout_metrics`: the per-scene relative
L2, the amplitude-fitted relative L2 (min_a ||a pred - true|| / ||true||)
and the Pearson correlation. A ``regression`` checkpoint has no chain: one
pass is its prediction, so the chain-only readouts are skipped.

Each readout draws from its own ``torch.Generator``, seeded 123 (the chains
and the sweep), 7 (``regress``) and 1000 (the ensemble) as the JAX example's
keys are. torch's generators are not JAX's, so the draws, and with them the
stochastic readouts scene by scene, differ from the JAX example's.

Writes ``OUT_DIR/holdout_report.npz`` (the JAX example's keys) and
``OUT_DIR/holdout_plots.npz`` (the best/median/worst scenes of the best
readout and the training curves, read from ``EVAL_DIR/holdout_metrics.csv``
and the ``train100{suffix}.log`` beside EVAL_DIR). Where matplotlib is
installed it draws them as PNGs; elsewhere ``--draw OUT_DIR`` draws them
later from the npz. The last line printed is one JSON object with the
headline numbers.

Run: python -m fdtd2d_tpu_torch.apps.surrogate_report DATA CKPT_DIR EVAL_DIR
        OUT_DIR [HOLDOUT] [PRED_TYPE] [--device cuda|cpu]
     python -m fdtd2d_tpu_torch.apps.surrogate_report --draw OUT_DIR
DATA is a dataset npz (plain or compact) or a directory of shards; PRED_TYPE
("epsilon" | "x0" | "regression") must match the recipe the checkpoint was
trained with.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import re
import sys
import time

import numpy as np
import torch

from fdtd2d_tpu_torch.apps._common import device_of
from fdtd2d_tpu_torch.models.datagen import load_dataset
from fdtd2d_tpu_torch.models.diffusion import DDPMSchedule
from fdtd2d_tpu_torch.models.train import (TrainConfig, create_state, ema_state,
                                           ensemble_inference, inference, regress,
                                           restore_checkpoint)

KEYS = ("eps", "mu", "src", "omega", "Ez")
CHUNK = 8
SWEEP = (2, 5, 10, 25)
TAGS = ("best", "median", "worst")


def load_scenes(path: str, head: int = 0, tail: int = 0) -> dict:
    """The first ``head`` scenes followed by the last ``tail`` ones of a
    dataset (a plain or compact npz, or a directory of ``shard_*.npz``, of
    which only the shards that hold them are read), decoded, as numpy."""
    files = (sorted(glob.glob(os.path.join(path, "shard_*.npz"))) if os.path.isdir(path)
             else [path])
    if not files:
        raise FileNotFoundError(f"no shard_*.npz files in {path}")

    loaded = {}  # a file is decoded once, though head and tail both reach it

    def take(order, count):
        parts, n = [], 0
        for f in order:
            if n >= count:
                break
            if f not in loaded:
                d = load_dataset(f)
                loaded[f] = {k: np.asarray(d[k]) for k in KEYS}
            parts.append(loaded[f])
            n += parts[-1]["Ez"].shape[0]
        return parts, n

    head_parts, n_head = take(files, head) if head else ([], 0)
    tail_parts, n_tail = take(files[::-1], tail) if tail else ([], 0)
    if n_head < head or n_tail < tail:
        raise ValueError(f"{path} holds fewer scenes than head={head}, tail={tail}")
    out = {}
    for k in KEYS:
        pieces = []
        if head:
            pieces.append(np.concatenate([p[k] for p in head_parts])[:head])
        if tail:
            pieces.append(np.concatenate([p[k] for p in tail_parts[::-1]])[-tail:])
        out[k] = np.concatenate(pieces)
    out["omega"] = out["omega"].reshape(-1)
    return out


def holdout_metrics(pred, true):
    """Per-scene ``(rel, rel_fit, corr)`` in float64: the relative L2
    ||P - T|| / ||T||, the relative L2 after the best scalar amplitude
    a = <P, T> / <P, P>, and the Pearson correlation of P and T."""
    n = len(true)
    P = np.asarray(pred, np.float64).reshape(n, -1)
    T = np.asarray(true, np.float64).reshape(n, -1)
    tn = np.linalg.norm(T, axis=1) + 1e-30
    rel = np.linalg.norm(P - T, axis=1) / tn
    Pc = P - P.mean(axis=1, keepdims=True)
    Tc = T - T.mean(axis=1, keepdims=True)
    corr = (Pc * Tc).sum(1) / (np.linalg.norm(Pc, axis=1) * np.linalg.norm(Tc, axis=1)
                               + 1e-30)
    a = (P * T).sum(1) / ((P * P).sum(1) + 1e-30)
    rel_fit = np.linalg.norm(a[:, None] * P - T, axis=1) / tn
    return rel, rel_fit, corr


def _inputs(hold: dict, sl, device):
    return [torch.tensor(np.asarray(hold[k][sl], np.float32), device=device)
            for k in ("eps", "mu", "src", "omega")]


def chain_readout(state, schedule, hold: dict, scales, *, stochastic: bool, steps: int = 50,
                  seed: int = 123, prediction_type: str = "epsilon", draws=None) -> np.ndarray:
    """``inference`` over the scenes of ``hold`` in chunks of 8, from one
    generator seeded ``seed``. ``draws``: a list a chunk of the chain's
    (x, noises), in place of the generator's."""
    device = next(state.model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    n = len(hold["Ez"])
    preds = []
    for i, c0 in enumerate(range(0, n, CHUNK)):
        sl = slice(c0, min(c0 + CHUNK, n))
        preds.append(inference(state, schedule, gen, *_inputs(hold, sl, device),
                               num_inference_steps=steps, scales=scales,
                               stochastic=stochastic, prediction_type=prediction_type,
                               draws=None if draws is None else draws[i]).cpu().numpy())
        print(f"inferred {sl.stop}/{n} (stochastic={stochastic}, steps={steps})", flush=True)
    return np.concatenate(preds)


def regress_readout(state, schedule, hold: dict, scales, seed: int = 7, xs=None) -> np.ndarray:
    """``regress`` over the scenes of ``hold`` in chunks of 8, from one
    generator seeded ``seed``; ``xs``: a list a chunk of its input noise."""
    device = next(state.model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    n = len(hold["Ez"])
    return np.concatenate([
        regress(state, schedule, gen, *_inputs(hold, slice(c0, c0 + CHUNK), device),
                scales=scales, x=None if xs is None else xs[i]).cpu().numpy()
        for i, c0 in enumerate(range(0, n, CHUNK))])


def ensemble_readout(state, schedule, hold: dict, scales, n_members: int = 8,
                     seed: int = 1000, prediction_type: str = "epsilon",
                     draws=None) -> np.ndarray:
    """The mean of ``n_members`` stochastic 50-step chains over all the
    scenes of ``hold``, 8 a chunk, from one generator seeded ``seed``."""
    device = next(state.model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    return ensemble_inference(state, schedule, gen, *_inputs(hold, slice(None), device),
                              n_members=n_members, scales=scales,
                              prediction_type=prediction_type, chunk=CHUNK,
                              draws=draws).cpu().numpy()


def _stats(v):
    return (f"mean {np.mean(v):.4f} median {np.median(v):.4f} "
            f"best {np.min(v):.4f} worst {np.max(v):.4f}")


def _print_metrics(title, rel, rel_fit, corr):
    print(title)
    if rel is not None:
        print(f"  relative L2        : {_stats(rel)}")
    print(f"  best-fit rel L2    : {_stats(rel_fit)}")
    print(f"  Pearson corr       : mean {np.mean(corr):.4f} median {np.median(corr):.4f} "
          f"best {np.max(corr):.4f} worst {np.min(corr):.4f}")


def training_curves(eval_dir: str):
    """(losses, eval epochs, holdout mean rel-L2) of a CLI run: the losses
    from ``train100{suffix}.log`` beside ``eval_dir`` (suffix ``_shape`` or
    ``_x0`` where ``eval_dir`` ends with it; the last line of an epoch wins,
    as a resumed run logs again the epochs after its checkpoint), the
    holdout curve from ``eval_dir/holdout_metrics.csv``."""
    csv = os.path.join(eval_dir, "holdout_metrics.csv")
    by_ep = {}
    if os.path.exists(csv):
        for line in open(csv):
            f = line.strip().split(",")
            by_ep[int(f[0])] = float(f[1])
    suffix = ""
    for tag in ("_shape", "_x0"):
        if eval_dir.rstrip("/").endswith(tag):
            suffix = tag
    log = os.path.join(os.path.dirname(eval_dir.rstrip("/")), f"train100{suffix}.log")
    by_epoch = {}
    if os.path.exists(log):
        for line in open(log):
            m = re.match(r"epoch (\d+): loss ([0-9.eE+-]+)$", line.strip())
            if m:
                by_epoch[int(m.group(1))] = float(m.group(2))
    ep = sorted(by_ep)
    return ([by_epoch[e] for e in sorted(by_epoch)], ep, [by_ep[e] for e in ep])


def draw(out_dir: str) -> list:
    """The PNGs of ``out_dir/holdout_plots.npz``: the best, median and worst
    panels, and the training curves where the run logged losses. Returns
    the paths written."""
    from fdtd2d_tpu_torch.viz.plots import plot_ref_v_inference, plot_training_curves

    d = np.load(os.path.join(out_dir, "holdout_plots.npz"))
    paths = []
    for tag in TAGS:
        paths.append(os.path.join(out_dir, f"holdout_{tag}.png"))
        plot_ref_v_inference(d[f"true_{tag}"], d[f"pred_{tag}"], paths[-1])
    if d["losses"].size:
        paths.append(os.path.join(out_dir, "training_curves.png"))
        ep = d["eval_epochs"]
        plot_training_curves(list(d["losses"]), list(ep) if ep.size else None,
                             list(d["eval_rel"]) if ep.size else None, paths[-1])
    return paths


def main(data_path: str, ckpt_dir: str, eval_dir: str, out_dir: str, holdout: int = 64,
         pred_type: str = "epsilon", device="cuda", model=None) -> dict:
    """The report of the last checkpoint in ``ckpt_dir`` (see the module's
    docstring); returns the headline it prints last. ``model`` is a
    test seam: a checkpoint does not record its UNet's widths, so the tests,
    which train a narrower ``UNet2D``, pass one; the command line always
    builds the full-width one."""
    t_start = time.perf_counter()
    device = device_of(device) if isinstance(device, str) else device
    os.makedirs(out_dir, exist_ok=True)
    hold = load_scenes(data_path, tail=holdout)

    cfg = TrainConfig()
    state = create_state(0, hold["Ez"].shape[1:], cfg, model=model, device=device)
    state, epoch, scales = restore_checkpoint(ckpt_dir, state)
    if epoch == 0:
        raise SystemExit(f"no checkpoint in {ckpt_dir}")
    # EMA-trained checkpoints read out through the EMA iterate (no-op else)
    state = ema_state(state)
    print(f"restored epoch {epoch - 1}"
          + (" (EMA readout)" if state.ema_params is not None else ""))
    schedule = DDPMSchedule.create(cfg.num_train_timesteps, device=device)
    true = hold["Ez"]
    seconds = {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = time.perf_counter() - t0
        return out

    # a regression checkpoint has no chain: one deterministic pass IS the
    # prediction, so every readout below collapses to the same array
    is_reg = pred_type == "regression"
    run = dict(prediction_type=pred_type)
    pred = timed("stochastic", chain_readout, state, schedule, hold, scales, stochastic=True,
                 **run)
    pred_det = pred if is_reg else timed("deterministic", chain_readout, state, schedule,
                                         hold, scales, stochastic=False, **run)
    report = {}
    for suffix, p in (("", pred), ("_d", pred_det)):
        report.update(zip((f"rel{suffix}", f"rel_fit{suffix}", f"corr{suffix}"),
                          holdout_metrics(p, true)))
    print(f"holdout ({holdout} scenes, epoch {epoch - 1}):")
    _print_metrics("  stochastic 50-step chain:", report["rel"], report["rel_fit"],
                   report["corr"])
    _print_metrics("  deterministic (DDIM-like) chain:", report["rel_d"], report["rel_fit_d"],
                   report["corr_d"])
    cands = {"det-chain-50": (pred_det, report["rel_fit_d"])}

    if pred_type == "x0":
        # the network's direct E[x0 | scene] at t = T-1, no chain
        pred_reg = timed("regress", regress_readout, state, schedule, hold, scales)
        report.update(zip(("rel_r", "rel_fit_r", "corr_r"), holdout_metrics(pred_reg, true)))
        _print_metrics("  one-call regression readout (no chain):", report["rel_r"],
                       report["rel_fit_r"], report["corr_r"])
        cands["regression"] = (pred_reg, report["rel_fit_r"])

    # posterior-mean ensemble: the task is deterministic, so the L2-optimal
    # readout is E[x0 | scene]; averaging K chains cancels the sampling variance
    K = 1 if is_reg else 8
    ens = timed("ensemble", ensemble_readout, state, schedule, hold, scales, n_members=K, **run)
    _, report["rel_fit_e"], report["corr_e"] = holdout_metrics(ens, true)
    _print_metrics(f"  ensemble mean of {K} stochastic chains:", None, report["rel_fit_e"],
                   report["corr_e"])
    cands[f"ensemble-{K}"] = (ens, report["rel_fit_e"])

    # chain-length sweep (deterministic): short chains can beat 50 steps, the
    # late high-noise steps only adding sampling variance
    for steps in () if is_reg else SWEEP:
        ps = timed(f"sweep{steps}", chain_readout, state, schedule, hold, scales,
                   stochastic=False, steps=steps, **run)
        _, rf, cs = holdout_metrics(ps, true)
        print(f"  det chain, {steps:2d} steps: best-fit rel L2 mean {np.mean(rf):.4f} "
              f"median {np.median(rf):.4f}; corr mean {np.mean(cs):.4f}")
        report[f"rel_fit_s{steps}"], report[f"corr_s{steps}"] = rf, cs
    np.savez(os.path.join(out_dir, "holdout_report.npz"), **report)

    # panels from the best readout (lowest mean amplitude-fitted rel-L2)
    best_name = min(cands, key=lambda k: np.mean(cands[k][1]))
    panel_pred, panel_rel = cands[best_name]
    order = np.argsort(panel_rel)
    picks = dict(zip(TAGS, (order[0], order[holdout // 2], order[-1])))
    losses, eval_epochs, eval_rel = training_curves(eval_dir)
    np.savez(os.path.join(out_dir, "holdout_plots.npz"), readout=best_name,
             losses=np.asarray(losses, np.float64), eval_epochs=np.asarray(eval_epochs, int),
             eval_rel=np.asarray(eval_rel, np.float64),
             **{f"{w}_{tag}": v for tag, i in picks.items()
                for w, v in (("true", true[i]), ("pred", panel_pred[i]), ("index", i))})
    if importlib.util.find_spec("matplotlib") is None:
        print(f"matplotlib is not installed: panels not drawn (python -m "
              f"fdtd2d_tpu_torch.apps.surrogate_report --draw {out_dir} draws them)")
    else:
        print(f"wrote {', '.join(os.path.basename(p) for p in draw(out_dir))} to {out_dir} "
              f"(readout: {best_name}; {len(losses)} epochs of losses)")

    ce = report["corr_e"]
    headline = {
        "epoch": epoch - 1, "holdout": holdout, "prediction_type": pred_type,
        "ensemble": {"members": K, "corr_mean": float(np.mean(ce)),
                     "corr_median": float(np.median(ce)), "corr_best": float(np.max(ce)),
                     "rel_fit_mean": float(np.mean(report["rel_fit_e"]))},
        "one_call_corr_mean": (float(np.mean(report["corr_r"])) if "corr_r" in report
                               else None),
        "det50_corr_mean": float(np.mean(report["corr_d"])), "panels_readout": best_name,
        "readout_seconds": seconds, "seconds": time.perf_counter() - t_start}
    print(json.dumps(headline), flush=True)
    return headline


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("data", nargs="?", default="runs/data10k_torch")
    p.add_argument("ckpt_dir", nargs="?", default="runs/ckpt10k_torch")
    p.add_argument("eval_dir", nargs="?", default="runs/eval10k_torch")
    p.add_argument("out_dir", nargs="?", default="assets/surrogate_torch")
    p.add_argument("holdout", nargs="?", type=int, default=64)
    p.add_argument("pred_type", nargs="?", default="epsilon",
                   choices=("epsilon", "x0", "regression"))
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--draw", metavar="OUT_DIR", default=None,
                   help="only draw the PNGs of OUT_DIR/holdout_plots.npz")
    args = p.parse_args(argv)
    if args.draw:
        for path in draw(args.draw):
            print(f"wrote {path}")
        return 0
    main(args.data, args.ckpt_dir, args.eval_dir, args.out_dir, args.holdout, args.pred_type,
         args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
