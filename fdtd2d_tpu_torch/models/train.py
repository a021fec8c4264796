"""Diffusion-surrogate training: steps, epochs, checkpoints with resume, eval.

Counterpart of ``fdtd2d_tpu/models/train.py`` (reference training loop:
AdamW lr 3e-5, batch 8, SNR^1.3 importance-sampled timesteps, SNR^5-weighted
noise-prediction MSE, checkpoints every 10 epochs). Where the JAX module
compiles a step with ``jit`` and an epoch with ``lax.scan``, the port runs
Python loops of torch ops on device-resident data; an epoch reads its losses
from the device once, at its end.

Departures from a straight transcription, each to match the JAX package:

- AdamW is optax's ``adamw(lr)``: weight decay 1e-4 on every parameter
  (torch's default is 1e-2), b1 0.9, b2 0.999, eps 1e-8.
- Population standard deviations (``correction=0``) in :func:`compute_scales`,
  as ``jnp.std``.
- The EMA warm-up min(decay, (1+step)/(10+step)) in float32, with the step
  counter already incremented.

Convolutions: float32 runs cuDNN with TF32 allowed (torch's default for
cuDNN), set for each call by :func:`conv_flags` around the forward and the
backward pass, so a global setting elsewhere does not change it: the card
runs float32 convolutions on its tensor cores with a 10-bit mantissa.
``compute_dtype="bfloat16"`` runs the conv and dense math under bf16
autocast; parameters, BatchNorm statistics, the 1x1 head, the loss and the
Adam state stay float32 (models/unet.py).

Randomness: a ``torch.Generator`` on the data's device; the draws of a step
(timesteps, noise, D4 elements: :func:`step_draws`) are made apart from the
step that takes them. Checkpoints are ``torch.save`` files read back with
``torch.load(weights_only=True)``; the port reads its own checkpoints, not the
JAX package's orbax directories.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fdtd2d_tpu_torch.models import datagen as _dg
from fdtd2d_tpu_torch.models.augment import augment_batch, augment_draws
from fdtd2d_tpu_torch.models.diffusion import (DDPMSchedule, importance_sample_timesteps,
                                               loss_weight, sample)
from fdtd2d_tpu_torch.models.unet import UNet2D

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def conv_flags():
    """cuDNN settings for one call of the UNet, forward and backward: TF32
    allowed (peak 495 TFLOP/s on an H100 against 67 for float32 outside the
    tensor cores), autotuned algorithms (a run's shapes repeat)."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=True, deterministic=False,
                                      allow_tf32=True)


@dataclasses.dataclass
class TrainState:
    """The module, its AdamW optimizer (None for a read-only state), the
    step count and an EMA copy of the parameters by name (None when EMA is
    off). The step and the EMA update in place."""
    model: UNet2D
    optimizer: Optional[torch.optim.Optimizer]
    step: int = 0
    ema_params: Optional[dict] = None


def compute_scales(data: dict) -> dict:
    """Normalization constants of the physical channels (inputs to O(1), Ez
    labels to unit std, which the DDPM math assumes), 0-d tensors."""
    return {
        "eps": data["eps"].mean(),
        "mu": data["mu"].mean(),
        "Ez": data["Ez"].std(correction=0) + 1e-30,
        "omega": torch.tensor(1e10, dtype=data["omega"].dtype, device=data["omega"].device),
    }


def compute_scales_host(data: dict) -> dict:
    """:func:`compute_scales` of host numpy arrays, each scale in its array's
    dtype."""
    def s(key, stat):
        v = np.asarray(data[key])
        return torch.tensor(np.asarray(stat(v), v.dtype))

    return {"eps": s("eps", np.mean), "mu": s("mu", np.mean),
            "Ez": s("Ez", lambda a: np.std(a) + 1e-30),
            "omega": torch.tensor(np.asarray(1e10, np.asarray(data["omega"]).dtype))}


def normalize(data: dict, scales: dict) -> dict:
    out = dict(data)
    for k in ("eps", "mu", "Ez", "omega"):
        if k in out:
            out[k] = out[k] / scales[k]
    return out


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-5
    batch_size: int = 8
    num_epochs: int = 100
    snr_weight_gamma: float = 5.0
    timestep_gamma: float = 1.3
    num_train_timesteps: int = 1000
    ckpt_every: int = 10
    ckpt_dir: Optional[str] = None
    # the reference's recipe is (epsilon, snr, snr_gamma); the one that
    # generates scene-locked fields is (x0, uniform, uniform); "regression"
    # trains the UNet as a plain supervised surrogate (t pinned to 0)
    prediction_type: str = "epsilon"   # "epsilon" | "x0" | "regression"
    t_sampling: str = "snr"            # "snr" (SNR^1.3 importance) | "uniform"
    loss_weighting: str = "snr_gamma"  # "snr_gamma" | "min_snr" | "uniform"
    ema_decay: float = 0.0             # 0 disables the EMA
    augment: bool = False              # exact D4 augmentation (models/augment.py)
    compute_dtype: str = "float32"     # "float32" | "bfloat16"


def _cpu_generator(seed_or_generator) -> torch.Generator:
    g = seed_or_generator
    if isinstance(g, torch.Generator):
        if g.device.type == "cpu":
            return g
        g = int(torch.randint(0, 2**62, (1,), generator=g, device=g.device))
    return torch.Generator().manual_seed(int(g))


def create_state(seed_or_generator, shape: Tuple[int, int], config: TrainConfig,
                 model: Optional[UNet2D] = None, device="cuda") -> TrainState:
    """A fresh state: the UNet (``model``, re-initialized, or the full-width
    one at the config's compute dtype) with Flax's initialization drawn on
    the CPU from the seed, so a seed gives the same weights on every device;
    AdamW as optax's ``adamw(lr)``. ``shape`` is taken for the JAX
    signature's sake (the port needs no trace to size the parameters)."""
    del shape
    gen = _cpu_generator(seed_or_generator)
    if model is None:
        model = UNet2D(dtype=_DTYPES[config.compute_dtype], generator=gen)
    else:
        model.reset_parameters(gen)
    model = model.to(device)
    opt = torch.optim.AdamW(model.parameters(), lr=config.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if config.ema_decay > 0 else None)
    return TrainState(model=model, optimizer=opt, step=0, ema_params=ema)


def ema_state(state: TrainState) -> TrainState:
    """The state to READ the model from: a copy of the module holding the EMA
    parameters when EMA is on (training goes on from the raw parameters);
    ``state`` itself otherwise."""
    if state.ema_params is None:
        return state
    model = copy.deepcopy(state.model)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(state.ema_params[n])
    return TrainState(model=model, optimizer=None, step=state.step,
                      ema_params=state.ema_params)


class StepDraws(NamedTuple):
    """The random inputs of one train step: timesteps (B,), noise (B, H, W)
    and D4 elements (B,) (None where the recipe takes none)."""
    t: Optional[torch.Tensor]
    noise: Optional[torch.Tensor]
    g: Optional[torch.Tensor]


def step_draws(generator: torch.Generator, schedule: DDPMSchedule, shape, *,
               t_gamma: float = 1.3, prediction_type: str = "epsilon",
               t_sampling: str = "snr", augment: bool = False) -> StepDraws:
    """The draws of one train step on a (B, H, W) batch, on the generator's
    device."""
    B, dev = shape[0], generator.device
    g = augment_draws(generator, B) if augment else None
    if prediction_type == "regression":
        return StepDraws(None, None, g)
    if t_sampling == "uniform":
        t = torch.randint(0, schedule.num_timesteps, (B,), generator=generator, device=dev)
    else:
        t = importance_sample_timesteps(schedule, generator, B, gamma=t_gamma)
    return StepDraws(t, torch.randn(shape, generator=generator, device=dev), g)


def train_step(state: TrainState, schedule: DDPMSchedule, generator, batch: dict, *,
               snr_gamma: float = 5.0, t_gamma: float = 1.3,
               prediction_type: str = "epsilon", t_sampling: str = "snr",
               weighting: str = "snr_gamma", ema_decay: float = 0.0,
               augment: bool = False, draws: Optional[StepDraws] = None):
    """One weighted denoising step; returns ``(state, loss)``, the loss a 0-d
    float32 tensor on the device (no host read). ``draws``: the step's
    random inputs (:func:`step_draws`), drawn from ``generator`` when None."""
    if draws is None:
        draws = step_draws(generator, schedule, batch["Ez"].shape, t_gamma=t_gamma,
                           prediction_type=prediction_type, t_sampling=t_sampling,
                           augment=augment)
    state.optimizer.zero_grad(set_to_none=True)
    with conv_flags():
        per_sample = per_sample_loss(state, schedule, batch, draws, snr_gamma=snr_gamma,
                                     prediction_type=prediction_type, weighting=weighting,
                                     augment=augment)
        loss = torch.mean(per_sample).to(torch.float32)
        loss.backward()
    apply_update(state, ema_decay)
    return state, loss.detach()


def per_sample_loss(state: TrainState, schedule: DDPMSchedule, batch: dict, draws: StepDraws,
                    *, snr_gamma: float = 5.0, prediction_type: str = "epsilon",
                    weighting: str = "snr_gamma", augment: bool = False) -> torch.Tensor:
    """The forward half of a train step: the batch (augmented by the draws'
    D4 elements), noised, through the model in train mode; returns each
    sample's weighted loss (B,), in the graph."""
    Ez = batch["Ez"]
    if augment:
        batch = augment_batch(None, batch, g=draws.g)
        Ez = batch["Ez"]
    if prediction_type == "regression":
        # plain supervised surrogate: no noising, t pinned to 0, plain MSE
        t = torch.zeros((Ez.shape[0],), dtype=torch.int64, device=Ez.device)
        noisy, target = torch.zeros_like(Ez), Ez
    else:
        t = draws.t
        noisy = schedule.add_noise(Ez, draws.noise, t)
        target = Ez if prediction_type == "x0" else draws.noise
    pred = state.model(batch["eps"], batch["mu"], batch["src"], noisy, t, batch["omega"],
                       train=True)
    per_sample = torch.mean((pred - target) ** 2, dim=(1, 2))
    if prediction_type != "regression":
        per_sample = loss_weight(schedule, t, weighting, prediction_type,
                                 gamma=snr_gamma) * per_sample
    return per_sample


def apply_update(state: TrainState, ema_decay: float = 0.0) -> None:
    """The update half of a train step, from the gradients in place: AdamW,
    the step count and the EMA."""
    state.optimizer.step()
    state.step += 1
    if ema_decay > 0 and state.ema_params is not None:
        # decay warm-up: the EMA starts at the random init, so a flat 0.999
        # would leave the first few thousand steps' readouts to init noise
        s = np.float32(state.step)
        eff = np.minimum(np.float32(ema_decay), (np.float32(1) + s) / (np.float32(10) + s))
        ema = list(state.ema_params.values())
        params = [p.detach() for p in state.model.parameters()]
        torch._foreach_mul_(ema, float(eff))
        torch._foreach_add_(ema, params, alpha=float(np.float32(1) - eff))


def _decode_batch(data: dict, idx, affine: dict, const: dict) -> dict:
    """One batch of device-resident data, decoded to float32 on the device:
    bit-packed eps (``eps_bits``, first pixel in the MSB), source boxes
    (``src_box``, inclusive (r0, r1, c0, c1)), ``affine`` (scale, offset) of
    0/1 masks and ``const`` channels that are not stored."""
    B = idx.shape[0]
    hw = tuple(data["Ez"].shape[1:])
    batch = {name: v[idx].to(torch.float32) for name, v in data.items()
             if name not in ("eps_bits", "src_box")}
    if "eps_bits" in data:
        bits = data["eps_bits"][idx]                                  # (B, H, W//8) u8
        shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
        px = (bits[..., None] >> shifts) & 1
        batch["eps"] = px.reshape((B,) + hw).to(torch.float32)
    if "src_box" in data:
        box = data["src_box"][idx]                                    # (B, 4) int32
        dev = box.device
        rows = torch.arange(hw[0], device=dev)[None, :, None]
        cols = torch.arange(hw[1], device=dev)[None, None, :]
        r0, r1, c0, c1 = (box[:, i, None, None] for i in range(4))
        batch["src"] = ((rows >= r0) & (rows <= r1) & (cols >= c0)
                        & (cols <= c1)).to(torch.float32)
    for name, (sc, off) in (affine or {}).items():
        batch[name] = batch[name] * sc + off
    for name, c in (const or {}).items():
        batch[name] = torch.full((B,) + hw, c, dtype=torch.float32, device=idx.device)
    return batch


def train_epoch(state: TrainState, schedule: DDPMSchedule, generator, data: dict, perm, *,
                batch_size: int, snr_gamma: float = 5.0, t_gamma: float = 1.3,
                prediction_type: str = "epsilon", t_sampling: str = "snr",
                weighting: str = "snr_gamma", ema_decay: float = 0.0,
                augment: bool = False, affine: Optional[dict] = None,
                const: Optional[dict] = None):
    """One epoch over device-resident ``data`` in the order ``perm``; returns
    ``(state, mean loss)``, the losses read from the device once, at the end.
    The tail partial batch is dropped (shuffled each epoch, so a different
    one each time)."""
    n = perm.shape[0]
    if batch_size > n:
        raise ValueError(
            f"batch_size={batch_size} exceeds dataset size {n}; an epoch "
            "would contain zero batches (mean over zero losses is NaN)")
    losses = []
    for k in range(n // batch_size):
        batch = _decode_batch(data, perm[k * batch_size:(k + 1) * batch_size], affine, const)
        state, loss = train_step(state, schedule, generator, batch, snr_gamma=snr_gamma,
                                 t_gamma=t_gamma, prediction_type=prediction_type,
                                 t_sampling=t_sampling, weighting=weighting,
                                 ema_decay=ema_decay, augment=augment)
        losses.append(loss)
    return state, float(torch.stack(losses).mean())


def _normalized_inputs(eps, mu, omega, scales):
    if scales is None:
        return eps, mu, omega
    return eps / scales["eps"], mu / scales["mu"], omega / scales["omega"]


def inference(state: TrainState, schedule: DDPMSchedule, generator, eps, mu, src, omega,
              num_inference_steps: int = 50, scales: Optional[dict] = None,
              stochastic: bool = True, prediction_type: str = "epsilon",
              t_start: Optional[int] = None, draws=None):
    """Denoise from pure noise. With ``scales`` the physical inputs are
    normalized and the field is returned in physical units.
    ``stochastic=False`` runs the deterministic chain; ``regression``
    checkpoints take one forward pass at t = 0 on a zero field. ``draws``:
    the sampler's (x, noises) (models/diffusion.py ``sample_draws``)."""
    eps, mu, omega = _normalized_inputs(eps, mu, omega, scales)
    model = state.model

    def apply_fn(e, m, s, x, t, om):
        return model(e, m, s, x, t, om, train=False)

    with torch.no_grad(), conv_flags():
        if prediction_type == "regression":
            out = apply_fn(eps, mu, src, torch.zeros_like(eps),
                           torch.zeros((eps.shape[0],), dtype=torch.int64,
                                       device=eps.device), omega)
        else:
            out = sample(schedule, apply_fn, generator, eps, mu, src, omega,
                         num_inference_steps=num_inference_steps, stochastic=stochastic,
                         prediction_type=prediction_type, t_start=t_start, draws=draws)
    return out * scales["Ez"] if scales is not None else out


def regress(state: TrainState, schedule: DDPMSchedule, generator, eps, mu, src, omega,
            scales: Optional[dict] = None, x=None):
    """Single-call readout of an x0-prediction model: one forward pass at
    t = T-1 on pure noise (``x``, drawn from ``generator`` when None), the
    model's direct estimate of E[x0 | scene]."""
    eps, mu, omega = _normalized_inputs(eps, mu, omega, scales)
    if x is None:
        x = torch.randn(eps.shape, generator=generator, device=generator.device,
                        dtype=eps.dtype)
    t = torch.full((eps.shape[0],), schedule.num_timesteps - 1, device=eps.device)
    with torch.no_grad(), conv_flags():
        out = state.model(eps, mu, src, x.to(eps.device), t, omega, train=False)
    return out * scales["Ez"] if scales is not None else out


def ensemble_inference(state: TrainState, schedule: DDPMSchedule, generator, eps, mu, src,
                       omega, n_members: int = 8, num_inference_steps: int = 50,
                       scales: Optional[dict] = None, prediction_type: str = "epsilon",
                       chunk: int = 0):
    """Posterior-mean readout: the mean of ``n_members`` independent
    stochastic chains. ``chunk > 0`` runs the batch in slices of ``chunk``
    samples, so only that many samples' activations are live at once; the
    slices draw their own noise, so chunked and unchunked results agree in
    distribution, not bit for bit."""
    B = eps.shape[0]
    out = None
    for _ in range(n_members):
        step = chunk if chunk and chunk < B else B
        member = torch.cat([
            inference(state, schedule, generator, eps[c0:c0 + step], mu[c0:c0 + step],
                      src[c0:c0 + step], omega[c0:c0 + step],
                      num_inference_steps=num_inference_steps, scales=scales,
                      stochastic=True, prediction_type=prediction_type)
            for c0 in range(0, B, step)])
        out = member if out is None else out + member
    return out / n_members


# ---------------------------------------------------------------------------
# Checkpoints: save AND restore
# ---------------------------------------------------------------------------


def _ckpt_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"epoch_{epoch:05d}.pt")


def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int,
                    scales: Optional[dict] = None) -> None:
    """Persist the train state with the dataset normalization scales (part of
    the model's contract: inference divides inputs and multiplies outputs by
    the training-time constants). Atomic: a temporary file, then a rename."""
    os.makedirs(ckpt_dir, exist_ok=True)
    model = state.model
    payload = {
        "params": {n: p.detach() for n, p in model.named_parameters()},
        "batch_stats": {n: b for n, b in model.named_buffers()},
        "opt_state": state.optimizer.state_dict(),
        "step": state.step, "epoch": epoch,
    }
    if scales is not None:
        payload["scales"] = {k: torch.as_tensor(v).detach().cpu().to(torch.float32)
                             for k, v in scales.items()}
    if state.ema_params is not None:
        payload["ema_params"] = dict(state.ema_params)
    path = _ckpt_path(ckpt_dir, epoch)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)


def restore_checkpoint(ckpt_dir: str, state: TrainState):
    """Restore the latest checkpoint into ``state``; returns (state,
    next_epoch, scales). ``scales`` is None for a checkpoint without them
    (with a warning: inference then needs them from the original data). A
    stored EMA is restored even into a state without one (the ``infer``
    path reads through it); a state with an EMA restored from a checkpoint
    without one re-seeds it from the restored parameters, with a warning."""
    if not os.path.isdir(ckpt_dir):
        return state, 0, None
    epochs = sorted(int(f[len("epoch_"):-len(".pt")]) for f in os.listdir(ckpt_dir)
                    if f.startswith("epoch_") and f.endswith(".pt"))
    if not epochs:
        return state, 0, None
    epoch = epochs[-1]
    path = _ckpt_path(ckpt_dir, epoch)
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    if "scales" not in payload:
        warnings.warn(
            f"checkpoint {path} has no normalization scales; inference against it must "
            "recompute scales from the ORIGINAL training data or fields will be mis-scaled",
            stacklevel=2)
    if "ema_params" not in payload and state.ema_params is not None:
        warnings.warn(f"checkpoint {path} has no EMA params; re-seeding the EMA from the "
                      "restored raw params", stacklevel=2)
    state.model.load_state_dict({**payload["params"], **payload["batch_stats"]})
    if state.optimizer is not None:
        saved = payload["opt_state"]
        # the run's own hyperparameters (lr, decay) win over the stored ones,
        # as optax keeps them in the transform and only moments in the state
        saved["param_groups"] = [{**g, "params": sg["params"]} for sg, g in
                                 zip(saved["param_groups"], state.optimizer.param_groups)]
        state.optimizer.load_state_dict(saved)
    state.step = int(payload["step"])
    if "ema_params" in payload:
        state.ema_params = dict(payload["ema_params"])
    elif state.ema_params is not None:
        state.ema_params = {n: p.detach().clone() for n, p in payload["params"].items()}
    return state, epoch + 1, payload.get("scales")


def holdout_relative_l2(state: TrainState, schedule: DDPMSchedule, generator, holdout: dict,
                        scales: dict, num_inference_steps: int = 50, chunk: int = 8,
                        prediction_type: str = "epsilon") -> np.ndarray:
    """Per-sample relative L2 of the predicted vs the true Ez (physical
    units) on a holdout set of host arrays, inference in ``chunk``-sample
    slices so a large holdout does not evict a device-resident dataset."""
    device = next(state.model.parameters()).device
    n = np.asarray(holdout["Ez"]).shape[0]

    def dev(k, sl):
        return torch.tensor(np.asarray(holdout[k][sl], np.float32), device=device)

    preds = []
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(c0 + chunk, n))
        preds.append(inference(
            state, schedule, generator, dev("eps", sl), dev("mu", sl), dev("src", sl),
            dev("omega", sl).reshape(-1), num_inference_steps=num_inference_steps,
            scales=scales, prediction_type=prediction_type).cpu().numpy())
    pred = np.concatenate(preds)
    true = np.asarray(holdout["Ez"])
    num = np.linalg.norm((pred - true).reshape(len(true), -1), axis=1)
    den = np.linalg.norm(true.reshape(len(true), -1), axis=1) + 1e-30
    return num / den


# ---------------------------------------------------------------------------
# The epoch loop
# ---------------------------------------------------------------------------


def _compact_cache(raw: dict, scales, device):
    """The "compact" device cache of the datagen distribution: eps
    bit-packed (or a uint8 mask where W % 8), sources as boxes (or uint8
    masks where a source is not an axis-aligned box), Ez float16 at unit
    std, mu not stored. Returns (scales, arrays, affine, const)."""
    if scales is None:
        # every statistic from the masks' structure: never decode the full
        # float32 channels on the host; Ez moments in chunks, in float64
        frac_hi = float(np.mean(raw["eps_mask"], dtype=np.float64))
        ez = np.asarray(raw["Ez"])
        cn = max(1, ez.shape[0] // 64)
        s1 = s2 = 0.0
        for c0 in range(0, ez.shape[0], cn):
            c = np.asarray(ez[c0:c0 + cn], np.float64)
            s1 += float(np.sum(c))
            s2 += float(np.sum(c * c))
        std = float(np.sqrt(max(s2 / ez.size - (s1 / ez.size) ** 2, 0.0)))
        scales = {"eps": _dg.EPS_LO + frac_hi * (_dg.EPS_HI - _dg.EPS_LO),
                  "mu": _dg.MU_REF, "Ez": std + 1e-30, "omega": 1e10}
    scales = {k: torch.tensor(float(v), dtype=torch.float32) for k, v in scales.items()}
    lo = float(_dg.EPS_LO / float(scales["eps"]))
    hi = float(_dg.EPS_HI / float(scales["eps"]))
    affine = {"eps": (hi - lo, lo)}   # src decodes to its raw 0/1 values
    const = {"mu": float(_dg.MU_REF / float(scales["mu"]))}
    ez16 = np.empty(raw["Ez"].shape, np.float16)
    inv = np.float32(1.0 / float(scales["Ez"]))
    for c0 in range(0, ez16.shape[0], 4096):
        ez16[c0:c0 + 4096] = np.asarray(raw["Ez"][c0:c0 + 4096]) * inv
    host = {"omega": np.asarray(raw["omega"], np.float32) / np.float32(float(scales["omega"])),
            "Ez": ez16}
    eps_mask = np.ascontiguousarray(raw["eps_mask"])
    H, W = eps_mask.shape[1:]
    if W % 8 == 0:
        host["eps_bits"] = np.packbits(eps_mask, axis=-1)
    else:
        host["eps"] = eps_mask
    src_mask = np.asarray(raw["src_mask"])
    rows_any, cols_any = src_mask.any(axis=2), src_mask.any(axis=1)
    r0 = rows_any.argmax(1)
    r1 = H - 1 - rows_any[:, ::-1].argmax(1)
    c0 = cols_any.argmax(1)
    c1 = W - 1 - cols_any[:, ::-1].argmax(1)
    area = (r1 - r0 + 1).astype(np.int64) * (c1 - c0 + 1)
    boxy = bool(np.all(src_mask.any(axis=(1, 2))
                       & (area == src_mask.sum(axis=(1, 2), dtype=np.int64))))
    if boxy:
        host["src_box"] = np.stack([r0, r1, c0, c1], 1).astype(np.int32)
    else:
        host["src"] = np.ascontiguousarray(src_mask)
    arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()}
    return scales, arrays, affine, const


def train(seed_or_generator, data: dict, config: TrainConfig,
          state: Optional[TrainState] = None, eval_every: int = 0, eval_callback=None,
          callback=None, stream_chunk: int = 0, holdout: int = 0, holdout_callback=None,
          device_dtype=None, device="cuda"):
    """Epoch loop over a dataset dict (eps/mu/src/omega/Ez: host numpy or
    tensors). Returns ``(state, losses, scales)``.

    Resumes from ``config.ckpt_dir`` when it holds checkpoints, with their
    normalization scales. ``eval_every``/``eval_callback``: every N epochs a
    full chain on one sample, ``eval_callback(epoch, predicted, true)`` in
    physical units. ``holdout``: withhold the LAST ``holdout`` samples and
    report their per-sample relative L2 every ``eval_every`` epochs
    (``holdout_callback(epoch, rel)``, or a printed line).

    Where the data lives: by default all of it on ``device`` in float32.
    ``stream_chunk`` (a multiple of the batch size) keeps it on the host and
    moves shuffled chunks of that many samples per ``train_epoch`` call.
    ``device_dtype=torch.float16`` keeps the normalized eps/mu/src on the
    device in float16 (exact for binary/mask channels), Ez and omega
    float32. ``device_dtype="compact"`` takes the raw dict of
    ``load_dataset(path, decode=False)`` and keeps bit-packed eps, source
    boxes and float16 Ez on the device (:func:`_compact_cache`)."""
    gen = (seed_or_generator if isinstance(seed_or_generator, torch.Generator)
           else torch.Generator(device=device).manual_seed(int(seed_or_generator)))
    schedule = DDPMSchedule.create(config.num_train_timesteps, device=device)
    if state is None:
        state = create_state(seed_or_generator, data["Ez"].shape[1:], config, device=device)
    start_epoch, ckpt_scales = 0, None
    if config.ckpt_dir:
        state, start_epoch, ckpt_scales = restore_checkpoint(config.ckpt_dir, state)
        if config.ema_decay == 0 and state.ema_params is not None:
            # train_step would never update a restored EMA while every
            # readout reads through it: drop it
            warnings.warn(
                "resuming with ema_decay=0 from a checkpoint that carries EMA params: "
                "discarding the stored EMA so readouts follow the training params "
                "(pass --ema-decay to keep updating it)", stacklevel=2)
            state.ema_params = None

    compact = isinstance(device_dtype, str) and device_dtype == "compact"
    raw = {k: v for k, v in data.items() if k not in ("residuals", "compact_version")}
    if compact and "eps_mask" not in raw:
        raise ValueError('device_dtype="compact" needs the RAW compact dict — load with '
                         "load_dataset(path, decode=False)")
    if compact and stream_chunk:
        raise ValueError("stream_chunk and the compact device cache are alternatives; "
                         "choose one")
    holdout_set = None
    if holdout > 0:
        if holdout >= data["Ez"].shape[0]:
            raise ValueError(f"holdout={holdout} swallows the whole dataset")
        holdout_set = {k: _host(v[-holdout:]) for k, v in raw.items()}
        if "eps_mask" in holdout_set:
            holdout_set = _dg._decode_compact(holdout_set)
        raw = {k: v[:-holdout] for k, v in raw.items()}
    n = raw["Ez"].shape[0]
    affine = const = None
    if stream_chunk:
        if stream_chunk % config.batch_size:
            raise ValueError(f"stream_chunk={stream_chunk} must be a multiple of "
                             f"batch_size={config.batch_size}")
        if stream_chunk > n:
            # the largest whole-batch chunk: a chunk past the dataset would
            # run no chunk and report the mean of no losses
            stream_chunk = (n // config.batch_size) * config.batch_size
            if stream_chunk == 0:
                raise ValueError(f"dataset size {n} is smaller than one batch "
                                 f"({config.batch_size})")
        scales = ckpt_scales or compute_scales_host({k: _host(v) for k, v in raw.items()})
        arrays = None
    elif compact:
        scales, arrays, affine, const = _compact_cache(raw, ckpt_scales, device)
    elif device_dtype is not None:
        scales = ckpt_scales or compute_scales_host({k: _host(v) for k, v in raw.items()})
        arrays = {}
        for k in ("eps", "mu", "src", "omega", "Ez"):
            v = np.asarray(_host(raw[k]), np.float32)
            if k in scales:
                v = v / np.float32(float(scales[k]))
            tgt = torch.float32 if k in ("Ez", "omega") else device_dtype
            arrays[k] = torch.from_numpy(v).to(tgt).to(device)
    else:
        dev_raw = {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(_host(v)))
                   .to(device=device, dtype=torch.float32) for k, v in raw.items()}
        scales = ckpt_scales or compute_scales(dev_raw)
        arrays = normalize(dev_raw, scales)
    scales = {k: torch.as_tensor(v).to(device=device, dtype=torch.float32)
              for k, v in scales.items()}

    eval_sample = None
    if eval_every > 0 and eval_callback is not None:
        src_set = holdout_set if holdout_set is not None else raw
        if "eps_mask" in src_set:
            src_set = _dg._decode_compact({k: _host(v[:1]) for k, v in src_set.items()})
        eval_sample = {k: _host(src_set[k][0]) for k in ("eps", "mu", "src", "omega", "Ez")}

    ep_kwargs = dict(batch_size=config.batch_size, snr_gamma=config.snr_weight_gamma,
                     t_gamma=config.timestep_gamma, prediction_type=config.prediction_type,
                     t_sampling=config.t_sampling, weighting=config.loss_weighting,
                     ema_decay=config.ema_decay, augment=config.augment)
    losses = []
    for epoch in range(start_epoch, config.num_epochs):
        if stream_chunk:
            perm = torch.randperm(n, generator=gen, device=gen.device).cpu().numpy()
            chunk_losses = []
            for c0 in range(0, n - stream_chunk + 1, stream_chunk):
                idx = perm[c0:c0 + stream_chunk]
                dev = {k: torch.from_numpy(_host(v)[idx]).to(device=device,
                                                              dtype=torch.float32)
                       for k, v in raw.items()}
                state, loss = train_epoch(state, schedule, gen, normalize(dev, scales),
                                          torch.arange(stream_chunk, device=device),
                                          **ep_kwargs)
                chunk_losses.append(loss)
            mean_loss = float(np.mean(chunk_losses))
        else:
            perm = torch.randperm(n, generator=gen, device=gen.device).to(device)
            state, mean_loss = train_epoch(state, schedule, gen, arrays, perm,
                                           affine=affine, const=const, **ep_kwargs)
        losses.append(mean_loss)
        if callback:
            callback(epoch, losses[-1], state)
        if eval_sample is not None and (epoch + 1) % eval_every == 0:
            def one(k):
                return torch.as_tensor(np.asarray(eval_sample[k], np.float32)).to(device)

            pred = inference(ema_state(state), schedule, gen, one("eps")[None],
                             one("mu")[None], one("src")[None], one("omega").reshape(1),
                             scales=scales, prediction_type=config.prediction_type)
            eval_callback(epoch, pred[0].cpu().numpy(), eval_sample["Ez"])
        if holdout_set is not None and eval_every > 0 and (epoch + 1) % eval_every == 0:
            rel = holdout_relative_l2(ema_state(state), schedule, gen, holdout_set, scales,
                                      prediction_type=config.prediction_type)
            if holdout_callback is not None:
                holdout_callback(epoch, rel)
            else:
                print(f"epoch {epoch}: holdout rel-L2 "
                      f"mean {rel.mean():.4f} median {np.median(rel):.4f}")
        if config.ckpt_dir and (epoch + 1) % config.ckpt_every == 0:
            save_checkpoint(config.ckpt_dir, state, epoch, scales=scales)
    # always persist the final state: short runs leave something restorable
    if config.ckpt_dir and config.num_epochs > start_epoch:
        save_checkpoint(config.ckpt_dir, state, config.num_epochs - 1, scales=scales)
    return state, losses, scales


def _host(v):
    """A contiguous host numpy array of a numpy array or a tensor (a
    broadcast view, such as a decoded dataset's constant mu, is
    materialized)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.ascontiguousarray(v)
