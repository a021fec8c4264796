"""The data-parallel train step of the diffusion surrogate.

The JAX package has it only implicitly: its dry run (``__graft_entry__.py``,
stage 6) replicates the parameters, splits the batch over a ``dp`` mesh
axis and jits ``models/train.py::train_step``, and GSPMD partitions that one
program, so the step computes exactly the single-device step: BatchNorm's
statistics are over the whole batch.

One process cannot give one replica the BatchNorm statistics of another's
layer before that layer has run, so this leg is the port's one use of
``torch.distributed``: one rank a mesh entry, each holding the parameters
and its rows of the batch.

- :func:`train_step_dp`: every rank draws the whole batch's step draws from
  one identically seeded generator and takes its own rows, so the draws are
  the single-device step's; its loss is its samples' weighted sum over the
  global batch size; BatchNorm is synchronized (``models/unet.py``:
  ``synchronized_batchnorm``, an ``all_reduce`` of each channel's sums in
  the forward and in the backward pass); the gradients and the loss go
  through one ``all_reduce`` (summed); AdamW and the EMA then run
  identically on every rank.
- :func:`backend_for`: ``nccl`` where the ranks' devices are distinct cards,
  ``gloo`` for CPU ranks and for ranks that share a card (NCCL refuses two
  ranks on one GPU; gloo's ``all_reduce`` takes CUDA tensors).
- :func:`run_ranks` spawns the ranks (``torch.multiprocessing``, a
  ``file://`` rendezvous in a directory the caller gives), joins them within
  a time limit and kills them past it; :func:`train_ranks` runs a few steps
  of the step on each and returns their losses and parameters.
"""

from __future__ import annotations

import datetime
import os
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from fdtd2d_tpu_torch.models.diffusion import DDPMSchedule
from fdtd2d_tpu_torch.models.train import (StepDraws, TrainConfig, TrainState, apply_update,
                                           conv_flags, create_state, per_sample_loss,
                                           step_draws)
from fdtd2d_tpu_torch.models.unet import UNet2D, synchronized_batchnorm


def backend_for(devices: Sequence) -> str:
    """``nccl`` when the ranks' devices are distinct CUDA devices, else
    ``gloo``."""
    devs = [torch.device(d) for d in devices]
    distinct_cards = all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs)
    return "nccl" if distinct_cards else "gloo"


def train_step_dp(state: TrainState, schedule: DDPMSchedule, generator, batch_shard: dict, *,
                  group, global_batch: int, snr_gamma: float = 5.0, t_gamma: float = 1.3,
                  prediction_type: str = "epsilon", t_sampling: str = "snr",
                  weighting: str = "snr_gamma", ema_decay: float = 0.0,
                  augment: bool = False, draws: Optional[StepDraws] = None):
    """One data-parallel step of :func:`~fdtd2d_tpu_torch.models.train.
    train_step` on this rank's rows ``batch_shard`` (rank r holds rows
    [r b, (r + 1) b) of the global batch, b = global_batch / ranks);
    ``train_step``'s keywords. ``draws``: the WHOLE batch's draws (drawn
    from ``generator``, seeded alike on every rank, when None). Returns
    ``(state, loss)``, the loss the global batch's, equal on every rank."""
    import torch.distributed as dist

    rank, world = dist.get_rank(group), dist.get_world_size(group)
    local = batch_shard["Ez"].shape[0]
    if local * world != global_batch:
        raise ValueError(f"{world} ranks of {local} samples are not a batch of {global_batch}")
    if draws is None:
        draws = step_draws(generator, schedule, (global_batch,) + tuple(batch_shard["Ez"].shape[1:]),
                           t_gamma=t_gamma, prediction_type=prediction_type,
                           t_sampling=t_sampling, augment=augment)
    rows = slice(rank * local, (rank + 1) * local)
    mine = StepDraws(*(None if d is None else d[rows] for d in draws))
    state.optimizer.zero_grad(set_to_none=True)
    with conv_flags(), synchronized_batchnorm(state.model, group):
        per_sample = per_sample_loss(state, schedule, batch_shard, mine, snr_gamma=snr_gamma,
                                     prediction_type=prediction_type, weighting=weighting,
                                     augment=augment)
        part = per_sample.sum() / global_batch
        part.backward()
    params = [p for p in state.model.parameters()]
    flat = torch.cat([p.grad.reshape(-1) for p in params]
                     + [part.detach().reshape(1).to(params[0].dtype)])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p in params:
        p.grad.copy_(flat[offset : offset + p.numel()].view_as(p.grad))
        offset += p.numel()
    apply_update(state, ema_decay)
    return state, flat[-1].to(torch.float32)


def _rank_entry(target: Callable, rank: int, world: int, workdir: str, args: tuple):
    """A spawned rank: the process group, ``target(rank, world, group,
    *args)``, its result (or its traceback) written under ``workdir``."""
    import torch.distributed as dist

    try:
        backend, timeout_s = args[0], args[1]
        dist.init_process_group(backend, init_method=f"file://{os.path.join(workdir, 'rdv')}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        out = target(rank, world, dist.group.WORLD, *args[2:])
        dist.barrier()
        dist.destroy_process_group()
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(target: Callable, world: int, backend: str, workdir: str, *args,
              timeout: float = 300.0) -> list:
    """Run ``target(rank, world, group, *args)`` in ``world`` spawned
    processes, one rank each, in a ``backend`` group that meets through a
    file under ``workdir`` (an empty directory); returns each rank's result.
    Raises ``RuntimeError`` when a rank fails (with its traceback) and
    ``TimeoutError`` when the ranks are not done within ``timeout`` seconds;
    every rank is joined or killed before this returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(target, r, world, workdir, (backend, timeout) + args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        if late:
            raise TimeoutError(f"ranks {late} of {world} still running after {timeout:.0f} s")
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            errs = [os.path.join(workdir, f"rank{r}.err") for r in failed]
            text = "".join(open(e).read() for e in errs if os.path.exists(e))
            raise RuntimeError(f"ranks {failed} of {world} failed:\n{text}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=True)
            for r in range(world)]


def _train_rank(rank: int, world: int, group, specs: list):
    """A rank of :func:`train_ranks`: each spec's run in turn."""
    return [_train_run(rank, world, group, spec) for spec in specs]


def _train_run(rank: int, world: int, group, spec: dict):
    """``spec["steps"]`` data-parallel steps on this rank's rows of the
    batch, on ``spec["devices"][rank]``."""
    dev = torch.device(spec["devices"][rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    state, schedule, batch, gen = _setup(spec, dev)
    local = spec["batch"]["Ez"].shape[0] // world
    mine = {k: v[rank * local : (rank + 1) * local] for k, v in batch.items()}
    losses, times = [], []
    for _ in range(spec["steps"]):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, loss = train_step_dp(state, schedule, gen, mine, group=group,
                                    global_batch=spec["batch"]["Ez"].shape[0], **spec["recipe"])
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    return {"losses": losses, "seconds": times,
            "params": {k: v.detach().cpu() for k, v in state.model.state_dict().items()}}


def _setup(spec: dict, dev):
    """The state, schedule, batch and generator of a run of ``spec``, on
    ``dev``: the same on every rank and in the single-device reference."""
    model = UNet2D(**spec["model"]).to(spec["dtype"])
    state = create_state(spec["seed"], spec["batch"]["Ez"].shape[1:],
                         TrainConfig(ema_decay=spec["recipe"].get("ema_decay", 0.0)),
                         model=model, device=dev)
    schedule = DDPMSchedule.create(1000, device=dev)
    batch = {k: torch.as_tensor(v).to(dev, spec["dtype"] if v.ndim > 1 else torch.float32)
             for k, v in spec["batch"].items()}
    gen = torch.Generator(device=dev).manual_seed(spec["seed"] + 1)
    return state, schedule, batch, gen


def reference_steps(spec: dict, device) -> dict:
    """The single-device run that :func:`train_ranks` is held to: the same
    state, batch and generator, ``spec["steps"]`` of ``train_step``."""
    from fdtd2d_tpu_torch.models.train import train_step

    dev = torch.device(device)
    state, schedule, batch, gen = _setup(spec, dev)
    losses, times = [], []
    for _ in range(spec["steps"]):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, loss = train_step(state, schedule, gen, batch, **spec["recipe"])
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    return {"losses": losses, "seconds": times,
            "params": {k: v.detach().cpu() for k, v in state.model.state_dict().items()}}


def train_ranks(specs: list, workdir: str, *, timeout: float = 300.0) -> list:
    """Run each spec of ``specs`` in turn on one rank a device of
    ``devices`` (the same list in every spec), in the backend
    :func:`backend_for` picks; returns ``[spec][rank]`` of ``{"losses",
    "seconds", "params"}``. A spec: ``model`` (UNet2D keywords), ``dtype``,
    ``seed``, ``steps``, ``batch`` (a dict of host arrays, the GLOBAL batch),
    ``recipe`` (train_step keywords) and ``devices``."""
    devices = specs[0]["devices"]
    if any(spec["devices"] != devices for spec in specs):
        raise ValueError("the specs of one run of ranks name the same devices")
    by_rank = run_ranks(_train_rank, len(devices), backend_for(devices), workdir, specs,
                        timeout=timeout)
    return [[by_rank[r][i] for r in range(len(devices))] for i in range(len(specs))]


def max_param_diff(a: dict, b: dict) -> float:
    """The largest |difference| over the floating-point entries of two
    state dicts."""
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a
               if a[k].is_floating_point())


def random_batch(B: int, H: int, seed: int = 0) -> dict:
    """A batch whose every input channel varies (a constant channel's
    first-layer weights act as a bias ahead of BatchNorm, with gradients
    near zero whose Adam step is rounding noise), as host numpy."""
    rng = np.random.default_rng(seed)
    src = np.zeros((B, H, H), np.float32)
    src[:, H // 2, H // 2] = 1.0
    return {"eps": rng.uniform(0, 1, (B, H, H)), "mu": rng.uniform(0.5, 1.5, (B, H, H)),
            "src": src, "omega": np.linspace(0.5, 1.5, B), "Ez": rng.standard_normal((B, H, H))}
