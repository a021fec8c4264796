"""Surrogate training data on the device: scene draws and exact labels.

Counterpart of ``fdtd2d_tpu/models/datagen.py``. Per sample a random binary
permittivity (Gaussian-blurred uniform noise thresholded at 0.5 -> eps0 or
5 eps0, kernel 15, sigma ~ U[2, 6]), a random line-or-point source in the
middle 80% of the grid, omega ~ U[18, 30] GHz, and the label is the real part
of the FDFD solve with b = -1j omega src. A batch of B scenes is one operator
batched over scenes (:func:`make_operator_traced`), factored in one pass
(fdfd/direct.py: one factor set a scene, each block row one batched inverse
over 4 x B blocks), solved once and refined by one complex64 round; the
host checks each label's true float64 residual.

Randomness: every draw comes from an explicit ``torch.Generator`` and is
kept apart from the arithmetic it feeds (``_permittivity_from_draws``,
``_source_from_draws``, ``_omega_from_uniform``), so the tests hand JAX's
draws to the port's arithmetic. The draws follow torch's generator, not
JAX's key stream: the port's dataset for a seed is not the JAX package's,
and a CUDA generator's is not a CPU generator's. Files are the same npz
format (``_COMPACT_VERSION``), so each package reads the other's.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fdtd2d_tpu_torch import constants
from fdtd2d_tpu_torch.fdfd.direct import factor, factor_stacked, solve_factored
from fdtd2d_tpu_torch.ops.fdm import fdm_preconditioner
from fdtd2d_tpu_torch.ops.helmholtz import HelmholtzOperator, pml_sigma_profile, stretch_factors
from fdtd2d_tpu_torch.ops.krylov import fgmres

KERNEL_SIZE = 15
EPS_LO = constants.EPSILON_0_DATAGEN
EPS_HI = 5.0 * constants.EPSILON_0_DATAGEN
MU_REF = constants.MU_0_DATAGEN


def _gen(seed_or_generator, device="cpu") -> torch.Generator:
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    return torch.Generator(device=device).manual_seed(int(seed_or_generator))


# ---------------------------------------------------------------------------
# Scenes: draws, then the arithmetic
# ---------------------------------------------------------------------------


def _permittivity_from_draws(noise, sigma):
    """(eps, mu) of B scenes from uniform noise (B, H, W) and blur widths
    sigma (B,), in noise's dtype: a 15 x 15 Gaussian blur (zero padding 7,
    which equals ``convolve2d(mode="same")`` for this symmetric kernel), then
    the ``> 0.5`` threshold. The blur runs in full float32 or float64 (no
    TF32) so the threshold sees what the CPU computes."""
    B = noise.shape[0]
    coords = torch.arange(KERNEL_SIZE, dtype=noise.dtype, device=noise.device) - KERNEL_SIZE // 2
    r2 = coords[:, None] ** 2 + coords[None, :] ** 2
    kern = torch.exp(-r2[None] / (2.0 * sigma.to(noise.dtype)[:, None, None] ** 2))
    kern = kern / kern.sum(dim=(1, 2), keepdim=True)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        blurred = F.conv2d(noise[None], kern[:, None], padding=KERNEL_SIZE // 2, groups=B)[0]
    levels = torch.tensor([EPS_LO, EPS_HI], dtype=torch.float64, device=noise.device)
    eps = levels[(blurred > 0.5).long()]
    return eps, torch.full_like(eps, MU_REF)


def random_permittivity(generator: torch.Generator, shape: Tuple[int, int], batch: int = 1):
    """Blur-threshold binary permittivity of ``batch`` scenes, (B, H, W)
    float64 eps and mu, drawn on the generator's device."""
    dev = generator.device
    noise = torch.rand((batch,) + tuple(shape), generator=generator, device=dev)
    sigma = torch.rand((batch,), generator=generator, device=dev) * 4.0 + 2.0
    return _permittivity_from_draws(noise, sigma)


def _source_spans(shape: Tuple[int, int]):
    H, W = shape
    sx0, sx1 = max(5, H // 10), min(H - 5, H - H // 10)
    sy0, sy1 = max(5, W // 10), min(W - 5, W - W // 10)
    L = max((min(sx1 - sx0, sy1 - sy0)) // 10, 1)
    return sx0, sx1, sy0, sy1, L


def _source_from_draws(shape, is_line, is_horiz, r, c, c_start, r_start):
    """(B, H, W) float32 source masks from the per-scene draws (B,) each: a
    horizontal or vertical line of length L, or the point (r, c)."""
    H, W = shape
    L = _source_spans(shape)[-1]
    dev = r.device
    rows = torch.arange(H, device=dev)[None, :, None]
    cols = torch.arange(W, device=dev)[None, None, :]

    def b(v):
        return v[:, None, None]

    horiz = (rows == b(r)) & (cols >= b(c_start)) & (cols < b(c_start) + L)
    vert = (cols == b(c)) & (rows >= b(r_start)) & (rows < b(r_start) + L)
    point = (rows == b(r)) & (cols == b(c))
    mask = torch.where(b(is_line), torch.where(b(is_horiz), horiz, vert), point)
    return mask.to(torch.float32)


def random_source(generator: torch.Generator, shape: Tuple[int, int], batch: int = 1):
    """Random line (<= 10% span) or point sources in the middle 80%, (B, H, W).
    Line starts are drawn on their own over the valid range, as the JAX
    module draws them."""
    sx0, sx1, sy0, sy1, L = _source_spans(shape)
    dev = generator.device

    def randint(lo, hi):
        return torch.randint(lo, hi, (batch,), generator=generator, device=dev)

    is_line = torch.rand((batch,), generator=generator, device=dev) < 0.5
    is_horiz = torch.rand((batch,), generator=generator, device=dev) < 0.5
    r, c = randint(sx0, sx1), randint(sy0, sy1)
    c_start = randint(sy0, max(sy1 - L, sy0 + 1))
    r_start = randint(sx0, max(sx1 - L, sx0 + 1))
    return _source_from_draws(shape, is_line, is_horiz, r, c, c_start, r_start)


def _omega_from_uniform(u):
    return u * (30e9 - 18e9) + 18e9


def random_omega(generator: torch.Generator, batch: int = 1):
    """omega ~ U[18, 30] GHz, (B,) float64."""
    u = torch.rand((batch,), generator=generator, device=generator.device,
                   dtype=torch.float64)
    return _omega_from_uniform(u)


def random_scenes(generator: torch.Generator, shape: Tuple[int, int], batch: int):
    """(eps, mu, src, omega) of ``batch`` scenes on the generator's device."""
    eps, mu = random_permittivity(generator, shape, batch)
    src = random_source(generator, shape, batch)
    return eps, mu, src, random_omega(generator, batch)


# ---------------------------------------------------------------------------
# The operator and the solves
# ---------------------------------------------------------------------------


def make_operator_traced(eps, mu, dx, dy, omega, pml_thickness: int,
                         sigma_max: float = 2.0, m: int = 3,
                         dtype=torch.complex64) -> HelmholtzOperator:
    """The operator of a batch of scenes: eps, mu (B, Nx, Ny), omega (B,);
    each scene has its own stretch vectors (B, Nx) and (B, Ny), computed in
    complex128 from the float64 omega and stored at ``dtype`` (as the JAX
    module's vmapped operator computes them under x64)."""
    Nx, Ny = eps.shape[-2:]
    dev = eps.device
    real = torch.empty((), dtype=dtype).real.dtype
    om = torch.as_tensor(omega, device=dev).to(torch.float64)

    def inv_s(n):
        sig = torch.as_tensor(pml_sigma_profile(n, pml_thickness, sigma_max, m), device=dev)
        s = 1.0 + 1j * sig / (om[..., None] * constants.EPSILON_0)
        return (1.0 / s).to(dtype)

    def scalar(v):
        return torch.tensor(v, dtype=real, device=dev)

    return HelmholtzOperator(
        eps=eps.to(real), inv_mu=(1.0 / mu).to(real),
        inv_s_row=inv_s(Nx), inv_s_col=inv_s(Ny), omega=om.to(real),
        inv_2dx=scalar(1.0 / (2.0 * dx)), inv_2dy=scalar(1.0 / (2.0 * dy)),
        pml_thickness=pml_thickness, sigma_max=sigma_max, m=m)


def _rhs(omega, src):
    """b = -1j omega src in complex64, (B, Nx, Ny)."""
    return (-1j * omega.to(torch.complex64))[:, None, None] * src.to(torch.complex64)


def _lap(times, key: str, t0: float, device) -> float:
    """Add the seconds since ``t0`` to ``times[key]``, the device synchronized
    first, and return the clock; a no-op when ``times`` is None."""
    if times is None:
        return t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    now = time.perf_counter()
    times[key] = times.get(key, 0.0) + now - t0
    return now


def _solve_scenes(eps, mu, src, omega, dx: float, pml_thickness: int, times=None):
    """Labels of a scene batch: the batched factor, one solve, one complex64
    refinement round (the pivotless block-LU loses a few digits; re-solving
    the residual restores the complex64 floor, ~1e-6). ``times``: a dict that
    gets the seconds of "draw" (work queued before the call), "factor",
    "solve" and "refine" (the device is then synchronized between them)."""
    t0 = _lap(times, "draw", time.perf_counter(), eps.device)
    op = make_operator_traced(eps, mu, dx, dx, omega, pml_thickness)
    b = _rhs(omega, src)
    Nx, Ny = op.shape
    f = factor_stacked(op) if Nx % 2 == 0 and Ny % 2 == 0 else factor(op)
    t0 = _lap(times, "factor", t0, eps.device)
    x = solve_factored(f, b)
    t0 = _lap(times, "solve", t0, eps.device)
    x = x + solve_factored(f, b - op.apply(x))
    _lap(times, "refine", t0, eps.device)
    return x


def _generate_batch_direct_device(generator, *, batch: int, shape: Tuple[int, int],
                                  dx: float, pml_thickness: int, device="cuda", times=None):
    """(eps, mu, src, omega float32, complex64 labels) of ``batch`` scenes on
    ``device`` (drawn on the generator's device)."""
    eps, mu, src, omega = (a.to(device) for a in random_scenes(generator, shape, batch))
    x = _solve_scenes(eps, mu, src, omega, dx, pml_thickness, times)
    return (eps.to(torch.float32), mu.to(torch.float32), src, omega.to(torch.float32), x)


def _generate_batch_compact_device(generator, *, batch: int, shape: Tuple[int, int],
                                   dx: float, pml_thickness: int, device="cuda", times=None):
    """Device half of the datagen path: the solve plus compact encodings
    (eps_mask u8, src_mask u8, omega f32, re f32, im f32): binary eps, a 0/1
    source and constant mu need no floats, and complex64 is a pair of
    float32s, so this is the least that the host copy must carry."""
    eps, mu, src, omega, x = _generate_batch_direct_device(
        generator, batch=batch, shape=shape, dx=dx, pml_thickness=pml_thickness,
        device=device, times=times)
    mid = np.float32(0.5 * (EPS_LO + EPS_HI))
    return ((eps > mid).to(torch.uint8), (src != 0).to(torch.uint8), omega,
            x.real.contiguous(), x.imag.contiguous())


def _five_point_residual_host(eps, mu, src, omega, Ez_c, dx: float,
                              pml_thickness: int) -> np.ndarray:
    """Per-sample TRUE float64 relative residuals, in numpy on the host with
    the pentadiagonal form of the operator."""
    B, Nx, Ny = eps.shape
    im = 1.0 / np.asarray(mu, np.float64)
    x = np.asarray(Ez_c, np.complex128)
    res = np.empty(B)
    for i in range(B):
        s_r, s_c = stretch_factors(Nx, Ny, float(omega[i]), pml_thickness, 2.0, 3)
        isr = (1.0 / s_r)[:, None]
        isc = (1.0 / s_c)[None, :]
        a = 1.0 / (2.0 * dx)

        def dcol(f):
            out = np.zeros_like(f)
            out[:, :-1] += f[:, 1:]
            out[:, 1:] -= f[:, :-1]
            return out * a

        def drow(f):
            out = np.zeros_like(f)
            out[:-1, :] += f[1:, :]
            out[1:, :] -= f[:-1, :]
            return out * a

        xi = x[i]
        tc = dcol(dcol(xi * isc) * im[i]) * isc
        tr = drow(drow(xi * isr) * im[i]) * isr
        ax = -(tc + tr) - (float(omega[i]) ** 2) * np.asarray(eps[i], np.float64) * xi
        b = -1j * float(omega[i]) * np.asarray(src[i], np.float64)
        res[i] = np.linalg.norm(ax - b) / np.linalg.norm(b)
    return res


def _finish_batch_host(dev, dx: float, pml_thickness: int) -> dict:
    """Host half: copy the compact encodings, rebuild the float channels and
    run the true float64 residual check."""
    eps_mask, src_mask, omega, re, im = (a.cpu().numpy() for a in dev)
    eps = np.where(eps_mask.astype(bool), np.float32(EPS_HI), np.float32(EPS_LO))
    src = src_mask.astype(np.float32)
    omega = omega.astype(np.float32)
    mu = np.broadcast_to(np.float32(MU_REF), eps.shape)
    x_host = re.astype(np.float64) + 1j * im.astype(np.float64)
    res = _five_point_residual_host(eps, mu, src, omega, x_host, dx, pml_thickness)
    return dict(eps=eps, mu=mu, src=src, omega=omega, Ez=re.astype(np.float32),
                residuals=res.astype(np.float32))


def generate_batch(generator, *, batch: int, shape: Tuple[int, int], dx: float = 1e-3,
                   pml_thickness: int = 40, M=None, device="cuda", **_ignored):
    """One batch of (eps, mu, src, omega, Ez) training samples as host numpy,
    with ``residuals``, each label's true float64 relative residual. Labels
    are exact: the direct factorization plus one complex64 refinement round
    (typically ~1e-6). ``M`` and any other keyword (the Krylov path's
    ``maxiter``, ...) are accepted and dropped, as the JAX package does."""
    del M, _ignored
    dev = _generate_batch_compact_device(_gen(generator, device), batch=batch, shape=shape,
                                         dx=dx, pml_thickness=pml_thickness, device=device)
    return _finish_batch_host(dev, dx, pml_thickness)


def default_preconditioner(shape: Tuple[int, int], dx: float = 1e-3,
                           pml_thickness: int = 40, omega_ref: float = 24e9, device="cuda"):
    """Shared mid-band FDM preconditioner for Krylov-labelled batches."""
    return fdm_preconditioner(shape[0], shape[1], dx, dx, omega_ref, pml_thickness,
                              eps_ref=2.0 * EPS_LO, mu_ref=MU_REF, device=device)


def generate_batch_krylov(generator, *, batch: int, shape: Tuple[int, int],
                          dx: float = 1e-3, pml_thickness: int = 40,
                          maxiter: int = 400, M=None, device="cuda"):
    """Krylov-labelled batch (kept for comparison): the scene-batched
    operator, the shared FDM preconditioner ``M`` (identity when None) and
    one batched FGMRES(40) to 1e-4. On these scenes (50% duty binary 5x
    contrast at 18-30 GHz, dx = 1 mm) it stalls near 1e-2 on most samples:
    use :func:`generate_batch` for training data. Device tensors out;
    ``residuals`` (B,) float."""
    eps, mu, src, omega = (a.to(device) for a in
                           random_scenes(_gen(generator, device), shape, batch))
    op = make_operator_traced(eps, mu, dx, dx, omega, pml_thickness)
    out = fgmres(op.apply, _rhs(omega, src), M, restart=40, maxiter=maxiter, tol=1e-4,
                 batched=True)
    return dict(eps=eps.to(torch.float32), mu=mu.to(torch.float32), src=src,
                omega=omega.to(torch.float32), Ez=out.x.real.to(torch.float32),
                residuals=torch.tensor(out.relative_residual))


def generate_dataset(generator, num_samples: int, shape: Tuple[int, int], batch: int = 64,
                     to_host: bool | None = None, dx: float = 1e-3, pml_thickness: int = 40,
                     device="cuda", **kwargs):
    """``num_samples`` in batches of ``batch``; a stacked host-numpy dict.
    Batch i+1 is queued on the device before batch i's host copy and float64
    check, so the host work overlaps the next solve. ``to_host``, ``M`` and
    any other keyword are accepted and dropped, as the JAX package does: the
    result is always host numpy, and the direct path takes no preconditioner."""
    del to_host, kwargs
    generator = _gen(generator, device)
    outs, pending, n = [], None, 0
    while n < num_samples:
        b = min(batch, num_samples - n)
        dev = _generate_batch_compact_device(generator, batch=b, shape=shape, dx=dx,
                                             pml_thickness=pml_thickness, device=device)
        if pending is not None:
            outs.append(_finish_batch_host(pending, dx, pml_thickness))
        pending = dev
        n += b
    outs.append(_finish_batch_host(pending, dx, pml_thickness))
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


# ---------------------------------------------------------------------------
# Dataset storage: compact npz + resumable shards (the JAX module's format)
# ---------------------------------------------------------------------------
#
# eps is binary (EPS_LO or EPS_HI), src a 0/1 mask and mu the constant MU_REF:
# compact storage keeps uint8 masks for eps/src, drops mu, and keeps the label
# Ez in float32 (field norms span orders of magnitude; float16 would clip).

_COMPACT_VERSION = 1


def save_dataset(path: str, data: dict, compact: bool = True) -> None:
    """Write a dataset npz; ``compact=True`` uses the mask encoding above.
    Atomic: writes ``<path>.tmp.npz`` and renames it."""
    arrs = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in data.items()}
    if compact:
        mid = np.float32(0.5 * (EPS_LO + EPS_HI))
        out = {
            "eps_mask": (arrs["eps"] > mid).astype(np.uint8),
            "src_mask": (arrs["src"] != 0).astype(np.uint8),
            "omega": arrs["omega"].astype(np.float32),
            "Ez": arrs["Ez"].astype(np.float32),
            "compact_version": np.int32(_COMPACT_VERSION),
        }
        if "residuals" in arrs:
            out["residuals"] = arrs["residuals"].astype(np.float32)
        arrs = out
    if not path.endswith(".npz"):
        path += ".npz"
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrs)
    os.replace(tmp, path)


def _decode_compact(raw: dict) -> dict:
    mask = np.asarray(raw["eps_mask"], bool)
    out = {
        "eps": np.where(mask, np.float32(EPS_HI), np.float32(EPS_LO)),
        "mu": np.broadcast_to(np.float32(MU_REF), mask.shape),
        "src": np.asarray(raw["src_mask"], np.float32),
        "omega": np.asarray(raw["omega"]),
        "Ez": np.asarray(raw["Ez"]),
    }
    if "residuals" in raw:
        out["residuals"] = np.asarray(raw["residuals"])
    return out


def load_dataset(path: str, decode: bool = True) -> dict:
    """Load a plain npz, a compact npz, or a DIRECTORY of ``shard_*.npz``
    files (concatenated in filename order). ``decode=False`` returns
    compact data in its raw mask form, the input of the ``"compact"``
    device cache of models/train.py ``train``."""
    if os.path.isdir(path):
        shards = sorted(glob.glob(os.path.join(path, "shard_*.npz")))
        if not shards:
            raise FileNotFoundError(f"no shard_*.npz files in {path}")
        parts = [np.load(p) for p in shards]
        keys = [k for k in parts[0].files if k != "compact_version"]
        raw = {k: (np.concatenate([p[k] for p in parts]) if parts[0][k].ndim
                   else parts[0][k][()])
               for k in keys}
        if "compact_version" in parts[0].files:
            raw["compact_version"] = parts[0]["compact_version"][()]
    else:
        with np.load(path) as f:
            raw = {k: f[k] for k in f.files}
    if "eps_mask" in raw and decode:
        return _decode_compact(raw)
    raw.pop("compact_version", None)
    return raw


def shard_generator(seed: int, index: int, device="cuda") -> torch.Generator:
    """The generator of shard ``index`` of a run seeded ``seed``: a function
    of the pair alone, so a resumed run writes the shards an unbroken one
    would."""
    mixed = np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def generate_dataset_shards(seed: int, num_samples: int, shape: Tuple[int, int],
                            out_dir: str, shard_size: int = 2048, batch: int = 32,
                            compact: bool = True, verbose: bool = True,
                            device="cuda", **kwargs) -> int:
    """Resumable sharded datagen: writes ``shard_%05d.npz`` under
    ``out_dir``, skipping shards that exist. Shard i draws from
    :func:`shard_generator` (seed, i). Returns the shards written."""
    os.makedirs(out_dir, exist_ok=True)
    n_shards = -(-num_samples // shard_size)
    written = 0
    for i in range(n_shards):
        path = os.path.join(out_dir, f"shard_{i:05d}.npz")
        if os.path.exists(path):
            continue
        n_i = min(shard_size, num_samples - i * shard_size)
        data = generate_dataset(shard_generator(seed, i, device), n_i, shape, batch=batch,
                                device=device, **kwargs)
        save_dataset(path, data, compact=compact)
        written += 1
        if verbose:
            worst = float(np.max(data["residuals"]))
            print(f"shard {i + 1}/{n_shards}: {n_i} samples, "
                  f"worst residual {worst:.2e}", flush=True)
    return written
