"""UNet for the diffusion surrogate, as torch modules.

Counterpart of the Flax ``fdtd2d_tpu/models/unet.py``: a 3-level encoder
4->64->128->256 with a 512-channel bottleneck, double Conv3x3 + BatchNorm +
ReLU blocks, a sinusoidal time embedding added at the bottleneck only,
per-scale omega-embedding MLPs added after each max-pool, a nearest-neighbour
upsampling decoder with skip concatenation, and a 1x1 conv head. Laid out
NCHW in ``channels_last`` memory (the cuDNN layout for tensor cores).

Where a straight transcription of the Flax module gives another answer, the
port follows Flax:

- upsampling is ``F.interpolate(mode="nearest-exact")``: ``jax.image.resize``
  samples at half-pixel centres, torch's "nearest" does not (they differ
  where a size is not divisible by 8, e.g. 62 -> 125 at the CLI's 250^2);
- :class:`BatchNorm` normalizes as ``F.batch_norm`` but keeps Flax's running
  statistics: momentum 0.99 (weight 0.01 on the batch), and the biased batch
  variance, where ``nn.BatchNorm2d`` weights the batch 0.1 and updates with
  the unbiased one;
- weights start as Flax's ``lecun_normal`` (a normal truncated at two
  standard deviations, variance 1/fan_in) and biases at zero, not torch's
  kaiming-uniform (a = sqrt(5)) with random biases.

``dtype=torch.bfloat16`` runs the conv and dense math under autocast in
bf16; the parameters, the BatchNorm statistics and normalization, the 1x1
head and the output stay float32 (the JAX module's mixed precision). A
module converted to float64 (``.double()``) computes in float64 throughout.

Under a ``torch.distributed`` group (:func:`synchronized_batchnorm`, the
data-parallel train step of parallel/train_dp.py) BatchNorm takes its
statistics over the whole batch of every rank, as the JAX package's GSPMD
step does over a batch split across devices.
:func:`unet_params_from_flax` carries Flax weights across.
"""

from __future__ import annotations

import math
import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# lecun_normal: a standard normal truncated to [-2, 2] has std 0.8796...; the
# scale divides it out so the truncated draw has variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] -> [B, dim] float32: frequencies in float64 rounded to float32,
    their products with t and the sines in float32, as the JAX module."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64,
                                                        device=t.device) / (half - 1))
    args = t.to(torch.float32)[:, None] * freqs.to(torch.float32)[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` (epsilon 1e-5, momentum 0.99) on NCHW tensors:
    train mode normalizes with the batch statistics and moves the running
    ones 0.01 of the way toward the batch mean and BIASED variance; eval
    mode normalizes with the running ones. One pass computes the statistics
    and the normalization (``_native_batch_norm_legit``, which returns the
    batch mean and 1/sqrt(var + eps)); statistics are float32 whatever the
    input's dtype, and the output has the input's dtype (tools/
    bench_batchnorm.py times this form against ``F.batch_norm`` beside a
    separate ``var_mean``)."""

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.group = None   # a torch.distributed group: statistics over all its ranks
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        sync = self.group is not None
        if sync:
            y, mean, stat = _SyncBatchNorm.apply(x, self.weight, self.bias, self.eps, self.group)
        else:
            y, mean, stat = torch.ops.aten._native_batch_norm_legit.no_stats(
                x, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var = stat if sync else stat.pow(-2) - self.eps   # the biased variance
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        return y


class _SyncBatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm over the batch of every rank of ``group``.
    Forward: one ``all_reduce`` of each channel's sum, sum of squares and
    count, the biased variance E[x^2] - E[x]^2 and the normalization.
    Backward: one ``all_reduce`` of each channel's sums of dy and of
    dy * x_hat; the weight and bias gradients stay this rank's own sums (the
    train step's gradient ``all_reduce`` adds them up). Statistics in
    float32 at least, whatever the input's dtype; returns (y, mean, var)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        import torch.distributed as dist

        xf = x if x.dtype in (torch.float32, torch.float64) else x.float()
        C = x.shape[1]
        dims = [0, 2, 3]
        count = torch.full((1,), x.numel() // C, dtype=xf.dtype, device=x.device)
        stats = torch.cat([xf.sum(dims), (xf * xf).sum(dims), count])
        dist.all_reduce(stats, group=group)
        n = stats[-1]
        mean = stats[:C] / n
        var = stats[C : 2 * C] / n - mean * mean
        rstd = torch.rsqrt(var + eps)
        xhat = (xf - mean[:, None, None]) * rstd[:, None, None]
        y = xhat * weight[:, None, None] + bias[:, None, None]
        ctx.save_for_backward(xhat, rstd, weight, n)
        ctx.group, ctx.in_dtype = group, x.dtype
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        import torch.distributed as dist

        xhat, rstd, weight, n = ctx.saved_tensors
        dyf = dy.to(xhat.dtype)
        dims = [0, 2, 3]
        sum_dy, sum_dy_xhat = dyf.sum(dims), (dyf * xhat).sum(dims)
        sums = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(sums, group=ctx.group)
        C = sum_dy.shape[0]
        g_dy, g_dy_xhat = (sums[:C] / n)[:, None, None], (sums[C:] / n)[:, None, None]
        dx = (weight * rstd)[:, None, None] * (dyf - g_dy - xhat * g_dy_xhat)
        return dx.to(ctx.in_dtype), sum_dy_xhat, sum_dy, None, None


@contextlib.contextmanager
def synchronized_batchnorm(model: nn.Module, group):
    """Within the block, every :class:`BatchNorm` of ``model`` takes its
    training statistics over all ranks of the ``torch.distributed`` group."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.group = group
    try:
        yield model
    finally:
        for m in norms:
            m.group = None


class ConvBlock(nn.Module):
    """Conv3x3 + BatchNorm + ReLU, twice."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv2d(cin, features, 3, padding=1),
                                    nn.Conv2d(features, features, 3, padding=1)])
        self.norms = nn.ModuleList([BatchNorm(features), BatchNorm(features)])

    def forward(self, x):
        for conv, norm in zip(self.convs, self.norms):
            x = F.relu(norm(conv(x)))
        return x


class OmegaMLP(nn.Module):
    """Per-scale omega embedding: Linear(1, C) -> ReLU -> Linear(C, C)."""

    def __init__(self, features: int):
        super().__init__()
        self.dense = nn.ModuleList([nn.Linear(1, features), nn.Linear(features, features)])

    def forward(self, omega):
        return self.dense[1](F.relu(self.dense[0](omega[:, None])))


class UNet2D(nn.Module):
    """Submodules in the Flax module's call order: ``blocks[0..6]`` are
    ConvBlock_0..6 (three encoder levels, the bottleneck, three decoder
    levels), ``omegas[0..2]`` OmegaMLP_0..2, ``time[0..1]`` Dense_0/1 and
    ``head`` Conv_0."""

    def __init__(self, time_embed_dim: int = 512, channels: Sequence[int] = (64, 128, 256),
                 bottleneck: int = 512, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if bottleneck != time_embed_dim:
            raise ValueError(f"the time embedding ({time_embed_dim}) is added to the "
                             f"bottleneck ({bottleneck}): they must be equal")
        c1, c2, c3 = channels
        self.time_embed_dim, self.dtype = time_embed_dim, dtype
        self.blocks = nn.ModuleList([
            ConvBlock(4, c1), ConvBlock(c1, c2), ConvBlock(c2, c3), ConvBlock(c3, bottleneck),
            ConvBlock(bottleneck + c3, c3), ConvBlock(c3 + c2, c2), ConvBlock(c2 + c1, c1)])
        self.omegas = nn.ModuleList([OmegaMLP(c) for c in (c1, c2, c3)])
        self.time = nn.ModuleList([nn.Linear(time_embed_dim, time_embed_dim),
                                   nn.Linear(time_embed_dim, time_embed_dim)])
        self.head = nn.Conv2d(c1, 1, 1)
        self.reset_parameters(generator)
        self.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Flax's initialization: lecun_normal weights, zero biases."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)

    def forward(self, eps, mu, src, noisy, t, omega, *, train: bool = False):
        """Field inputs (B, H, W), t and omega (B,); returns (B, H, W) in
        float32 whatever the compute dtype (float64 for a ``.double()``
        module). ``train`` selects the BatchNorm mode (batch statistics,
        running statistics updated) as the Flax module's argument does,
        whatever ``self.training`` says."""
        self.train(train)
        real = self.head.weight.dtype   # float32, or float64 for a .double() module
        x = torch.stack([eps, mu, src, noisy], dim=1).to(real)
        x = x.contiguous(memory_format=torch.channels_last)
        omega = omega.to(real)
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            e1 = self.blocks[0](x)
            p1 = F.max_pool2d(e1, 2) + self.omegas[0](omega)[:, :, None, None]
            e2 = self.blocks[1](p1)
            p2 = F.max_pool2d(e2, 2) + self.omegas[1](omega)[:, :, None, None]
            e3 = self.blocks[2](p2)
            p3 = F.max_pool2d(e3, 2) + self.omegas[2](omega)[:, :, None, None]

            b = self.blocks[3](p3)
            temb = sinusoidal_embedding(t, self.time_embed_dim).to(real)
            temb = self.time[1](F.relu(self.time[0](temb)))
            b = b + temb[:, :, None, None]

            def up_cat(h, ref):
                # nearest sampling is exact in any dtype: outside autocast, which
                # would run it (and so the concatenation) in float32
                with torch.autocast(x.device.type, enabled=False):
                    h = F.interpolate(h, size=ref.shape[-2:], mode="nearest-exact")
                return torch.cat([h, ref.to(h.dtype)], dim=1)

            d3 = self.blocks[4](up_cat(b, e3))
            d2 = self.blocks[5](up_cat(d3, e2))
            d1 = self.blocks[6](up_cat(d2, e1))
        # the head stays float32: the regression target spans orders of magnitude
        with torch.autocast(x.device.type, enabled=False):
            return self.head(d1.to(real))[:, 0]


def unet_params_from_flax(params: dict, batch_stats: Optional[dict] = None) -> dict:
    """The port's ``state_dict`` from a Flax UNet2D's ``params`` (and
    ``batch_stats``), trees of numpy arrays: conv kernels HWIO -> OIHW,
    dense kernels (in, out) -> (out, in), BatchNorm scale/bias -> weight/
    bias and mean/var -> running_mean/running_var."""
    out = {}

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    def dense(prefix, p):
        out[prefix + ".weight"] = t(p["kernel"]).T.contiguous()
        out[prefix + ".bias"] = t(p["bias"])

    def conv(prefix, p):
        out[prefix + ".weight"] = t(p["kernel"]).permute(3, 2, 0, 1).contiguous()
        out[prefix + ".bias"] = t(p["bias"])

    for i in range(7):
        blk = params[f"ConvBlock_{i}"]
        for j in range(2):
            conv(f"blocks.{i}.convs.{j}", blk[f"Conv_{j}"])
            bn = blk[f"BatchNorm_{j}"]
            out[f"blocks.{i}.norms.{j}.weight"] = t(bn["scale"])
            out[f"blocks.{i}.norms.{j}.bias"] = t(bn["bias"])
            if batch_stats is not None:
                st = batch_stats[f"ConvBlock_{i}"][f"BatchNorm_{j}"]
                out[f"blocks.{i}.norms.{j}.running_mean"] = t(st["mean"])
                out[f"blocks.{i}.norms.{j}.running_var"] = t(st["var"])
    for i in range(3):
        for j in range(2):
            dense(f"omegas.{i}.dense.{j}", params[f"OmegaMLP_{i}"][f"Dense_{j}"])
    for j in range(2):
        dense(f"time.{j}", params[f"Dense_{j}"])
    conv("head", params["Conv_0"])
    return out
