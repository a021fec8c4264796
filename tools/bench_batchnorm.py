"""Forms of the UNet's BatchNorm (train mode, with Flax's running statistics)
timed on the GPU, forward and backward with the ReLU after it.

    python tools/bench_batchnorm.py [--shape 8,64,256,256]

At the UNet's level-1 shape (batch 8, 64 channels, 256^2, channels_last), in
float32 and bf16, in turns a, b, c, a, b, c, ms by CUDA events over 20 calls
after 3:

- a: ``F.batch_norm`` on a float32 copy and a separate ``var_mean`` for the
  running statistics, the output cast back (the first form of
  models/unet.py's BatchNorm);
- b: ``_native_batch_norm_legit.no_stats``, one pass that returns the batch
  mean and 1/sqrt(var + eps) with the output (models/unet.py's form);
- c: ``F.batch_norm`` on the input's dtype beside a ``var_mean``.

Each line gives the output's and the running variance's largest difference
from form a, relative. Then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

EPS, M = 1e-5, 0.99


def form_a(x, w, b, rm, rv):
    xf = x.float()
    with torch.no_grad():
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        rm.mul_(M).add_(mean, alpha=1 - M)
        rv.mul_(M).add_(var, alpha=1 - M)
    return F.batch_norm(xf, None, None, w, b, True, 0.0, EPS).to(x.dtype)


def form_b(x, w, b, rm, rv):
    y, mean, rstd = torch.ops.aten._native_batch_norm_legit.no_stats(x, w, b, True, 0.0, EPS)
    with torch.no_grad():
        rm.mul_(M).add_(mean, alpha=1 - M)
        rv.mul_(M).add_(rstd.pow(-2) - EPS, alpha=1 - M)
    return y


def form_c(x, w, b, rm, rv):
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        rm.mul_(M).add_(mean.float(), alpha=1 - M)
        rv.mul_(M).add_(var.float(), alpha=1 - M)
    return F.batch_norm(x, None, None, w, b, True, 0.0, EPS)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shape", default="8,64,256,256")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_batchnorm: no CUDA device", file=sys.stderr)
        return 1
    shape = tuple(int(v) for v in args.shape.split(","))
    dev = torch.device("cuda:0")
    forms = {"a": form_a, "b": form_b, "c": form_c}
    for dtype in (torch.float32, torch.bfloat16):
        x0 = torch.randn(shape, device=dev).to(dtype).contiguous(memory_format=torch.channels_last)
        g = torch.randn_like(x0)
        ref = None
        for name in "abcabc":
            w = torch.ones(shape[1], device=dev, requires_grad=True)
            b = torch.zeros(shape[1], device=dev, requires_grad=True)
            rm, rv = torch.zeros(shape[1], device=dev), torch.ones(shape[1], device=dev)
            x = x0.clone().requires_grad_(True)
            for _ in range(3):
                F.relu(forms[name](x, w, b, rm, rv)).backward(g)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                y = F.relu(forms[name](x, w, b, rm, rv))
                y.backward(g)
            end.record()
            end.synchronize()
            out = (y.detach().float(), rv.clone())
            ref = ref or out
            err = [float((a - r).abs().max() / r.abs().max()) for a, r in zip(out, ref)]
            print(f"{str(dtype)[6:]} {name}: {start.elapsed_time(end) / 20:.3f} ms forward and "
                  f"backward; vs a: output {err[0]:.2e}, running var {err[1]:.2e}", flush=True)
    from fdtd2d_tpu_torch.utils.metrics import device_info

    print(device_info()["nvidia_smi"])
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    sys.exit(main())
