"""Times the batched complex dot of the batched FGMRES's Gram-Schmidt on the GPU.

    python tools/bench_batched_dot.py [--shapes 10x250,10x848,1x512] [--reps 200]

For each F x N x N complex64 pair (a, c) it computes conj(a_f) . c_f for the
F members four ways: ``torch.linalg.vecdot`` (what ``ops/krylov.py`` uses
when batched), and three forms that reach cuBLAS's batched gemv (``bmm`` of a
conjugated row view, ``matmul`` with ``mH``, ``einsum``). Each is held to a
complex128 ``torch.vdot`` per member (max relative error), then timed with
CUDA events over ``--reps`` back-to-back calls after a warm-up; a
torch.profiler window of one call counts its device kernels. One JSON line
per shape, with the HBM bound of reading a and c once at 3.35 TB/s, then the
card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HBM_BYTES_S = 3.35e12


def forms(F: int):
    return {
        "vecdot": lambda a, c: torch.linalg.vecdot(a.reshape(F, -1), c.reshape(F, -1)),
        "bmm_conj_view": lambda a, c: torch.bmm(a.reshape(F, 1, -1).conj(),
                                                c.reshape(F, -1, 1)).reshape(F),
        "matmul_mH": lambda a, c: torch.matmul(a.reshape(F, -1, 1).mH,
                                               c.reshape(F, -1, 1)).reshape(F),
        "einsum": lambda a, c: torch.einsum("fn,fn->f", a.reshape(F, -1).conj(),
                                            c.reshape(F, -1)),
    }


def shape_list(text: str):
    return [tuple(int(v) for v in item.split("x")) for item in text.split(",") if item]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shapes", type=shape_list, default=[(10, 250), (10, 848), (1, 512)])
    parser.add_argument("--reps", type=int, default=200)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_batched_dot: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from fdtd2d_tpu_torch.utils.metrics import device_info

    dev = torch.device("cuda:0")
    for F, N in args.shapes:
        g = torch.Generator(device=dev).manual_seed(0)
        a = torch.randn(F, N, N, dtype=torch.complex64, device=dev, generator=g)
        c = torch.randn(F, N, N, dtype=torch.complex64, device=dev, generator=g)
        ref = torch.stack([torch.vdot(a[f].reshape(-1).to(torch.complex128),
                                      c[f].reshape(-1).to(torch.complex128)) for f in range(F)])
        row = {"F": F, "N": N, "bound_us": 2 * a.numel() * 8 / HBM_BYTES_S * 1e6}
        for name, fn in forms(F).items():
            err = float(((fn(a, c).to(torch.complex128) - ref).abs() / ref.abs()).max())
            for _ in range(5):
                fn(a, c)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(args.reps):
                fn(a, c)
            end.record()
            torch.cuda.synchronize(dev)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn(a, c)
                torch.cuda.synchronize(dev)
            kernels = [e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            row[name] = {"us": start.elapsed_time(end) / args.reps * 1e3, "rel_err": err,
                         "kernels": len(kernels)}
        print(json.dumps(row), flush=True)
    print(device_info()["nvidia_smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
