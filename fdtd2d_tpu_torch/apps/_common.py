"""What the example workflows (``apps/ring_resonator.py``,
``tiled_vs_direct.py``, ``fdtd_video.py``, ``direct_large.py``,
``rank_study.py``, ``inverse_design_decade.py``) share: the device, the
card's clock, their output files and their command line.

Each workflow has a ``run(...)`` function with the JAX script's size as its
keyword default (its other settings are module constants), which returns
its numbers as a dict (numpy arrays under ``"arrays"``), and a command line that prints the JAX script's lines and
then one JSON object of the numbers. It saves the data of its figures as a
compressed npz in ``--out`` and draws the PNGs where matplotlib is
installed; ``--draw OUT_DIR`` draws them later from the npz.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import time
from typing import Callable, List

import numpy as np
import torch


def device_of(name) -> torch.device:
    """``name`` as a device; a CUDA device without a card is an error."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    return dev


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, device):
    """``(fn(), seconds)`` on the host clock, the device synchronized."""
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t0


def scaled(v: float, N: int, N0: int) -> int:
    """A JAX script's index ``v`` on its ``N0`` grid, moved to an ``N`` grid
    (``v`` itself at ``N = N0``)."""
    return int(round(v * N / N0))


def half(a) -> tuple:
    """``(a / max|a|`` as float16, ``max|a|)``: a field kept small for a
    figure, whatever its units."""
    a = np.asarray(a, np.float64)
    m = float(np.abs(a).max()) or 1.0
    return (a / m).astype(np.float16), m


def finish(name: str, numbers: dict, out_dir: str, draw: Callable[[str], List[str]],
           stem: str = None) -> dict:
    """Write ``out_dir/<stem>.json`` (``stem`` defaults to ``name``), draw the
    figures where matplotlib is installed, and print the numbers as the last
    line (without the arrays)."""
    numbers = {k: v for k, v in numbers.items() if k != "arrays"}
    with open(os.path.join(out_dir, f"{stem or name}.json"), "w") as f:
        json.dump(numbers, f)
    if importlib.util.find_spec("matplotlib") is not None:
        for path in draw(out_dir):
            print(f"wrote {path}")
    else:
        print(f"matplotlib is not installed: figures not drawn (python -m "
              f"fdtd2d_tpu_torch.apps.{name} --draw {out_dir} draws them)")
    print(json.dumps(numbers), flush=True)
    return numbers


def cli(name: str, doc: str, run: Callable, draw: Callable[[str], List[str]], argv=None,
        positionals: Callable[[argparse.ArgumentParser], None] = None,
        kwargs: Callable[[argparse.Namespace], dict] = None,
        stem: Callable[[dict], str] = None) -> int:
    """The command line of a workflow: ``--draw`` alone draws; else
    ``run(**kwargs(args), device=..., out=...)`` and :func:`finish`, whose
    JSON file is named ``stem(numbers)`` where given."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--out", default=".", help="directory for the npz, JSON and PNG files")
    p.add_argument("--draw", metavar="OUT_DIR", default=None,
                   help="only draw the PNGs from the npz in OUT_DIR")
    if positionals is not None:
        positionals(p)
    args = p.parse_args(argv)
    if args.draw:
        for path in draw(args.draw):
            print(f"wrote {path}")
        return 0
    os.makedirs(args.out, exist_ok=True)
    device = device_of(args.device)
    numbers = run(device=device, out=args.out, **(kwargs(args) if kwargs is not None else {}))
    if device.type == "cuda":
        from fdtd2d_tpu_torch.utils.metrics import device_info

        info = device_info()
        numbers.update(card=info["name"], power_limit=info["power_limit"])
    finish(name, numbers, args.out, draw, stem(numbers) if stem is not None else None)
    return 0
