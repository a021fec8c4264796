"""The port's multi-device dry run (fdtd2d_tpu_torch/parallel/dryrun.py)
on 8 CPU entries: every stage of __graft_entry__.dryrun_multichip runs and
is held to its single-device call within its bound."""

import torch

from fdtd2d_tpu_torch.parallel.dryrun import dryrun_multichip

STAGES = ("1 ", "2 ", "3 ", "4 ", "4b ", "4b' ", "4c ", "4d ", "4e ", "4f ", "5 ", "6 ")


def test_dryrun_on_eight_cpu_entries(tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = dryrun_multichip(["cpu"] * 8, workdir=str(tmp_path), rank_timeout=240)
    finally:
        torch.set_num_threads(n)
    assert len(out) == len(STAGES)
    for s in STAGES:
        assert any(k.startswith(s) for k in out), s
    for name, stage in out.items():
        assert stage["err"] <= stage["bound"], name
