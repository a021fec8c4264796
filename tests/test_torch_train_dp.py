"""The data-parallel train step (fdtd2d_tpu_torch/parallel/train_dp.py) on
two gloo ranks of CPU processes, held to the port's single-device
train_step on the same batch and draws (that step is held to JAX's by
tests/test_torch_train.py); the synchronized BatchNorm against the native
one."""

import numpy as np
import pytest
import torch

from fdtd2d_tpu_torch.models.unet import BatchNorm, synchronized_batchnorm
from fdtd2d_tpu_torch.parallel import train_dp

# the small UNet of __graft_entry__.py:184-190
SMALL = dict(channels=(4, 8, 16), bottleneck=32, time_embed_dim=32)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Two gloo CPU ranks, 32^2, global batch 4, float64, 3 steps, the
    reference recipe without and with D4 augmentation, in one spawn."""
    specs = [dict(model=SMALL, dtype=torch.float64, seed=0, steps=3,
                  batch=train_dp.random_batch(4, 32), recipe=dict(augment=augment),
                  devices=["cpu", "cpu"]) for augment in (False, True)]
    runs = train_dp.train_ranks(specs, str(tmp_path_factory.mktemp("ranks")), timeout=240)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    refs = [train_dp.reference_steps(spec, "cpu") for spec in specs]
    torch.set_num_threads(n)
    return runs, refs


@pytest.mark.parametrize("case", [0, 1], ids=["plain", "augment"])
def test_dp_step_equals_single_device(dp_runs, case):
    """Losses and parameters (with the BatchNorm running statistics) within
    1e-10 of the single-device step's after 3 steps; every rank ends with
    the same parameters, bit for bit."""
    ranks, ref = dp_runs[0][case], dp_runs[1][case]
    for r in ranks:
        assert np.max(np.abs(np.subtract(r["losses"], ref["losses"]))) <= 1e-10
        assert train_dp.max_param_diff(r["params"], ref["params"]) <= 1e-10
    assert train_dp.max_param_diff(ranks[0]["params"], ranks[1]["params"]) == 0.0
    assert ref["losses"][0] != ref["losses"][-1]   # the steps moved the parameters


def test_backend_rule():
    assert train_dp.backend_for(["cpu", "cpu"]) == "gloo"
    assert train_dp.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert train_dp.backend_for(["cuda:0", "cuda:1"]) == "nccl"


def _fail(rank, world, group):
    raise ValueError(f"rank {rank} fails")


def _hang(rank, world, group):
    import time

    time.sleep(60 * rank)


def test_run_ranks_reports_failures_and_time_limits(tmp_path):
    """A rank that raises fails the run with its traceback; a rank that
    hangs (and the rank that waits for it) is killed at the time limit."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    with pytest.raises(RuntimeError, match="rank 0 fails"):
        train_dp.run_ranks(_fail, 2, "gloo", str(tmp_path / "a"), timeout=60)
    with pytest.raises(TimeoutError, match="still running after 6 s"):
        train_dp.run_ranks(_hang, 2, "gloo", str(tmp_path / "b"), timeout=6)


def test_synchronized_batchnorm_single_rank_equals_native(tmp_path):
    """On a group of one rank (this process) the synchronized form is the
    native pass: the output, the running statistics and the gradients within
    1e-12 in float64."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        out = _bn_rank(0, 1, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    for k, (a, b) in out.items():
        assert float((a - b).abs().max()) <= 1e-12, k


def _bn_rank(rank, world, group):
    torch.manual_seed(0)
    x = (torch.randn(3, 5, 6, 7, dtype=torch.float64) * 2 + 1).requires_grad_()
    dy = torch.randn(3, 5, 6, 7, dtype=torch.float64)
    weight = torch.rand(5, dtype=torch.float64) + 0.5
    bias = torch.rand(5, dtype=torch.float64) - 0.5
    res = {}
    for sync in (False, True):
        bn = BatchNorm(5).double()
        with torch.no_grad():
            bn.weight.copy_(weight)
            bn.bias.copy_(bias)
        bn.train()
        x.grad = None
        if sync:
            with synchronized_batchnorm(bn, group):
                y = bn(x)
        else:
            y = bn(x)
        (y * dy).sum().backward()
        res[sync] = [y.detach(), bn.running_mean.clone(), bn.running_var.clone(),
                     x.grad.clone(), bn.weight.grad.clone(), bn.bias.grad.clone()]
    names = ("y", "running_mean", "running_var", "dx", "dweight", "dbias")
    return {n: (a, b) for n, a, b in zip(names, res[False], res[True])}
