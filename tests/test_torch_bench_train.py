"""The two train-step rows of the port's bench (bench.py's ``trainstep``
and ``trainstepbf16``) at their CPU size: a 32-step ``train_epoch`` of the
full-width ``UNet2D()`` at 64^2, batch 8, bench.py's off-TPU size; and the
FLOP count both rows print (``utils/metrics.step_flops``, which
tools/bench_surrogate.py reads too). The step itself is held to the JAX
package by tests/test_torch_train.py."""

import numpy as np
import pytest
import torch

from fdtd2d_tpu_torch import bench
from fdtd2d_tpu_torch.utils.metrics import step_flops


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(B, H, seed=0):
    g = torch.Generator().manual_seed(seed)
    batch = {k: torch.randn((B, H, H), generator=g) for k in ("eps", "mu", "src", "Ez")}
    batch["omega"] = torch.full((B,), 2.4)
    return batch


@pytest.mark.parametrize("name, metric", [("trainstep", "train_step_b8_64sq"),
                                          ("trainstepbf16", "train_step_b8_64sq_bf16")])
def test_trainstep_row_at_cpu_size(name, metric):
    """bench.py's off-TPU metric; a finite time; no baseline ratio and no
    share of the bf16 peak off the card (bench.py prints both on the TPU
    only); the step's FLOPs, the same count in both rows (the same function
    on the same shapes)."""
    row = bench.run_row(name, "cpu")
    assert row["metric"] == metric and row["unit"] == "ms"
    assert np.isfinite(row["value"]) and row["value"] > 0
    assert row["vs_baseline"] is None and "mfu_vs_bf16_peak" not in row
    assert row["card"] == "cpu"
    assert row["flops_per_step"] > 0
    assert row["flops_per_step"] == step_flops(_batch(8, 64))


def test_step_flops_at_a_small_size():
    """Every counted product (convolutions, the embeddings' dense layers)
    carries the batch axis: twice the batch is twice the count; the count
    depends on the shapes only, not on the values."""
    two = step_flops(_batch(2, 16))
    assert two > 0
    assert step_flops(_batch(4, 16)) == 2 * two
    assert step_flops(_batch(2, 16, seed=1)) == two
    assert step_flops(_batch(2, 32)) > two
