"""The port's UNet2D (fdtd2d_tpu_torch/models/unet.py) against the Flax
module of fdtd2d_tpu/models/unet.py, with the Flax weights carried across by
``unet_params_from_flax``: eval and train forward passes and the updated
BatchNorm running statistics at 1e-5, on a size divisible by 8 and on one
that is not (where ``jax.image.resize``'s half-pixel nearest sampling and
torch's plain "nearest" differ)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtd2d_tpu.models.unet import UNet2D as FlaxUNet
from fdtd2d_tpu.models.unet import sinusoidal_embedding as jax_embedding
from fdtd2d_tpu_torch.models.unet import UNet2D, sinusoidal_embedding, unet_params_from_flax

SMALL = dict(channels=(8, 16, 32), bottleneck=64, time_embed_dim=64)
TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _inputs(B, H, seed=0):
    rng = np.random.default_rng(seed)
    fields = [rng.standard_normal((B, H, H)).astype(np.float32) for _ in range(4)]
    t = rng.integers(0, 1000, B).astype(np.int32)
    omega = rng.uniform(1.8, 3.0, B).astype(np.float32)
    return fields, t, omega


@pytest.fixture(scope="module")
def fvars():
    """Flax variables of the small UNet (their shapes do not depend on the
    grid) with random BatchNorm scales, biases and statistics, so every
    carried tensor matters."""
    f = jnp.zeros((1, 8, 8))
    v = jax.jit(lambda k: FlaxUNet(**SMALL).init(k, f, f, f, f, jnp.zeros((1,), jnp.int32),
                                                 jnp.zeros((1,)), train=False))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)

    def jitter(path, a):
        name = path[-1].key
        if name in ("scale", "var"):
            return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
        if name in ("bias", "mean"):
            return jnp.asarray(rng.normal(0.0, 0.2, a.shape), a.dtype)
        return a

    return {"params": jax.tree_util.tree_map_with_path(jitter, v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(jitter, v["batch_stats"])}


def _port(flax_vars, dtype=torch.float32):
    model = UNet2D(**SMALL, dtype=dtype)
    params = jax.tree.map(np.asarray, flax_vars["params"])
    stats = jax.tree.map(np.asarray, flax_vars["batch_stats"])
    model.load_state_dict(unet_params_from_flax(params, stats))
    return model


def _stats_of(model):
    return {k: v.numpy() for k, v in model.state_dict().items() if "running" in k}


def _flax_stats(batch_stats):
    out = {}
    for i in range(7):
        for j in range(2):
            st = batch_stats[f"ConvBlock_{i}"][f"BatchNorm_{j}"]
            out[f"blocks.{i}.norms.{j}.running_mean"] = np.asarray(st["mean"])
            out[f"blocks.{i}.norms.{j}.running_var"] = np.asarray(st["var"])
    return out


def test_sinusoidal_embedding_matches_jax():
    t = np.array([0, 1, 17, 500, 999], np.int32)
    got = sinusoidal_embedding(torch.tensor(t), 64).numpy()
    want = np.asarray(jax_embedding(jnp.asarray(t), 64))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _flax_apply(dtype=jnp.float32, train=False):
    model = FlaxUNet(**SMALL, dtype=dtype)
    if train:
        return jax.jit(lambda v, *a: model.apply(v, *a, train=True, mutable=["batch_stats"]))
    return jax.jit(lambda v, *a: model.apply(v, *a, train=False))


@pytest.mark.parametrize("H", [32, 20])
def test_forward_matches_flax(fvars, H):
    """Eval and train forward passes, and the running statistics after one
    train-mode pass (momentum 0.99, biased batch variance), at 1e-5."""
    model = _port(fvars)
    fields, t, omega = _inputs(2, H)
    jargs = [jnp.asarray(a) for a in fields] + [jnp.asarray(t), jnp.asarray(omega)]
    targs = [torch.tensor(a) for a in fields] + [torch.tensor(t), torch.tensor(omega)]

    want = np.asarray(_flax_apply()(fvars, *jargs))
    got = model(*targs, train=False).detach().numpy()
    assert got.shape == (2, H, H) and got.dtype == np.float32
    assert _rel(got, want) <= TOL, _rel(got, want)

    want, upd = _flax_apply(train=True)(fvars, *jargs)
    got = model(*targs, train=True).detach().numpy()
    assert _rel(got, np.asarray(want)) <= TOL, _rel(got, want)
    ours, theirs = _stats_of(model), _flax_stats(upd["batch_stats"])
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert _rel(ours[k], theirs[k]) <= TOL, (k, _rel(ours[k], theirs[k]))


def test_nearest_exact_is_what_jax_resizes():
    """62 -> 125 (the CLI's 250^2 at the bottleneck's way up): torch's
    "nearest-exact" is jax.image.resize's "nearest"; plain "nearest" is not."""
    x = np.random.default_rng(0).standard_normal((1, 3, 62, 62)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3, 125, 125), "nearest"))
    F = torch.nn.functional
    exact = F.interpolate(torch.tensor(x), size=(125, 125), mode="nearest-exact").numpy()
    plain = F.interpolate(torch.tensor(x), size=(125, 125), mode="nearest").numpy()
    np.testing.assert_array_equal(exact, want)
    assert np.abs(plain - want).max() > 1.0


def test_bfloat16_forward_tracks_flax_bfloat16(fvars):
    """bf16 compute: output float32, parameters float32, and within bf16
    roundoff (5e-2 of max |y|, the JAX package's own bound) of both the
    Flax bf16 module and the port's float32 forward."""
    H = 32
    model = _port(fvars, torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    fields, t, omega = _inputs(2, H)
    targs = [torch.tensor(a) for a in fields] + [torch.tensor(t), torch.tensor(omega)]
    y_bf = model(*targs, train=False).detach()
    assert y_bf.dtype == torch.float32
    jargs = [jnp.asarray(a) for a in fields] + [jnp.asarray(t), jnp.asarray(omega)]
    want = np.asarray(_flax_apply(jnp.bfloat16)(fvars, *jargs))
    assert _rel(y_bf.numpy(), want) < 5e-2
    y32 = _port(fvars)(*targs, train=False).detach().numpy()
    assert _rel(y_bf.numpy(), y32) < 5e-2


def test_init_is_flax_lecun_normal():
    """Full-width UNet2D: every conv/dense weight with >= 4096 entries has a
    std within 5% of sqrt(1/fan_in) and no entry past two of the
    un-truncated normal's standard deviations; biases zero; BatchNorm at
    (1, 0) with statistics (0, 1); channels_last conv weights; the same
    seed gives the same weights."""
    g = torch.Generator().manual_seed(0)
    model = UNet2D(generator=g)
    checked = 0
    for name, p in model.named_parameters():
        p = p.detach()
        if name.endswith("bias"):
            assert not p.any(), name
        elif ".norms." in name:
            assert torch.equal(p, torch.ones_like(p)), name
        else:
            fan_in = p[0].numel()
            bound = 2 * math.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert float(p.abs().max()) <= bound, name
            if p.numel() >= 4096:
                std = float(p.std())
                assert abs(std / math.sqrt(1.0 / fan_in) - 1) < 0.05, (name, std)
                checked += 1
            if p.ndim == 4:
                assert p.is_contiguous(memory_format=torch.channels_last), name
    assert checked >= 17
    for name, b in model.named_buffers():
        assert torch.equal(b, torch.zeros_like(b) if "mean" in name else torch.ones_like(b))
    again = UNet2D(generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    with pytest.raises(ValueError):
        UNet2D(time_embed_dim=64, bottleneck=32)
