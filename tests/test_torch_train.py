"""The port's training (fdtd2d_tpu_torch/models/train.py) against the JAX
package's: one train step in each recipe from the same Flax weights and the
same draws (loss at 1e-5, gradients at 1e-4, parameters after AdamW and
BatchNorm statistics at 1e-5, the EMA recursion), a bf16 step at a looser
bound, and the port's epoch loop, device caches, checkpoints and readouts."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fdtd2d_tpu.models import datagen as jdg
from fdtd2d_tpu.models import diffusion as jd
from fdtd2d_tpu.models import train as jt
from fdtd2d_tpu.models.unet import UNet2D as FlaxUNet
from fdtd2d_tpu_torch.models import datagen as tdg
from fdtd2d_tpu_torch.models import diffusion as td
from fdtd2d_tpu_torch.models import train as tt
from fdtd2d_tpu_torch.models.unet import UNet2D, unet_params_from_flax

SMALL = dict(channels=(8, 16, 32), bottleneck=64, time_embed_dim=64)
TINY = dict(channels=(4, 8, 16), bottleneck=32, time_embed_dim=32)
B, H = 4, 16


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flax_vars():
    f = jnp.zeros((1, 8, 8))
    return jax.jit(lambda k: FlaxUNet(**SMALL).init(
        k, f, f, f, f, jnp.zeros((1,), jnp.int32), jnp.zeros((1,)), train=False))(
        jax.random.PRNGKey(0))


def _batch(seed=0):
    """Every input channel varies: a constant channel's first-layer weights
    would act as a bias ahead of BatchNorm, with gradients near zero whose
    Adam step (about lr times their sign) is rounding noise."""
    rng = np.random.default_rng(seed)
    src = np.zeros((B, H, H), np.float32)
    src[:, H // 2, H // 2] = 1.0
    return {"eps": rng.uniform(0, 1, (B, H, H)).astype(np.float32),
            "mu": rng.uniform(0.5, 1.5, (B, H, H)).astype(np.float32), "src": src,
            "omega": np.linspace(0.5, 1.5, B).astype(np.float32),
            "Ez": rng.standard_normal((B, H, H)).astype(np.float32)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _schedules():
    js = jd.DDPMSchedule.create(1000)
    return js, td.DDPMSchedule(betas=torch.tensor(np.asarray(js.betas)),
                               alphas_cumprod=torch.tensor(np.asarray(js.alphas_cumprod)))


def _states(flax_vars, cfg, dtype=jnp.float32):
    """The JAX TrainState of the Flax small UNet and the port's state
    holding the same weights (both AdamW at cfg.lr, EMA seeded at them)."""
    params, stats = flax_vars["params"], flax_vars["batch_stats"]
    jstate = jt.TrainState.create(
        apply_fn=FlaxUNet(**SMALL, dtype=dtype).apply, params=params, batch_stats=stats,
        ema_params=params if cfg.ema_decay > 0 else None, tx=optax.adamw(cfg.lr))
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tstate = tt.create_state(0, (H, H), cfg, model=UNet2D(**SMALL, dtype=tdtype), device="cpu")
    tstate.model.load_state_dict(unet_params_from_flax(_np_tree(params), _np_tree(stats)))
    if tstate.ema_params is not None:
        tstate.ema_params = {n: p.detach().clone() for n, p in tstate.model.named_parameters()}
    return jstate, tstate


def _jax_draws(js, key, shape, *, t_sampling, t_gamma=1.3, augment=False):
    """The t, noise and D4 elements JAX's train_step draws from ``key``."""
    k_t, k_noise, k_aug = jax.random.split(key, 3)
    if t_sampling == "uniform":
        t = jax.random.randint(k_t, (shape[0],), 0, js.num_timesteps)
    else:
        t = jd.importance_sample_timesteps(js, k_t, shape[0], gamma=t_gamma)
    noise = jax.random.normal(k_noise, shape, jnp.float32)
    g = jax.random.randint(k_aug, (shape[0],), 0, 8) if augment else None
    return tt.StepDraws(torch.tensor(np.asarray(t)), torch.tensor(np.asarray(noise)),
                        None if g is None else torch.tensor(np.asarray(g)))


def _bn_fed_bias(name):
    """Every UNet conv but the head feeds a train-mode BatchNorm, which
    removes its bias: that bias has a zero gradient in exact arithmetic, so
    both sides hold rounding noise, and Adam's first step moves each entry by
    about lr times that noise's sign."""
    return ".convs." in name and name.endswith("bias")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


RECIPES = {
    # the reference's recipe, with the D4 augmentation and an EMA
    "epsilon-snr-snr_gamma": dict(prediction_type="epsilon", t_sampling="snr",
                                  weighting="snr_gamma", ema_decay=0.5, augment=True),
    "x0-uniform-uniform": dict(prediction_type="x0", t_sampling="uniform", weighting="uniform"),
    # t = 0 for every sample adds the same time embedding to each one at the
    # bottleneck: a per-channel offset that the next BatchNorm's float32
    # E[x^2] - E[x]^2 variance cancels badly, so the Flax module's float32
    # gradients lie 0.5-1.4% from its own float64 ones (the port's lie 2e-6
    # from float64); the reference is JAX's train_step with the module
    # computing in float64 (float32 parameters, loss and optimizer)
    "regression": dict(prediction_type="regression", t_sampling="snr", weighting="snr_gamma",
                       ref_dtype=jnp.float64),
    "epsilon-snr-min_snr": dict(prediction_type="epsilon", t_sampling="snr",
                                weighting="min_snr"),
}


def _check_params_after_step(tstate, params0, jnew, jgrad, lr):
    """Parameters and BatchNorm statistics after one step at 1e-5 of each
    tensor's largest entry. Adam's first step moves an entry by
    lr g / (|g| + eps), about lr times the sign of g; where an entry's
    gradient is below 1e-2 of its tensor's largest, the gradients' own
    1e-4 agreement no longer fixes that sign, and the entry is held to move
    at most lr on both sides instead (with the weight decay's lr * 1e-4 * |p|).
    optax takes Adam's bias correction 1 - b2^t in float32 (1.3e-5 from the
    exact 1e-3 at t = 1; torch takes it in float64), so the updates
    themselves differ by ~6.5e-6 of lr: a tensor that starts at zero, whose
    largest entry after the step is about lr, is held at 5e-5 lr."""
    want = unet_params_from_flax(_np_tree(jnew.params), _np_tree(jnew.batch_stats))
    got = tstate.model.state_dict()
    for n, v in want.items():
        if "running" in n:
            assert _rel(got[n], v) <= 1e-5, (n, _rel(got[n], v))
            continue
        g = jgrad[n].abs()
        sure = (g >= 1e-2 * g.max()) & (not _bn_fed_bias(n))
        if sure.any():
            bound = 1e-5 * float(v.abs().max()) + 5e-5 * lr
            assert float((got[n] - v)[sure].abs().max()) <= bound, n
        for side in (got[n], v):
            assert float((side - params0[n]).abs().max()) <= 1.01 * lr, n
        assert not torch.equal(got[n], params0[n]), n


def test_adamw_is_optax_adamw():
    """The port's optimizer (create_state) and optax.adamw(lr) on the same
    parameters and gradients: weight decay 1e-4, b1 0.9, b2 0.999, eps 1e-8,
    three steps, at 1e-6."""
    cfg = tt.TrainConfig(lr=1e-2)
    state = tt.create_state(0, (H, H), cfg, model=UNet2D(**TINY), device="cpu")
    params = [p for p in state.model.parameters()]
    # copies: a zero-copy jnp.asarray of a torch tensor's numpy view would see
    # the port's in-place updates
    jp = [jnp.array(p.detach().numpy().copy()) for p in params]
    tx = optax.adamw(cfg.lr)
    opt = tx.init(jp)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = [rng.standard_normal(p.shape).astype(np.float32) for p in params]
        for p, g in zip(params, grads):
            p.grad = torch.tensor(g)
        state.optimizer.step()
        upd, opt = update([jnp.asarray(g) for g in grads], opt, jp)
        jp = optax.apply_updates(jp, upd)
    for p, q in zip(params, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", list(RECIPES))
def test_train_step_matches_jax(flax_vars, name):
    r = RECIPES[name]
    ema, augment = r.get("ema_decay", 0.0), r.get("augment", False)
    cfg = tt.TrainConfig(batch_size=B, ema_decay=ema)
    jstate, tstate = _states(flax_vars, jt.TrainConfig(batch_size=B, ema_decay=ema),
                             r.get("ref_dtype", jnp.float32))
    js, ts = _schedules()
    batch = _batch()
    key = jax.random.PRNGKey(3)
    kw = dict(prediction_type=r["prediction_type"], t_sampling=r["t_sampling"],
              weighting=r["weighting"], ema_decay=ema, augment=augment)
    jnew, jloss = jt.train_step(jstate, js, key, {k: jnp.asarray(v) for k, v in batch.items()},
                                **kw)
    draws = _jax_draws(js, key, (B, H, H), t_sampling=r["t_sampling"], augment=augment)
    params0 = {n: p.detach().clone() for n, p in tstate.model.named_parameters()}
    tstate, tloss = tt.train_step(tstate, ts, None, {k: torch.tensor(v) for k, v in batch.items()},
                                  draws=draws, **kw)
    assert tloss.dtype == torch.float32 and tstate.step == int(jnew.step) == 1
    assert _rel(tloss, jloss) <= 1e-5, (float(tloss), float(jloss))

    # gradients: optax's first moment after one step is (1 - b1) g
    jgrad = unet_params_from_flax(jax.tree.map(lambda m: np.asarray(m) / 0.1,
                                               jnew.opt_state[0].mu))
    grads = {n: p.grad for n, p in tstate.model.named_parameters()}
    top = max(float(g.abs().max()) for g in jgrad.values())
    for n, g in grads.items():
        if _bn_fed_bias(n):
            assert max(float(g.abs().max()), float(jgrad[n].abs().max())) <= 1e-5 * top, n
            continue
        err = _rel(g, jgrad[n])
        assert err <= 1e-4, (n, err)

    _check_params_after_step(tstate, params0, jnew, jgrad, cfg.lr)

    if ema:
        # warm-up decay after the first step: min(0.5, 2/11)
        eff = np.float32(2.0) / np.float32(11.0)
        jema = unet_params_from_flax(_np_tree(jnew.ema_params))
        for n, p in tstate.model.named_parameters():
            e = tstate.ema_params[n]
            np.testing.assert_allclose(e.numpy(), eff * params0[n].numpy()
                                       + (1 - eff) * p.detach().numpy(), rtol=1e-6, atol=1e-9)
            assert _bn_fed_bias(n) or _rel(e, jema[n]) <= 1e-5, n
        assert tt.ema_state(tstate).model is not tstate.model
        read = dict(tt.ema_state(tstate).model.named_parameters())
        assert all(torch.equal(read[n], tstate.ema_params[n]) for n in read)


def test_train_step_bfloat16_matches_jax(flax_vars):
    """bf16 compute on both sides: the loss within 2e-2 relative, the
    parameters within the step's own size (2 lr) of JAX's, and float32
    master parameters, loss and optimizer state."""
    cfg = jt.TrainConfig(batch_size=B, compute_dtype="bfloat16")
    jstate, tstate = _states(flax_vars, cfg, jnp.bfloat16)
    js, ts = _schedules()
    batch = _batch(1)
    key = jax.random.PRNGKey(4)
    jnew, jloss = jt.train_step(jstate, js, key, {k: jnp.asarray(v) for k, v in batch.items()})
    draws = _jax_draws(js, key, (B, H, H), t_sampling="snr")
    tstate, tloss = tt.train_step(tstate, ts, None,
                                  {k: torch.tensor(v) for k, v in batch.items()}, draws=draws)
    assert tloss.dtype == torch.float32
    assert _rel(tloss, jloss) <= 2e-2, (float(tloss), float(jloss))
    assert all(p.dtype == torch.float32 for p in tstate.model.parameters())
    assert all(v.dtype == torch.float32 for st in tstate.optimizer.state.values()
               for v in st.values() if v.ndim)
    want = unet_params_from_flax(_np_tree(jnew.params))
    got = tstate.model.state_dict()
    for n, v in want.items():
        # the step moves each entry by at most lr: the parameters after it
        # agree to that, whatever bf16 does to the gradients
        assert float((got[n] - v).abs().max()) <= 2.02 * cfg.lr, n


def _tiny_state(cfg, seed=0):
    return tt.create_state(seed, (H, H), cfg, model=UNet2D(**TINY), device="cpu")


def _tiny_data(n=10, seed=0):
    rng = np.random.default_rng(seed)
    eps_mask = rng.random((n, H, H)) > 0.5
    src = np.zeros((n, H, H), np.float32)
    src[np.arange(n), rng.integers(3, H - 3, n), rng.integers(3, H - 3, n)] = 1.0
    return {"eps": np.where(eps_mask, np.float32(tdg.EPS_HI), np.float32(tdg.EPS_LO)),
            "mu": np.full((n, H, H), np.float32(tdg.MU_REF)), "src": src,
            "omega": rng.uniform(18e9, 30e9, n).astype(np.float32),
            "Ez": rng.standard_normal((n, H, H)).astype(np.float32)}


def test_train_epoch_drops_the_tail():
    """10 samples at batch 4: two steps, the tail dropped; one float loss;
    a batch past the data raises."""
    cfg = tt.TrainConfig(batch_size=4)
    state = _tiny_state(cfg)
    data = tt.normalize({k: torch.tensor(v) for k, v in _tiny_data().items()},
                        tt.compute_scales({k: torch.tensor(v) for k, v in _tiny_data().items()}))
    sched = td.DDPMSchedule.create(100, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, loss = tt.train_epoch(state, sched, gen, data, torch.randperm(10, generator=gen),
                                 batch_size=4)
    assert state.step == 2 and isinstance(loss, float) and np.isfinite(loss)
    with pytest.raises(ValueError, match="exceeds dataset size"):
        tt.train_epoch(state, sched, gen, data, torch.arange(3), batch_size=4)


@pytest.mark.parametrize("hw, boxy", [(16, True), (20, True), (16, False)])
def test_compact_cache_decodes_as_jax(tmp_path, hw, boxy):
    """The compact device cache (bit-packed eps where W % 8 == 0, source
    boxes where every source is a box) decodes on the device to the JAX
    package's ``_decode_compact`` of the same file, normalized."""
    rng = np.random.default_rng(5)
    n = 6
    data = {"eps": np.where(rng.random((n, hw, hw)) > 0.5, np.float32(jdg.EPS_HI),
                            np.float32(jdg.EPS_LO)),
            "mu": np.full((n, hw, hw), np.float32(jdg.MU_REF)),
            "src": np.zeros((n, hw, hw), np.float32),
            "omega": rng.uniform(18e9, 30e9, n).astype(np.float32),
            "Ez": rng.standard_normal((n, hw, hw)).astype(np.float32)}
    for i in range(n):
        r, c = 4 + i, 3 + i
        if boxy:
            data["src"][i, r, c:c + 1 + i % 3] = 1.0
        else:
            data["src"][i, r + np.arange(3), c + np.arange(3)] = 1.0
    p = str(tmp_path / "d.npz")
    jdg.save_dataset(p, data, compact=True)
    raw = tdg.load_dataset(p, decode=False)
    scales, arrays, affine, const = tt._compact_cache(raw, None, "cpu")
    assert ("eps_bits" in arrays) == (hw % 8 == 0) and ("src_box" in arrays) == boxy
    idx = torch.tensor([4, 0, 2])
    got = tt._decode_batch(arrays, idx, affine, const)
    want = jdg._decode_compact(jdg.load_dataset(p, decode=False))
    for k in ("eps", "mu", "src", "omega"):
        w = want[k][idx.numpy()] / (float(scales[k]) if k in scales else 1.0)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6, err_msg=k)
    ez = (want["Ez"][idx.numpy()] / np.float32(float(scales["Ez"]))).astype(np.float16)
    np.testing.assert_array_equal(got["Ez"].numpy(), ez.astype(np.float32))


@pytest.mark.parametrize("ema, with_scales", [(0.0, True), (0.9, True), (0.0, False)])
def test_checkpoint_round_trip(tmp_path, ema, with_scales):
    cfg = tt.TrainConfig(batch_size=4, ema_decay=ema)
    state = _tiny_state(cfg)
    data = {k: torch.tensor(v[:4]) for k, v in _tiny_data().items()}
    sched = td.DDPMSchedule.create(100, device="cpu")
    state, _ = tt.train_step(state, sched, torch.Generator().manual_seed(0),
                             tt.normalize(data, tt.compute_scales(data)), ema_decay=ema)
    scales = {"eps": 2.0, "mu": 3.0, "Ez": 0.5, "omega": 1e10} if with_scales else None
    tt.save_checkpoint(str(tmp_path), state, epoch=3, scales=scales)
    fresh = _tiny_state(cfg, seed=9)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        restored, next_epoch, got_scales = tt.restore_checkpoint(str(tmp_path), fresh)
    assert any("no normalization scales" in str(x.message) for x in w) == (not with_scales)
    assert next_epoch == 4 and restored.step == 1
    if with_scales:
        assert {k: float(v) for k, v in got_scales.items()} == pytest.approx(scales)
    else:
        assert got_scales is None
    for a, b in zip(state.model.state_dict().values(), restored.model.state_dict().values()):
        assert torch.equal(a, b)
    sa, sb = state.optimizer.state_dict(), restored.optimizer.state_dict()
    for k in sa["state"]:
        assert all(torch.equal(torch.as_tensor(sa["state"][k][f]),
                               torch.as_tensor(sb["state"][k][f])) for f in sa["state"][k])
    if ema:
        assert all(torch.equal(state.ema_params[n], restored.ema_params[n])
                   for n in state.ema_params)
        # an EMA-unaware reader (the infer path) still picks the stored EMA up
        plain, _, _ = tt.restore_checkpoint(str(tmp_path), _tiny_state(tt.TrainConfig()))
        assert plain.ema_params is not None
    else:
        # an EMA-enabled reader of an EMA-less file re-seeds from the params
        with pytest.warns(UserWarning, match="no EMA params"):
            emaed, _, _ = tt.restore_checkpoint(str(tmp_path),
                                                _tiny_state(tt.TrainConfig(ema_decay=0.9)))
        assert all(torch.equal(emaed.ema_params[n], p)
                   for n, p in emaed.model.named_parameters())
    assert tt.restore_checkpoint(str(tmp_path / "none"), fresh)[1:] == (0, None)


def test_holdout_relative_l2_and_readouts():
    """holdout_relative_l2 is the per-sample relative L2 of ``inference`` in
    chunks; inference, regress and a chunked ensemble are finite, of the
    data's shape and in physical units."""
    cfg = tt.TrainConfig(batch_size=4)
    state = _tiny_state(cfg)
    sched = td.DDPMSchedule.create(100, device="cpu")
    data = _tiny_data(n=5)
    scales = tt.compute_scales_host(data)
    rel = tt.holdout_relative_l2(state, sched, torch.Generator().manual_seed(1), data, scales,
                                 num_inference_steps=4, chunk=2)
    gen = torch.Generator().manual_seed(1)
    preds = [tt.inference(state, sched, gen, *(torch.tensor(data[k][sl])
                                               for k in ("eps", "mu", "src", "omega")),
                          num_inference_steps=4, scales=scales).numpy()
             for sl in (slice(0, 2), slice(2, 4), slice(4, 5))]
    pred = np.concatenate(preds)
    want = (np.linalg.norm((pred - data["Ez"]).reshape(5, -1), axis=1)
            / np.linalg.norm(data["Ez"].reshape(5, -1), axis=1))
    assert rel.shape == (5,)
    np.testing.assert_allclose(rel, want, rtol=1e-6)
    args = [torch.tensor(data[k]) for k in ("eps", "mu", "src", "omega")]
    out = tt.regress(state, sched, torch.Generator().manual_seed(0), *args, scales=scales)
    ens = tt.ensemble_inference(state, sched, torch.Generator().manual_seed(0), *args,
                                n_members=2, num_inference_steps=3, scales=scales, chunk=2)
    for y in (out, ens):
        assert y.shape == (5, H, H) and bool(torch.isfinite(y).all())
    # denormalized: the model's unit-std output times the Ez scale
    assert float(out.std()) > 0.05 * float(scales["Ez"])


@pytest.mark.parametrize("mode", ["device", "stream", "f16", "compact"])
def test_train_runs_and_resumes(tmp_path, mode):
    """train() on each data path: finite losses, a checkpoint a run, and a
    resumed run that starts where the last one stopped."""
    data = _tiny_data(n=10)
    kw = {"device": dict(), "stream": dict(stream_chunk=4),
          "f16": dict(device_dtype=torch.float16), "compact": dict(device_dtype="compact")}[mode]
    if mode == "compact":
        p = str(tmp_path / "d.npz")
        tdg.save_dataset(p, data, compact=True)
        data = tdg.load_dataset(p, decode=False)
    ck = str(tmp_path / "ck")
    cfg = tt.TrainConfig(batch_size=4, num_epochs=1, num_train_timesteps=50, ckpt_dir=ck,
                         prediction_type="x0", t_sampling="uniform", loss_weighting="uniform",
                         ema_decay=0.9, augment=True)
    evals = []
    state, losses, scales = tt.train(0, data, cfg, state=_tiny_state(cfg), device="cpu",
                                     holdout=2, eval_every=1,
                                     eval_callback=lambda e, p, t: evals.append((e, p.shape)),
                                     holdout_callback=lambda e, r: evals.append((e, r.shape)),
                                     **kw)
    assert len(losses) == 1 and np.isfinite(losses[0]) and state.step == 2
    assert evals == [(0, (H, H)), (0, (2,))]
    cfg2 = tt.TrainConfig(**{**cfg.__dict__, "num_epochs": 2})
    state2, losses2, scales2 = tt.train(0, data, cfg2, state=_tiny_state(cfg2), device="cpu",
                                        holdout=2, **kw)
    assert len(losses2) == 1 and state2.step == 4
    assert {k: float(v) for k, v in scales2.items()} == {k: float(v) for k, v in scales.items()}
    if mode == "device":
        cfg0 = tt.TrainConfig(**{**cfg.__dict__, "ckpt_dir": None})
        with pytest.raises(ValueError, match="decode=False"):
            tt.train(0, data, cfg0, state=_tiny_state(cfg0), device_dtype="compact",
                     device="cpu")
