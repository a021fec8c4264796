"""The port's surrogate evaluation layer (fdtd2d_tpu_torch/apps/
surrogate_report.py, surrogate_diagnose.py, surrogate_scaling_table.py)
against the JAX package: the metrics against the JAX example's arithmetic
(1e-12), the readouts from the same Flax weights and the same draws (1e-4
relative on the fields, 1e-4 absolute on each corr and fitted rel-L2), the
report end to end on a tiny port dataset and checkpoint, the diagnose probes
against the JAX example's arithmetic, and the scaling table's banked row."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fdtd2d_tpu.models import diffusion as jd
from fdtd2d_tpu.models import train as jt
from fdtd2d_tpu.models.unet import UNet2D as FlaxUNet
from fdtd2d_tpu_torch.apps import surrogate_diagnose as sd
from fdtd2d_tpu_torch.apps import surrogate_report as sr
from fdtd2d_tpu_torch.apps import surrogate_scaling_table as st
from fdtd2d_tpu_torch.models import datagen as tdg
from fdtd2d_tpu_torch.models import diffusion as td
from fdtd2d_tpu_torch.models import train as tt
from fdtd2d_tpu_torch.models.unet import UNet2D, unet_params_from_flax

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(channels=(8, 16, 32), bottleneck=64, time_embed_dim=64)
TINY = dict(channels=(4, 8, 16), bottleneck=32, time_embed_dim=32)
B, H = 4, 32
BANKED = ROOT / "assets" / "surrogate_x0" / "holdout_report.npz"


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_metrics(pred, true):
    """examples/surrogate_report.py:118-131, written out."""
    holdout = len(true)
    P = pred.reshape(holdout, -1).astype(np.float64)
    T = true.reshape(holdout, -1).astype(np.float64)
    tn = np.linalg.norm(T, axis=1) + 1e-30
    rel = np.linalg.norm(P - T, axis=1) / tn
    Pc = P - P.mean(axis=1, keepdims=True)
    Tc = T - T.mean(axis=1, keepdims=True)
    corr = (Pc * Tc).sum(1) / (np.linalg.norm(Pc, axis=1)
                               * np.linalg.norm(Tc, axis=1) + 1e-30)
    a = (P * T).sum(1) / ((P * P).sum(1) + 1e-30)
    rel_fit = np.linalg.norm(a[:, None] * P - T, axis=1) / tn
    return rel, rel_fit, corr


def test_holdout_metrics_match_the_jax_example():
    rng = np.random.default_rng(0)
    true = rng.standard_normal((6, 20, 24)).astype(np.float32)
    # a near-copy, a scaled copy, noise and an anti-correlated field
    pred = np.stack([true[0] + 0.1 * rng.standard_normal((20, 24)), 0.25 * true[1],
                     *rng.standard_normal((3, 20, 24)), -true[5]]).astype(np.float32)
    for got, want in zip(sr.holdout_metrics(pred, true), _jax_metrics(pred, true)):
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    _, rel_fit, corr = sr.holdout_metrics(pred, true)
    assert corr[1] == pytest.approx(1.0) and rel_fit[1] == pytest.approx(0.0, abs=1e-7)
    assert corr[5] == pytest.approx(-1.0)


# -- the readouts from shared weights and draws --------------------------------


@pytest.fixture(scope="module")
def shared():
    """A small Flax UNet's JAX state and the port's state holding its
    weights, a schedule from JAX's arrays, 4 scenes at 32^2 and their scales."""
    f = jnp.zeros((1, 8, 8))
    variables = jax.jit(lambda k: FlaxUNet(**SMALL).init(
        k, f, f, f, f, jnp.zeros((1,), jnp.int32), jnp.zeros((1,)), train=False))(
        jax.random.PRNGKey(0))
    params, stats = variables["params"], variables["batch_stats"]
    # one compiled apply serves regress and the probes (eager Flax is slow)
    apply = jax.jit(FlaxUNet(**SMALL).apply, static_argnames=("train",))
    jstate = jt.TrainState.create(apply_fn=apply, params=params,
                                  batch_stats=stats, ema_params=None, tx=optax.adamw(3e-5))
    tstate = tt.create_state(0, (H, H), tt.TrainConfig(), model=UNet2D(**SMALL), device="cpu")
    tstate.model.load_state_dict(unet_params_from_flax(jax.tree.map(np.asarray, params),
                                                       jax.tree.map(np.asarray, stats)))
    js = jd.DDPMSchedule.create(1000)
    ts = td.DDPMSchedule(betas=torch.tensor(np.asarray(js.betas)),
                         alphas_cumprod=torch.tensor(np.asarray(js.alphas_cumprod)))
    rng = np.random.default_rng(3)
    src = np.zeros((B, H, H), np.float32)
    src[np.arange(B), rng.integers(8, 24, B), rng.integers(8, 24, B)] = 1.0
    hold = {"eps": np.where(rng.random((B, H, H)) < 0.3, 4.0, 1.0).astype(np.float32)
            * np.float32(8.854e-12),
            "mu": np.full((B, H, H), 1.2566e-6, np.float32), "src": src,
            "omega": np.linspace(1.5e10, 2.5e10, B).astype(np.float32),
            "Ez": (0.03 * rng.standard_normal((B, H, H))).astype(np.float32)}
    scales = {"eps": 2.0e-11, "mu": 1.2566e-6, "Ez": 0.03, "omega": 1e10}
    jscales = {k: jnp.asarray(v, jnp.float32) for k, v in scales.items()}
    tscales = {k: torch.tensor(v, dtype=torch.float32) for k, v in scales.items()}
    return jstate, tstate, js, ts, hold, jscales, tscales


def _jax_chain_draws(key, shape, n_steps, stochastic):
    """The initial field and per-step noises jd.sample draws from ``key``
    (tests/test_torch_diffusion.py's helper), as tensors."""
    key, k0 = jax.random.split(key)
    x = torch.tensor(np.asarray(jax.random.normal(k0, shape, jnp.float32)))
    noises = []
    for _ in range(n_steps):
        key, k = jax.random.split(key)
        noises.append(torch.tensor(np.asarray(jax.random.normal(k, shape, jnp.float32))))
    return x, (noises if stochastic else None)


def _jax_readout(name, jstate, js, hold, jscales):
    """The JAX readout of examples/surrogate_report.py for 4 scenes (one
    chunk) and the port readout's draws for the same keys."""
    args = [jnp.asarray(hold[k]) for k in ("eps", "mu", "src", "omega")]
    shape = hold["Ez"].shape
    if name in ("stochastic", "deterministic"):
        _, k = jax.random.split(jax.random.PRNGKey(123))
        stochastic = name == "stochastic"
        out = jt.inference(jstate, js, k, *args, scales=jscales, stochastic=stochastic,
                           prediction_type="x0")
        return out, dict(draws=[_jax_chain_draws(k, shape, 50, stochastic)])
    if name == "regress":
        _, k = jax.random.split(jax.random.PRNGKey(7))
        out = jt.regress(jstate, js, k, *args, scales=jscales)
        # float32 as regress draws it (the tests run JAX with x64 on)
        x = jax.random.normal(k, shape, jnp.float32)
        return out, dict(xs=[torch.tensor(np.asarray(x))])
    key, draws = jax.random.PRNGKey(1000), []
    out = jt.ensemble_inference(jstate, js, key, *args, n_members=2, scales=jscales,
                                prediction_type="x0", chunk=8)
    for _ in range(2):
        key, k = jax.random.split(key)
        draws.append([_jax_chain_draws(k, shape, 50, True)])
    return out, dict(draws=draws)


@pytest.mark.parametrize("name", ["stochastic", "deterministic", "regress", "ensemble"])
def test_readout_matches_jax(shared, name):
    """Each readout of the report from the same weights and JAX's draws:
    the field within 1e-4 of JAX's (relative to its largest entry), and its
    fitted rel-L2 and correlation within 1e-4."""
    jstate, tstate, js, ts, hold, jscales, tscales = shared
    want, draws = _jax_readout(name, jstate, js, hold, jscales)
    want = np.asarray(want)
    if name == "regress":
        got = sr.regress_readout(tstate, ts, hold, tscales, **draws)
    elif name == "ensemble":
        got = sr.ensemble_readout(tstate, ts, hold, tscales, n_members=2,
                                  prediction_type="x0", **draws)
    else:
        got = sr.chain_readout(tstate, ts, hold, tscales, stochastic=name == "stochastic",
                               prediction_type="x0", **draws)
    assert got.shape == want.shape == hold["Ez"].shape
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4
    for g, w in zip(sr.holdout_metrics(got, hold["Ez"])[1:],
                    _jax_metrics(want, hold["Ez"])[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


# -- the report end to end on the CPU -----------------------------------------


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A port dataset (16 scenes at 16^2, PML 4, in two shards) and, a recipe each,
    one epoch of the port's ``train`` on it: a tiny UNet, holdout 8, the
    holdout curve and (x0) the loss log where the CLI's convention finds
    them. Returns (root, {recipe: (ckpt, eval dir)})."""
    root = tmp_path_factory.mktemp("surrogate")
    data = str(root / "data")
    tdg.generate_dataset_shards(0, 16, (16, 16), data, shard_size=8, batch=8,
                                pml_thickness=4, verbose=False, device="cpu")
    raw = tdg.load_dataset(data)
    runs = {}
    for pred_type in ("x0", "regression"):
        run = root / pred_type
        ckpt, evald = run / "ckpt", run / f"eval_{pred_type}"
        evald.mkdir(parents=True)
        cfg = tt.TrainConfig(num_epochs=1, batch_size=8, ckpt_dir=str(ckpt),
                             prediction_type=pred_type, t_sampling="uniform",
                             loss_weighting="uniform")
        state = tt.create_state(0, (16, 16), cfg, model=UNet2D(**TINY), device="cpu")
        lines = []

        def holdout_callback(epoch, rel, evald=evald):
            with open(evald / "holdout_metrics.csv", "a") as fh:
                fh.write(f"{epoch},{np.mean(rel):.6f},{np.median(rel):.6f},"
                         f"{np.min(rel):.6f}\n")

        tt.train(0, {k: raw[k] for k in sr.KEYS}, cfg, state=state, eval_every=1, holdout=8,
                 holdout_callback=holdout_callback, device="cpu",
                 callback=lambda e, loss, s: lines.append(f"epoch {e}: loss {loss:.6f}\n"))
        if pred_type == "x0":
            (run / "train100_x0.log").write_text("".join(lines))
        runs[pred_type] = (str(ckpt), str(evald))
    return root, runs


@pytest.mark.parametrize("pred_type", ["x0", "regression"])
def test_report_main_end_to_end(tiny_run, pred_type, capsys):
    """``main`` on one epoch's checkpoint: the JAX asset's keys for x0, the
    reduced set for regression, finite values, the panels and (x0, whose
    eval dir ends with "_x0") the training curves drawn."""
    root, runs = tiny_run
    ckpt, evald = runs[pred_type]
    out = root / pred_type / "out"
    head = sr.main(str(root / "data"), ckpt, evald, str(out), holdout=8, pred_type=pred_type,
                   device="cpu", model=UNet2D(**TINY))
    rep = np.load(out / "holdout_report.npz")
    if pred_type == "x0":
        assert sorted(rep.files) == sorted(np.load(BANKED).files)
    else:
        assert sorted(rep.files) == sorted(["rel", "rel_fit", "corr", "rel_d", "rel_fit_d",
                                            "corr_d", "rel_fit_e", "corr_e"])
    for k in rep.files:
        assert rep[k].shape == (8,) and np.all(np.isfinite(rep[k])), k
    for tag in sr.TAGS:
        assert (out / f"holdout_{tag}.png").stat().st_size > 0
    assert (out / "training_curves.png").exists() == (pred_type == "x0")
    plots = np.load(out / "holdout_plots.npz")
    assert plots["eval_epochs"].tolist() == [0] and plots["pred_best"].shape == (16, 16)
    assert head["epoch"] == 0 and head["ensemble"]["members"] == (8 if pred_type == "x0" else 1)
    assert head["ensemble"]["corr_mean"] == pytest.approx(float(np.mean(rep["corr_e"])))
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"epoch": 0')


def test_load_scenes_reads_head_and_tail(tiny_run):
    """Across shards, the first and last scenes as ``load_dataset`` has them."""
    data = str(tiny_run[0] / "data")
    full = tdg.load_dataset(data)
    got = sr.load_scenes(data, head=3, tail=10)
    for k in sr.KEYS:
        want = np.concatenate([np.asarray(full[k])[:3], np.asarray(full[k])[-10:]])
        np.testing.assert_array_equal(got[k], want.reshape(got[k].shape))
    with pytest.raises(ValueError):
        sr.load_scenes(data, tail=17)


def test_load_scenes_decodes_a_single_file_once(tiny_run, tmp_path, monkeypatch):
    """A single npz that holds both the head and the tail is decoded once,
    and gives the same scenes as the shards it was joined from."""
    data = str(tiny_run[0] / "data")
    full = tdg.load_dataset(data)
    one = str(tmp_path / "one.npz")
    tdg.save_dataset(one, {k: np.asarray(full[k]) for k in full}, compact=False)
    calls = []
    real = sr.load_dataset
    monkeypatch.setattr(sr, "load_dataset", lambda f: calls.append(f) or real(f))
    got = sr.load_scenes(one, head=3, tail=10)
    assert calls == [one]
    want = sr.load_scenes(data, head=3, tail=10)
    for k in sr.KEYS:
        np.testing.assert_array_equal(got[k], want[k])


def test_cuda_without_a_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        sr.device_of("cuda")
    assert sr.device_of("cpu") == torch.device("cpu")


# -- the diagnose probes -------------------------------------------------------


def _jax_probe(jstate, js, batch, t, noise, prediction_type):
    """examples/surrogate_diagnose.py's ``probe`` with the noise given; for
    an x0 model the output is x0_hat and eps_hat is solved from x_t."""
    x0 = batch["Ez"]
    Bn = x0.shape[0]
    tb = jnp.full((Bn,), t)
    ab = js.alphas_cumprod[t]
    xt = jnp.sqrt(ab) * x0 + jnp.sqrt(1 - ab) * noise
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    pred = jstate.apply_fn(variables, batch["eps"], batch["mu"], batch["src"], xt, tb,
                           batch["omega"], train=False)
    if prediction_type == "x0":
        x0_hat, eps_hat = pred, (xt - jnp.sqrt(ab) * pred) / jnp.sqrt(1 - ab)
    else:
        x0_hat, eps_hat = (xt - jnp.sqrt(1 - ab) * pred) / jnp.sqrt(ab), pred
    mse = jnp.mean((eps_hat - noise) ** 2, axis=(1, 2))

    def corr(a, b):
        a = a - a.mean()
        b = b - b.mean()
        return jnp.sum(a * b) / (jnp.linalg.norm(a) * jnp.linalg.norm(b) + 1e-30)

    c = jax.vmap(corr)(x0_hat, x0)
    pred_swap = jstate.apply_fn(variables, jnp.roll(batch["eps"], 1, 0),
                                jnp.roll(batch["mu"], 1, 0), jnp.roll(batch["src"], 1, 0),
                                xt, tb, jnp.roll(batch["omega"], 1, 0), train=False)
    sens = (jnp.linalg.norm((pred_swap - pred).reshape(Bn, -1), axis=1)
            / (jnp.linalg.norm(pred.reshape(Bn, -1), axis=1) + 1e-30))
    return mse, c, sens


@pytest.mark.parametrize("prediction_type", ["epsilon", "x0"])
def test_diagnose_probe_matches_jax(shared, prediction_type):
    """eps-MSE and scene sensitivity within 1e-4 relative, corr(x0_hat, x0)
    within 1e-4, at every probed t."""
    jstate, tstate, js, ts, hold, jscales, tscales = shared
    batch = {k: hold[k] / np.float32(jscales[k]) if k in jscales else hold[k]
             for k in sr.KEYS}
    rng = np.random.default_rng(5)
    for t in sd.TIMESTEPS:
        noise = rng.standard_normal(hold["Ez"].shape).astype(np.float32)
        want = _jax_probe(jstate, js, {k: jnp.asarray(v) for k, v in batch.items()}, t,
                          jnp.asarray(noise), prediction_type)
        got = sd.probe(tstate.model, ts, {k: torch.tensor(v) for k, v in batch.items()}, t,
                       torch.tensor(noise), prediction_type)
        (gm, gc, gs), (wm, wc, ws) = ([np.asarray(v, np.float64) for v in r]
                                      for r in (got, want))
        np.testing.assert_allclose(gm, wm, rtol=1e-4, err_msg=f"t={t}")
        np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-4, err_msg=f"t={t}")
        np.testing.assert_allclose(gs, ws, rtol=1e-4, err_msg=f"t={t}")


def test_diagnose_main_runs(tiny_run, capsys):
    """``main`` on the x0 checkpoint: finite per-t means on the training and
    holdout sets, and a full-chain correlation a scene of each."""
    root, runs = tiny_run
    out = sd.main(runs["x0"][0], str(root / "data"), "x0", device="cpu",
                  model=UNet2D(**TINY))
    for part in ("train", "holdout"):
        for key in ("mse", "corr", "sens"):
            assert len(out[part][key]) == len(sd.TIMESTEPS)
            assert np.all(np.isfinite(out[part][key]))
        assert len(out[part]["chain_corr"]) == sd.N_PROBE
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("{")


# -- the scaling table ----------------------------------------------------------


def test_scaling_table_reproduces_the_banked_row():
    """STATUS.md:97's row from assets/surrogate_x0/holdout_report.npz, and
    the same rows as examples/surrogate_scaling_table.py for both banked
    JAX reports."""
    assert st.row("x", str(BANKED)) == "| x | 0.532 | 0.545 | 0.776 | 0.838 | 0.452 |"
    spec = importlib.util.spec_from_file_location(
        "jax_scaling_table", ROOT / "examples" / "surrogate_scaling_table.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    for (label, path), (_, jax_path) in zip(st.DEFAULT, ex.DEFAULT):
        assert st.row(label, str(ROOT / path)) == ex.row(label, str(ROOT / jax_path))
    assert st.row("gone", "no/such.npz").endswith("(missing: no/such.npz) |")
