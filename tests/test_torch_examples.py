"""The port's example workflows (fdtd2d_tpu_torch/apps/{ring_resonator,
tiled_vs_direct, fdtd_video, direct_large, rank_study,
inverse_design_decade}.py) against the JAX package on the same inputs, at
small sizes. The JAX scripts in examples/ fix their sizes, so the JAX side
is built here from the library calls each script makes, with the script's
arguments and the driver's scaled geometry."""

import dataclasses
import json
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtd2d_tpu import constants
from fdtd2d_tpu.apps import inverse_design as jax_invdes
from fdtd2d_tpu.core import RegionDrawer as JaxRegionDrawer
from fdtd2d_tpu.core import material_init as jax_material_init
from fdtd2d_tpu.fdfd import run_fdfd as jax_run_fdfd
from fdtd2d_tpu.fdfd.direct import DirectSolver as JaxDirectSolver
from fdtd2d_tpu.fdfd.direct import five_point_coefficients as jax_five_point
from fdtd2d_tpu.fdfd.tiled import run_fdfd_tiled as jax_run_fdfd_tiled
from fdtd2d_tpu.fdtd.simulate import FDTDConfig as JaxConfig
from fdtd2d_tpu.fdtd.simulate import simulate as jax_simulate
from fdtd2d_tpu.ops.helmholtz import make_operator as jax_make_operator
from fdtd2d_tpu_torch.apps import (_common, direct_large, fdtd_video, inverse_design_decade,
                                   rank_study, ring_resonator, tiled_vs_direct)
from fdtd2d_tpu_torch.apps import inverse_design as invdes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APPS = ("ring_resonator", "tiled_vs_direct", "fdtd_video", "direct_large", "rank_study",
        "inverse_design_decade")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


# -- ring resonator and tiled vs direct at 128^2 ------------------------------------------

RING_N = 128


def _jax_ring_scene(N):
    """examples/ring_resonator.py's drawing with its indices moved to N."""
    def s(v):
        return int(round(v * N / 512))

    drawer = JaxRegionDrawer(N, N)
    drawer.draw_waveguide((s(60), s(160)), (N - s(60), s(160)), s(10))
    drawer.draw_ring_resonator((N // 2, s(280)), s(90), s(10))
    eps = drawer.to_eps(black_point=3.0)
    source = np.zeros((N, N), np.float32)
    source[s(150):s(170), s(80)] = 10.0
    return eps, np.full((N, N), constants.MU_0), source


def test_ring_resonator_matches_jax():
    """The scene equals the JAX RegionDrawer's; the c64 FDM-FGMRES field of
    run_fdfd(rhs_scale=omega, tol=1e-5, maxiter=600) within 1e-4 of JAX's
    (tests/test_torch_fdfd_solver.py's complex64 bound), both converged."""
    eps, mu, source = _jax_ring_scene(RING_N)
    ours = ring_resonator.run(N=RING_N, device="cpu")
    assert np.array_equal(ours["arrays"]["eps"], eps)
    jres = jax_run_fdfd(eps, mu, 1e-3, 1e-3, 17e9, source, rhs_scale=17e9, tol=1e-5,
                        maxiter=600)
    assert ours["converged"] and ours["relative_residual"] < 1e-4
    assert float(jres.relative_residual) < 1e-4
    assert _rel(ours["arrays"]["x"], jres.x) < 1e-4
    assert ours["max_abs_Ez"] == pytest.approx(float(np.abs(np.real(jres.x)).max()), rel=1e-4)


TILED = dict(N=128, patch_size=48, padding=16)


def test_tiled_vs_direct_matches_jax():
    """run_fdfd (tol 1e-6, maxiter 600) within 1e-4 of JAX's; the krylov
    tiled solve (solver_maxiter 240, refine_target 1e-8) within 1e-5
    (tests/test_torch_tiled.py's bound), both iterates below 1e-8, the
    downcast's residual and the field error as JAX's arithmetic gives them."""
    N = TILED["N"]
    eps = np.full((N, N), constants.EPSILON_0)
    eps[int(round(180 * N / 512)):int(round(330 * N / 512)),
        int(round(140 * N / 512)):int(round(240 * N / 512))] *= 2.5
    mu = np.full((N, N), constants.MU_0)
    source = np.zeros((N, N), np.float32)
    source[N // 2, N // 2] = 10.0
    ours = tiled_vs_direct.run(device="cpu", **TILED)
    jdirect = jax_run_fdfd(eps, mu, 1e-3, 1e-3, 17e9, source, tol=1e-6, maxiter=600)
    jtiled, jtrace = jax_run_fdfd_tiled(eps, mu, 1e-3, 1e-3, 17e9, source,
                                        patch_size=TILED["patch_size"],
                                        padding=TILED["padding"], mode="krylov",
                                        solver_maxiter=240, refine_target=1e-8)
    assert _rel(ours["arrays"]["direct"], jdirect.x) < 1e-4
    assert _rel(ours["arrays"]["tiled"], jtiled) <= 1e-5
    assert ours["tiled_iterate_residual"] < 1e-8 and jtrace[-2] < 1e-8
    assert ours["tiled_returned_residual"] < 5e-5 and jtrace[-1] < 5e-5
    a, b = np.real(np.asarray(jdirect.x)), np.real(np.asarray(jtiled))
    jerr = np.abs(a - b).max() / np.abs(a).max()
    assert ours["field_error"] < 1e-4 and jerr < 1e-4
    assert ours["field_error"] == pytest.approx(jerr, rel=0.5, abs=1e-6)


# -- the FDTD video at 64^2 ---------------------------------------------------------------

def test_fdtd_video_matches_jax():
    """64^2, 100 steps in 20 frames: the box scene equals JAX's and every
    snapshot is within 1e-5 of JAX's simulate (the oracle bound)."""
    N = 64
    drawer = JaxRegionDrawer(N, N)
    s = [int(round(v * N / 200)) for v in (50, 100, 8)]
    drawer.draw_box((s[0], s[0]), s[1], s[2])
    eps = drawer.to_eps(black_point=10.0)
    _, mu = jax_material_init(None, N, N)
    ours_eps, ours_mu = fdtd_video.box_scene(N)
    assert np.array_equal(ours_eps, eps) and np.array_equal(ours_mu, mu)
    ours = fdtd_video.run(N=N, nsteps=100, nframes=20, device="cpu")
    _, jsnaps = jax_simulate(eps, mu, JaxConfig(dt=5e-14, dx=1e-4, nsteps=100,
                                                source_xy=(N // 2, N // 2), source_fc=30e9,
                                                nframes=20))
    assert ours["arrays"]["frames"].shape == np.asarray(jsnaps).shape == (20, N, N)
    assert _rel(ours["arrays"]["frames"], jsnaps) <= 1e-5
    assert ours["backend"] == "torch" and ours["k1_resident_launches"] == 0
    assert ours["courant"] == pytest.approx(0.1498962951739177, rel=1e-12)


# -- direct_large at 64^2 -----------------------------------------------------------------

DIRECT_MODES = [("checkpointed", dict(checkpointed=True, stride=8)),
                ("compressed", dict(compressed=True)), ("hps", dict(hps=True))]


def _script_sources(src, N):
    """examples/direct_large.py's sweep draw, as the script writes it."""
    B = 8
    rng = np.random.default_rng(11)
    srcs = np.zeros((B, N, N), np.complex64)
    srcs[0] = src
    for i in range(1, B):
        r, c = rng.integers(N // 4, 3 * N // 4, 2)
        srcs[i, r, c] = 10.0
    return srcs


@pytest.mark.parametrize("mode,kwargs", DIRECT_MODES, ids=[m for m, _ in DIRECT_MODES])
def test_direct_large_matches_jax(mode, kwargs):
    """Each mode at 64^2 (stride 8) on the script's hard scene (seed 7, the
    source at N/3): the refinement rounds of both solves and of the 8-source
    sweep equal JAX's DirectSolver's, every true residual <= 1e-8, the warm
    field within 1e-5 of JAX's (the complex64 downcast), and the sweep's
    sources equal to the script's draw."""
    N = 64
    ours = direct_large.run(N=N, stride=8, mode=mode, device="cpu")
    eps, mu, src = direct_large.hard_scene(N)
    solver = JaxDirectSolver(eps, mu, 1e-3, 1e-3, 17e9, **kwargs)
    _, jtrace_first = solver.solve(src, refine_target=1e-8)
    jx, jtrace = solver.solve(src, refine_target=1e-8)
    srcs = _script_sources(src, N)
    assert np.array_equal(ours["arrays"]["sources"], srcs)
    _, jper, jbtrace = solver.solve_batched(srcs, refine_target=1e-8)
    assert ours["rounds_first"] == len(jtrace_first) - 2
    assert ours["rounds"] == len(jtrace) - 2
    assert ours["sweep_rounds"] == len(jbtrace) - 1
    assert ours["iterate_residual"] <= 1e-8 and jtrace[-2] <= 1e-8
    assert ours["sweep_worst_residual"] <= 1e-8 and float(np.max(jper)) <= 1e-8
    assert np.all(ours["arrays"]["per_sample"] <= 1e-8)
    assert _rel(ours["arrays"]["x"], jx) <= 1e-5


def test_direct_large_cli_and_draw(tmp_path):
    """The script's positionals N stride mode, the JSON file and last line,
    the npz and its PNG; an unknown mode is refused."""
    out = str(tmp_path)
    argv = ["64", "8", "checkpointed", "--device", "cpu", "--out", out]
    assert direct_large.main(argv) == 0
    numbers = json.load(open(os.path.join(out, "direct_large_checkpointed_64.json")))
    assert numbers["N"] == 64 and numbers["stride"] == 8 and numbers["iterate_residual"] <= 1e-8
    assert os.path.exists(os.path.join(out, "direct_large_checkpointed_64_Ez.png"))
    with pytest.raises(SystemExit):
        direct_large.main(["64", "8", "lu", "--device", "cpu"])


# -- rank study at 64^2 -------------------------------------------------------------------

def _script_ranks(N):
    """examples/rank_study.py's loop, as the script writes it, on JAX's
    five_point_coefficients at N."""
    from fdtd2d_tpu.core.scenes import hard_binary_scene

    eps, mu, _ = hard_binary_scene(N, seed=7)
    op = jax_make_operator(eps, mu, 1e-3, 1e-3, 17e9, pml_thickness=40, dtype=jnp.complex128)
    d, e, w, s, n = (np.asarray(a) for a in jax_five_point(op))

    def sub(a):
        return a[0::2, 0::2]

    ds, es, ws, ns, ss = sub(d), sub(e), sub(w), sub(n), sub(s)
    nr, nc = ds.shape

    def tridiag(dr, er, wr):
        return np.diag(dr) + np.diag(er[:-1], 1) + np.diag(wr[1:], -1)

    def block_ranks(W, tols=(1e-2, 1e-3, 1e-4)):
        out = {}
        gs = np.linalg.norm(W, 2)
        for lev in (1, 2, 3):
            nb = nc >> lev
            ranks_rel, ranks_glob = {t: [] for t in tols}, {t: [] for t in tols}
            for bi in range(1 << lev):
                for bj in range(1 << lev):
                    if abs(bi - bj) != 1:
                        continue
                    B = W[bi * nb:(bi + 1) * nb, bj * nb:(bj + 1) * nb]
                    sv = np.linalg.svd(B, compute_uv=False)
                    for t in tols:
                        ranks_rel[t].append(int(np.sum(sv > t * sv[0])))
                        ranks_glob[t].append(int(np.sum(sv > t * gs)))
            out[lev] = {t: (max(ranks_rel[t]), max(ranks_glob[t])) for t in tols}
        return out

    W = np.linalg.inv(tridiag(ds[0], es[0], ws[0]))
    sample_at = {1, 2, 4, 8, 16, 32, 64, 128, 256, 511}
    samples = {}
    for r in range(1, nr):
        A = tridiag(ds[r], es[r], ws[r])
        U = A - ns[r][:, None] * W * ss[r - 1][None, :]
        W = np.linalg.inv(U)
        if r in sample_at:
            samples[r] = (np.abs(W).max(), block_ranks(W))
    errors = {}
    for k in (8, 16, 32, 64):
        u, sv, vt = np.linalg.svd(W)
        Wk = (u[:, :k] * sv[:k]) @ vt[:k]
        errors[k] = np.linalg.norm(W - Wk) / np.linalg.norm(W)
    return samples, errors


def test_rank_study_matches_the_script():
    """64^2 in complex128: at every sampled row, every HODLR level-1..3 rank
    at every tolerance (relative and global) equals the script's numpy loop
    on JAX's coefficients; |W|max and the global rank-k errors agree."""
    N = 64
    samples, errors = _script_ranks(N)
    ours = rank_study.run(N=N, device="cpu")
    assert (ours["nr"], ours["nc"]) == (32, 32)
    assert sorted(int(r) for r in ours["samples"]) == sorted(samples) == [1, 2, 4, 8, 16]
    for r, (w_max, ranks) in samples.items():
        got = ours["samples"][str(r)]
        assert got["w_max"] == pytest.approx(w_max, rel=1e-10)
        for lev, tolmap in ranks.items():
            for t, pair in tolmap.items():
                assert tuple(got["ranks"][str(lev)][f"{t:g}"]) == pair, (r, lev, t)
    for k, err in errors.items():
        assert ours["global_rank_errors"][str(k)] == pytest.approx(err, rel=1e-8, abs=1e-12)


# -- the decade driver on a small low-pass problem ----------------------------------------

def _carried(jp):
    return invdes.problem_from_numpy(**{f.name: getattr(jp, f.name)
                                        for f in dataclasses.fields(jp)})


def test_inverse_design_decade_matches_jax():
    """tests/test_torch_inverse_design.py's 96^2 problem (5 frequencies,
    8-16 GHz) for 3 steps in complex128: the history, the continuous and the
    binarized responses within test_optimize_matches_jax's 1e-6 of JAX's
    optimize / binarize / make_response_fn, as the script calls them."""
    jp = jax_invdes.lowpass_problem(N=96, n_freqs=5, band=(8e9, 16e9))
    jdesign, jresp, jhist = jax_invdes.optimize(jp, steps=3, lr=0.05, log_every=1,
                                                opt_tol=1e-4, dtype=jnp.complex128)
    jb = jax_invdes.binarize(jdesign)
    jrb = jax_invdes.make_response_fn(jp, dtype=jnp.complex128)[0](jnp.asarray(jb))
    ours = inverse_design_decade.run(_carried(jp), steps=3, dtype=torch.complex128,
                                     design0=np.full(np.asarray(jdesign).shape, 2.0),
                                     device="cpu")
    assert ours["steps_done"] == 3 and not ours["stopped_early"]
    assert np.max(np.abs(np.asarray(ours["history"]) - np.asarray(jhist))) <= 1e-6
    assert np.max(np.abs(ours["arrays"]["design"] - np.asarray(jdesign))) <= 1e-6
    assert _rel(ours["arrays"]["responses"], jresp) <= 1e-6
    assert np.array_equal(ours["arrays"]["design_binary"], np.asarray(jb))
    assert _rel(ours["arrays"]["responses_binary"], jrb) <= 1e-6
    assert len(ours["loop_members_at_maxiter"]) == 3
    assert ours["binary_members_at_maxiter"] == 0 and ours["continuous_members_at_maxiter"] == 0


def test_inverse_design_decade_stops_and_still_evaluates(tmp_path):
    """A set stop event ends the loop after the step in flight; the design
    it reached is evaluated, binarized and saved, and drawn from the npz."""
    stop = threading.Event()
    stop.set()
    problem = invdes.lowpass_problem(N=50, n_freqs=2, device="cpu")
    out = str(tmp_path)
    ours = inverse_design_decade.run(problem, steps=5, stop=stop, device="cpu", out=out)
    assert ours["steps_done"] == 1 and ours["stopped_early"]
    assert len(ours["response"]) == len(ours["response_binary"]) == 2
    assert np.load(os.path.join(out, "design_decade.npy")).shape == (20, 20)
    paths = inverse_design_decade.draw(out)
    assert [os.path.basename(p) for p in paths] == [
        "frequency_response_decade.png", "frequency_response_decade_binary.png",
        "design_decade.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)


# -- the files, the drawings, the device ---------------------------------------------------

@pytest.mark.parametrize("name,kwargs,files", [
    ("ring_resonator", dict(N=64), ["ring_resonator_Ez.png"]),
    ("tiled_vs_direct", dict(N=128, patch_size=48, padding=16), ["tiled_vs_direct.png"]),
    ("fdtd_video", dict(N=32, nsteps=40, nframes=8), ["animation.gif", "fdtd_frames.png"]),
    ("rank_study", dict(N=64), ["rank_study.png"]),
], ids=lambda v: v if isinstance(v, str) else "")
def test_npz_and_draw(tmp_path, name, kwargs, files):
    """Each driver saves its figure's data as npz under ``out``; ``--draw``
    draws the PNGs (and the video's GIF without ffmpeg) from it alone."""
    module = sys.modules[f"fdtd2d_tpu_torch.apps.{name}"]
    out = str(tmp_path)
    module.run(device="cpu", out=out, **kwargs)
    assert any(f.endswith(".npz") for f in os.listdir(out))
    assert module.main(["--draw", out]) == 0
    for f in files:
        if f == "animation.gif" and fdtd_video.shutil.which("ffmpeg"):
            f = "animation.mp4"
        assert os.path.getsize(os.path.join(out, f)) > 0, f


def test_jax_witness_matches_the_port_at_64():
    """tools/examples_jax_witness.py's HPS readings at 64^2 (the JAX
    package's DirectSolver on the CPU) beside the port's direct_large in
    HPS mode: the same refinement rounds for the source's solve and the
    8-source sweep, both at a true 1e-8, and raw residuals of the complex64
    factors below 1e-4 on both sides."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "examples_jax_witness", os.path.join(REPO, "tools", "examples_jax_witness.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    jax_side = tool.hps(64)["hps_64"]
    ours = direct_large.run(N=64, mode="hps", device="cpu")
    assert len(jax_side["raw_residuals"]) == 8 and max(jax_side["raw_residuals"]) < 1e-4
    assert ours["trace"][1] < 1e-4
    assert ours["rounds"] == jax_side["solve_rounds"]
    assert ours["sweep_rounds"] == jax_side["sweep_rounds"]
    assert ours["sweep_worst_residual"] <= 1e-8 and jax_side["sweep_trace"][-1] <= 1e-8


def test_cuda_without_a_card_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        _common.device_of("cuda")
    with pytest.raises(SystemExit, match="no CUDA device"):
        rank_study.main(["--out", "unused"])
    assert _common.device_of("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", APPS)
def test_run_defaults_are_the_scripts_sizes_on_the_card(name):
    """Each run() takes the JAX script's size as its default and runs on
    cuda unless asked for the CPU."""
    import inspect

    want = {"ring_resonator": dict(N=512), "tiled_vs_direct": dict(N=512),
            "fdtd_video": dict(N=200), "direct_large": dict(N=2048), "rank_study": dict(N=1024),
            "inverse_design_decade": dict(steps=100)}[name]
    params = inspect.signature(sys.modules[f"fdtd2d_tpu_torch.apps.{name}"].run).parameters
    assert {k: params[k].default for k in want} == want
    assert params["device"].default == "cuda"


def test_apps_import_neither_jax_nor_the_jax_package():
    """Each new module imports with jax and fdtd2d_tpu blocked, in a fresh
    interpreter, and names neither in an import statement."""
    block = ("import sys\n"
             "for n in ('jax', 'jaxlib', 'fdtd2d_tpu'): sys.modules[n] = None\n"
             + "".join(f"import fdtd2d_tpu_torch.apps.{n}\n" for n in ("_common",) + APPS)
             + "import fdtd2d_tpu_torch.apps.rank_study as m\n"
               "assert not [k for k in sys.modules if k.split('.')[0] in ('jax', 'fdtd2d_tpu')"
               " and sys.modules[k] is not None]\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    subprocess.run([sys.executable, "-c", block], check=True, cwd=REPO, env=env)
    for n in ("_common",) + APPS:
        text = open(os.path.join(REPO, "fdtd2d_tpu_torch", "apps", f"{n}.py")).read()
        lines = [ln.strip() for ln in text.splitlines()
                 if ln.strip().startswith(("import ", "from "))]
        assert not [ln for ln in lines if ln.split()[1].split(".")[0] in ("jax", "fdtd2d_tpu")]
