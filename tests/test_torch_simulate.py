"""The slice end to end: the port's rollout against the JAX package's
(the Pallas kernel in interpret mode, the pure-JAX step) and the NumPy oracle."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fdtd2d_tpu import constants
from fdtd2d_tpu.fdtd.reference import numpy_simulate
from fdtd2d_tpu.fdtd.simulate import FDTDConfig as JaxConfig
from fdtd2d_tpu.fdtd.simulate import simulate as jax_simulate
from fdtd2d_tpu_torch.core.grid import state_from_numpy
from fdtd2d_tpu_torch.fdtd.simulate import FDTDConfig, resolve_backend, simulate

DT, DX, FC = 5e-14, 1e-4, 30e9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(ours, ref):
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(ours.double().numpy() - ref)) / np.max(np.abs(ref))


def _scene(rows, cols):
    eps = np.full((rows, cols), constants.EPSILON_0)
    eps[rows // 3 : rows // 2, cols // 2 : 2 * cols // 3] *= 3.0
    return eps, np.full((rows, cols), constants.MU_0)


@pytest.mark.parametrize("nsteps,nframes,backend,jax_backend,shape", [
    pytest.param(30, 3, "auto", "pallas", (48, 64), id="30-3"),
    pytest.param(31, 4, "auto", "pallas", (48, 64), id="31-4"),
    pytest.param(21, 4, "ttiled", "ttiled", (64, 128), id="ttiled-21-4"),
])
def test_simulate_auto_matches_jax_pallas(nsteps, nframes, backend, jax_backend, shape):
    """auto on a CPU tensor vs the JAX pallas backend (interpreted on CPU);
    31 steps in 4 frames leaves a remainder after the last frame. The ttiled
    case runs the port's tile emulation against the JAX ttiled kernel
    (interpreted) at the size of tests/test_fdtd_ttiled.py, 5-step frames
    plus a 1-step remainder."""
    rows, cols = shape
    eps, mu = _scene(rows, cols)
    kw = dict(dt=DT, dx=DX, nsteps=nsteps, source_xy=(rows // 2, cols // 2),
              source_fc=FC, nframes=nframes)
    (jE, jHx, jHy), jsnaps = jax_simulate(eps, mu, JaxConfig(backend=jax_backend, **kw))
    (Ez, Hx, Hy), snaps = simulate(eps, mu, FDTDConfig(backend=backend, device="cpu", **kw))
    assert snaps.shape == jsnaps.shape
    for ours, ref in ((Ez, jE), (Hx, jHx), (Hy, jHy), (snaps, jsnaps)):
        assert tuple(ours.shape) == ref.shape and ours.dtype == torch.float32
        assert _rel(ours, ref) < 1e-5


def test_rollout_fidelity_vs_oracle():
    """200-step point-source rollout: <=1e-5 relative field error (f32)."""
    rows = cols = 96
    eps = np.full((rows, cols), constants.EPSILON_0)
    eps[30:60, 30:40] *= 4.0
    mu = np.full((rows, cols), constants.MU_0)
    ref = numpy_simulate(eps, mu, DT, DX, 200, (rows // 2, cols // 2), FC)
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=200, source_xy=(rows // 2, cols // 2),
                     source_fc=FC, device="cpu")
    (Ez, _, _), snaps = simulate(eps, mu, cfg)
    assert snaps is None
    assert _rel(Ez, ref) < 1e-5


@pytest.mark.parametrize("padded", [False, True])
def test_state_handover_from_jax(padded):
    """A JAX state taken mid-rollout continues identically in both packages."""
    rows, cols = 40, 52
    eps, mu = _scene(rows, cols)
    kw = dict(dt=DT, dx=DX, source_xy=(11, 30), source_fc=FC,
              source_kind="sinusoidal", padded=padded)
    mid, _ = jax_simulate(eps, mu, JaxConfig(nsteps=25, backend="jax", **kw))
    ref, _ = jax_simulate(eps, mu, JaxConfig(nsteps=40, backend="jax", **kw), state=mid)
    state = state_from_numpy([np.asarray(a) for a in mid])
    before = [t.clone() for t in state]
    ours, _ = simulate(eps, mu, FDTDConfig(nsteps=40, backend="torch", device="cpu", **kw),
                       state=state)
    for t, b in zip(state, before):
        assert torch.equal(t, b)  # simulate never mutates the caller's state
    for o, r in zip(ours, ref):
        assert tuple(o.shape) == r.shape
        assert _rel(o, r) < 1e-5


def test_resolve_backend():
    assert resolve_backend("auto", (64, 64), "cpu") == "torch"
    assert resolve_backend("auto", (4096, 4096), "cpu", 5) == "torch"
    assert resolve_backend("fused", (64, 64), "cpu") == "fused"
    assert resolve_backend("ttiled", (64, 64), "cpu") == "ttiled"
    with pytest.raises(ValueError, match="no kernel"):
        resolve_backend("auto", (12, 64), "cuda")
    with pytest.raises(ValueError, match="no kernel"):
        resolve_backend("auto", (12, 500000), "cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("pallas", (64, 64), "cpu")


# The measured rule on the card (PERF.md section 6): K1 where its resident
# mode holds the grid in an H100's SMs (squares up to 1034^2); past that K2,
# but K1's streaming mode for calls of fewer than 8 steps on grids up to
# 2304^2 and for grids K2's planner refuses.
@pytest.mark.parametrize("shape,steps_per_call,want", [
    ((16, 16), None, "fused"), ((128, 128), 5, "fused"), ((200, 200), 5, "fused"),
    ((512, 512), 200, "fused"), ((1024, 1024), 8, "fused"),
    ((1034, 1034), None, "fused"), ((1034, 1034), 5, "fused"),   # the resident limit
    ((1035, 1035), None, "ttiled"), ((1034, 1035), 200, "ttiled"),
    ((1035, 1035), 7, "fused"), ((1035, 1035), 8, "ttiled"),     # short calls: streaming
    ((1536, 1536), 5, "fused"), ((1536, 1536), 200, "ttiled"),
    ((2048, 2048), None, "ttiled"), ((2048, 2048), 5, "fused"), ((2048, 2048), 8, "ttiled"),
    ((2304, 2304), 7, "fused"), ((2304, 2304), 200, "ttiled"),
    ((2305, 2304), 5, "ttiled"), ((4096, 4096), 5, "ttiled"),    # past 2304^2: K2 always
    ((4096, 4096), None, "ttiled"), ((8192, 8192), 200, "ttiled"),
    ((16, 300000), None, "ttiled"), ((3001, 4999), 1, "ttiled"),
])
def test_resolve_backend_auto_on_the_card(shape, steps_per_call, want):
    got = resolve_backend("auto", shape, "cuda", steps_per_call)
    assert got == want and got != "torch"  # never the plain path for float32 on the card
    assert resolve_backend("auto", shape, "cuda:1", steps_per_call) == want
    assert resolve_backend("auto", shape, "cuda", steps_per_call, torch.float32) == want


@pytest.mark.parametrize("shape,steps_per_call", [
    ((200, 200), 5), ((1034, 1034), None), ((2048, 2048), 200), ((8192, 8192), None),
    ((12, 64), None),  # too small for a kernel: float32 raises, float64 does not
])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_resolve_backend_auto_other_dtypes_take_the_plain_step(shape, steps_per_call, dtype):
    """The kernels take float32 only, so 'auto' names the plain step for any
    other dtype on the card (the JAX package runs any dtype through 'auto');
    a backend named outright is returned as it is, and its wrapper raises."""
    assert resolve_backend("auto", shape, "cuda", steps_per_call, dtype) == "torch"
    assert resolve_backend("auto", shape, "cpu", steps_per_call, dtype) == "torch"
    assert resolve_backend("ttiled", shape, "cuda", steps_per_call, dtype) == "ttiled"


@pytest.mark.parametrize("padded", [False, True])
def test_simulate_fused_keeps_the_padded_state_across_frames(padded):
    """The fused backend pads the state and ch once and keeps them padded
    across the frames; on the CPU it runs K1's plain version, so the rollout
    equals the torch backend's bit for bit, frames, remainder and shapes."""
    rows, cols = 40, 52
    eps, mu = _scene(rows, cols)
    kw = dict(dt=DT, dx=DX, nsteps=31, source_xy=(11, 30), source_fc=FC, nframes=4,
              padded=padded, device="cpu")
    want, want_snaps = simulate(eps, mu, FDTDConfig(backend="torch", **kw))
    got, got_snaps = simulate(eps, mu, FDTDConfig(backend="fused", **kw))
    assert torch.equal(got_snaps, want_snaps)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    again, _ = simulate(eps, mu, FDTDConfig(backend="fused", **kw), state=got)
    assert all(a.shape == g.shape for a, g in zip(again, got))


def test_resolve_backend_leaves_no_cycle_holding_its_caller():
    """'auto' asks K1's resident planner, which refuses large grids with a
    ValueError. The refusal must not leave a reference cycle through its
    traceback: that cycle reaches the frames of every caller, so a rollout's
    tensors (gigabytes at 8192^2) stayed allocated after ``simulate``
    returned, until the cyclic collector ran."""
    import gc
    import weakref

    from fdtd2d_tpu_torch.ops import fdtd_fused

    class Held:
        pass

    def caller():
        held = Held()  # stands for simulate's tensors
        assert resolve_backend("auto", (2048, 2048), "cuda", 200) == "ttiled"
        return weakref.ref(held)

    fdtd_fused.plan_resident.cache_clear()
    gc.collect()
    gc.disable()
    try:
        ref = caller()
        assert ref() is None
    finally:
        gc.enable()


def test_float64_plain_path_matches_oracle_tightly():
    rows, cols = 32, 40
    eps, mu = _scene(rows, cols)
    ref = numpy_simulate(eps, mu, DT, DX, 50, (9, 21), FC)
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=50, source_xy=(9, 21), source_fc=FC,
                     dtype=torch.float64, device="cpu", backend="torch")
    (Ez, _, _), _ = simulate(eps, mu, cfg)
    assert Ez.dtype == torch.float64
    assert _rel(Ez, ref) < 1e-12


def test_port_imports_no_jax():
    code = ("import sys, fdtd2d_tpu_torch, fdtd2d_tpu_torch.fdtd, fdtd2d_tpu_torch.cli, "
            "fdtd2d_tpu_torch.core, fdtd2d_tpu_torch.ops.fdtd_fused, "
            "fdtd2d_tpu_torch.ops.fdtd_ttiled, fdtd2d_tpu_torch.ops.fdtd_blocked, "
            "fdtd2d_tpu_torch.utils, fdtd2d_tpu_torch.viz, fdtd2d_tpu_torch.fdfd, "
            "fdtd2d_tpu_torch.fdfd.direct, fdtd2d_tpu_torch.fdfd.refine, "
            "fdtd2d_tpu_torch.fdfd.solver, fdtd2d_tpu_torch.ops.helmholtz, "
            "fdtd2d_tpu_torch.ops.dst, fdtd2d_tpu_torch.ops.fdm, "
            "fdtd2d_tpu_torch.ops.krylov, fdtd2d_tpu_torch.core.scenes, "
            "fdtd2d_tpu_torch.fdfd.autodiff, fdtd2d_tpu_torch.apps.inverse_design, "
            "fdtd2d_tpu_torch.ops.sparse, fdtd2d_tpu_torch.viz.plots, "
            "fdtd2d_tpu_torch.fdfd.tiled, fdtd2d_tpu_torch.fdfd.timedomain\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'fdtd2d_tpu', 'optax', 'flax'))\n"
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _batched_scenes():
    """The scenes of tests/test_fdtd_oracle.py:121-137: two 48^2 scenes, the
    second with a 3x block, sources at (24, 24) and (20, 28)."""
    eps1 = np.full((48, 48), constants.EPSILON_0)
    eps2 = eps1.copy()
    eps2[10:20, 10:20] *= 3.0
    mu = np.full((48, 48), constants.MU_0)
    return np.stack([eps1, eps2]), np.stack([mu, mu]), [(24, 24), (20, 28)]


@pytest.mark.parametrize("dtype,jdtype,bound", [(torch.float64, jnp.float64, 1e-12),
                                                (torch.float32, jnp.float32, 1e-5)])
@pytest.mark.parametrize("nframes", [0, 7])
def test_simulate_batched_matches_jax(dtype, jdtype, bound, nframes):
    """simulate_batched against JAX's on the inputs of the oracle test (60
    steps; with 7 frames of 8 steps, no remainder, as JAX's scan): Ez, Hx,
    Hy and the frames within 1e-12 in float64 and 1e-5 in float32."""
    from fdtd2d_tpu.fdtd.simulate import simulate_batched as jax_simulate_batched
    from fdtd2d_tpu_torch.fdtd import simulate_batched

    eps, mu, sources = _batched_scenes()
    kw = dict(dt=DT, dx=DX, nsteps=60, source_xy=(24, 24), source_fc=FC, nframes=nframes)
    (*want, ), wsnaps = jax_simulate_batched(eps, mu, JaxConfig(**kw, dtype=jdtype),
                                             sources_xy=sources)
    (*got, ), snaps = simulate_batched(eps, mu, FDTDConfig(**kw, dtype=dtype, device="cpu"),
                                       sources_xy=sources)
    for g, w in zip(got, want):
        assert g.dtype == dtype and tuple(g.shape) == np.shape(w)
        assert _rel(g, w) < bound
    if nframes:
        assert tuple(snaps.shape) == (2, nframes, 48, 48) and _rel(snaps, wsnaps) < bound
        assert torch.equal(snaps[:, -1], got[0])
    else:
        assert snaps is None and wsnaps is None


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_simulate_batched_equals_per_scene_simulate(dtype):
    """The batched run is each scene's simulate(backend='torch') with its
    own source, bit for bit (63 steps in 7 frames; the default source_xy
    when sources_xy is None)."""
    from fdtd2d_tpu_torch.fdtd import simulate_batched

    eps, mu, sources = _batched_scenes()
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=63, source_xy=(24, 24), source_fc=FC, nframes=7,
                     dtype=dtype, device="cpu", backend="torch")
    for srcs in (sources, None):
        (Ez, Hx, Hy), snaps = simulate_batched(eps, mu, cfg, sources_xy=srcs)
        for k in range(2):
            sxy = cfg.source_xy if srcs is None else srcs[k]
            (e, hx, hy), s = simulate(eps[k], mu[k], dataclasses.replace(cfg, source_xy=sxy))
            for a, b in ((e, Ez[k]), (hx, Hx[k]), (hy, Hy[k]), (s, snaps[k])):
                assert torch.equal(a, b)
