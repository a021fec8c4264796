"""The HPS direct adjoint of the port's inverse design
(apps/inverse_design.py ``solver="hps"``, fdfd/autodiff.py
``solve_helmholtz_hps_differentiable``) against the benchmark's plain
reference (portbench/reference/invdes.py: scipy's operator, exact
sublattice solves, the adjoint by the probe cells' unit sources), central
differences and the FGMRES path, on the upstream's low-pass scene at 32^2
and 64^2 with 3-4 frequencies and a seeded design."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from fdtd2d_tpu_torch.apps import inverse_design as invdes
from fdtd2d_tpu_torch.cli import main
from fdtd2d_tpu_torch.ops.helmholtz import stack_operators
from fdtd2d_tpu_torch.utils import trace
from portbench.reference.invdes import Reference, adjoint_sources
from portbench.scenes import lowpass


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(N, F, **kw):
    return invdes.lowpass_problem(N=N, n_freqs=F, band=(1e9, 3.5e9), dx=0.25 / N,
                                  device="cpu", **kw)


def _design(problem, seed=0):
    rs, cs = problem.design_region
    shape = (rs.stop - rs.start, cs.stop - cs.start)
    return torch.as_tensor(np.random.default_rng(seed).uniform(1.0, 3.0, shape))


def _reference(problem):
    N = problem.eps_base.shape[0]
    return Reference(lowpass.make(N), problem.omegas, problem.ideal_response.numpy(),
                     problem.dx, {"cells": problem.pml_thickness, "sigma_max": 2.0,
                                  "order": 3}, "cpu")


def _rel(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.fixture(scope="module", params=[(32, 3), (64, 4)], ids=["32x3", "64x4"])
def stepped(request):
    """(problem, reference, one design_step's result, the reference's step)."""
    N, F = request.param
    problem = _problem(N, F)
    state = invdes.design_state(problem, solver="hps", design0=_design(problem))
    before = trace.counters()
    out = invdes.design_step(state)
    counts = {n: trace.delta(before, n) for n in
              ("fdfd.adjoint.solves", "fdfd.hps.factors", "invdes.step",
               "fdfd.adjoint.forward", "fdfd.adjoint.backward")}
    ref = _reference(problem)
    return problem, ref, out, ref.step(out.design.numpy(), out.fields, out.adjoint_fields), counts


def test_stacked_operator_is_complex_symmetric():
    """w^T A u = u^T A w for every member of the stacked complex128 operator."""
    problem = _problem(32, 3)
    op = stack_operators(invdes._operators(problem, torch.complex128))
    g = torch.Generator().manual_seed(1)
    u, w = (torch.randn((3, 32, 32), dtype=torch.complex128, generator=g) for _ in range(2))
    left, right = (w * op.apply(u)).sum(dim=(1, 2)), (u * op.apply(w)).sum(dim=(1, 2))
    assert torch.allclose(left, right, rtol=1e-12, atol=0)


def test_fields_match_the_references_exact_solves(stepped):
    problem, ref, out, _, _ = stepped
    x_probe = out.fields[:, problem.probe_region[0], problem.probe_region[1]].reshape(
        out.fields.shape[0], -1)
    _, v = adjoint_sources(x_probe, problem.ideal_response.numpy())
    x, y = ref.exact(out.design.numpy(), v)
    for f in range(x.shape[0]):
        assert _rel(out.fields[f], x[f]) < 1e-6
        assert _rel(out.adjoint_fields[f], y[f]) < 1e-6
    assert out.info["forward_residual"].max() <= problem.tol
    assert out.info["adjoint_residual"].max() <= problem.tol


def test_loss_and_gradient_match_the_reference(stepped):
    _, _, out, want, _ = stepped
    assert abs(float(out.loss) - want["loss"]) <= 1e-8 * want["loss"]
    assert _rel(out.grad, want["grad"]) < 1e-6
    assert want["residual"] <= 1e-6 and want["exact_residual"] < 1e-12


def test_a_step_counts_its_factors_solves_and_spans(stepped):
    problem, _, _, _, counts = stepped
    F = len(problem.omegas)
    assert counts == {"fdfd.adjoint.solves": 2 * F, "fdfd.hps.factors": F, "invdes.step": 1,
                      "fdfd.adjoint.forward": 1, "fdfd.adjoint.backward": 1}


def test_gradient_matches_central_differences():
    """complex128 fields refined to 1e-12; h = 1e-4 at three design cells."""
    problem = _problem(32, 3, tol=1e-12)
    _, loss = invdes.make_response_fn(problem, solver="hps")
    design = _design(problem, seed=2)
    _, grad, _ = loss.value_and_grad(design)
    h = 1e-4
    for cell in [(0, 0), (5, 7), (11, 3)]:
        e = torch.zeros_like(design)
        e[cell] = h
        fd = (float(loss(design + e)) - float(loss(design - e))) / (2 * h)
        assert abs(fd - float(grad[cell])) <= 1e-5 * float(grad.abs().max()), cell


def test_hps_and_fgmres_give_the_same_loss_and_gradient():
    problem = dataclasses.replace(_problem(32, 3), tol=1e-11, maxiter=3000)
    design = _design(problem, seed=3)
    got = {}
    for solver in ("hps", "fgmres"):
        _, loss = invdes.make_response_fn(problem, torch.complex128, solver=solver)
        value, grad, _ = loss.value_and_grad(design)
        got[solver] = (float(value), grad)
    assert abs(got["hps"][0] - got["fgmres"][0]) <= 1e-9 * got["fgmres"][0]
    assert _rel(got["hps"][1], got["fgmres"][1]) < 1e-7


def test_design_step_and_optimize_take_the_same_steps():
    problem = _problem(32, 3)
    design0 = _design(problem, seed=4)
    state = invdes.design_state(problem, solver="hps", design0=design0)
    losses = [float(invdes.design_step(state).loss) for _ in range(2)]
    design, responses, history = invdes.optimize(problem, steps=2, lr=0.1, optimizer="gd",
                                                  design0=design0, solver="hps")
    assert history == losses
    assert torch.equal(design, state.design.detach())
    assert design.dtype == torch.float64 and responses.shape == (3,)
    assert not torch.equal(design, design0)   # the update was applied


def test_an_unknown_solver_is_refused():
    with pytest.raises(ValueError, match="unknown solver"):
        invdes.make_response_fn(_problem(32, 3), solver="lu")


def test_the_decade_grid_for_hps_is_1024():
    assert invdes.hps_grid(invdes.DECADE_MIN_GRID) == 1024
    assert invdes.hps_grid(32) == 32 and invdes.hps_grid(33) == 64


def test_cli_invdes_hps(capsys):
    """``invdes --solver hps --size 32 --freqs 3 --steps 2``: the loop's
    losses and the final one are optimize(solver="hps")'s."""
    args = ["invdes", "--solver", "hps", "--size", "32", "--freqs", "3", "--steps", "2",
            "--out", "", "--device", "cpu"]
    assert main(args) == 0
    out = capsys.readouterr().out
    found = re.findall(r"^(step \d+: loss|final loss:) (\S+)$", out, re.M)
    assert [k for k, _ in found] == ["step 0: loss", "step 1: loss", "final loss:"]
    problem = invdes.lowpass_problem(N=32, n_freqs=3, device="cpu")
    _, _, history = invdes.optimize(problem, steps=2, lr=0.05, solver="hps")
    assert [float(v) for _, v in found] == [float(f"{h:.6f}") for h in history + history[-1:]]
