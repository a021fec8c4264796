"""Gradient-based photonics inverse design (frequency-response shaping);
counterpart of ``fdtd2d_tpu/apps/inverse_design.py``.

Optimize a permittivity design region so that the mean |Ez| at a probe
matches an ideal binary frequency response across a band:

- one operator and one FDM preconditioner a frequency are built once, from
  the base scene, and stacked over omega (ops/helmholtz.py
  ``stack_operators``, ops/fdm.py ``stack_preconditioners``);
- the multi-frequency forward pass is one batched adjoint-differentiable
  Krylov solve (fdfd/autodiff.py), the port's form of the JAX package's
  ``vmap`` over frequencies, so the solve's launches do not grow with the
  number of frequencies;
- each gradient costs one batched adjoint solve.

``solver="hps"`` solves directly instead (fdfd/autodiff.py
``solve_helmholtz_hps_differentiable``): each step builds the F complex128
operators of its design, stacked, factors them by HPS as one batch (a
complex64 factor a frequency), refines the F forward fields in complex128 to
the problem's ``tol``, computes the responses and the loss in float64, and
refines the F adjoint fields with the same factors, which then go. Nothing
is kept from one step to the next but the design: the gradient is that of
fields at a true residual of ``tol``, not of stopped iterations.

:func:`design_step` is one step of a design loop (value and gradient, the
update, the clip) on a :class:`DesignState`; :func:`optimize` loops it. Span
``invdes.step`` around each step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fdtd2d_tpu_torch import constants
from fdtd2d_tpu_torch.fdfd.autodiff import (solve_helmholtz_differentiable,
                                            solve_helmholtz_hps_differentiable)
from fdtd2d_tpu_torch.ops.fdm import fdm_preconditioner_for, stack_preconditioners
from fdtd2d_tpu_torch.ops.helmholtz import make_operator, stack_operators
from fdtd2d_tpu_torch.utils.trace import span


@dataclasses.dataclass(frozen=True)
class InverseDesignProblem:
    """Scene + objective. Slices are (row_slice, col_slice) index pairs; the
    tensors live on the device the problem was made for."""

    eps_base: torch.Tensor         # (Nx, Ny) absolute permittivity background
    mu: torch.Tensor               # (Nx, Ny)
    source: torch.Tensor           # (Nx, Ny)
    omegas: np.ndarray             # (F,) concrete frequencies
    ideal_response: torch.Tensor   # (F,)
    design_region: Tuple[slice, slice]
    probe_region: Tuple[slice, slice]
    dx: float = 1.0
    dy: float = 1.0
    pml_thickness: int = 40
    tol: float = 1e-6
    maxiter: int = 400

    @property
    def device(self) -> torch.device:
        return self.eps_base.device


def problem_from_numpy(eps_base, mu, source, omegas, ideal_response, design_region,
                       probe_region, *, dx: float = 1.0, dy: float = 1.0,
                       pml_thickness: int = 40, tol: float = 1e-6, maxiter: int = 400,
                       device="cpu") -> InverseDesignProblem:
    """A problem from host arrays of its fields, in their own dtypes (e.g.
    ``np.asarray`` of a JAX ``InverseDesignProblem``'s fields), so that both
    packages solve one scene."""

    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    return InverseDesignProblem(
        eps_base=t(eps_base), mu=t(mu), source=t(source), omegas=np.asarray(omegas),
        ideal_response=t(ideal_response), design_region=tuple(design_region),
        probe_region=tuple(probe_region), dx=float(dx), dy=float(dy),
        pml_thickness=int(pml_thickness), tol=float(tol), maxiter=int(maxiter))


def lowpass_problem(N: int = 250, n_freqs: int = 10,
                    band: Tuple[float, float] = (10e9, 17e9),
                    dx: float = 1e-3, tol: float = 1e-6,
                    maxiter: int = 400, device="cuda") -> InverseDesignProblem:
    """The reference's low-pass-filter scene (reference inverse_design.py:38-61),
    parameterized by grid size and frequency band. The physical geometry is
    held at the 250 mm reference domain: indices scale with N while dx scales
    the cell, so (N=250, dx=1mm) and (N=832, dx=0.3mm) describe the same
    device at different resolutions. Units are SI (absolute eps/mu); the top
    frequency must satisfy dx <= lambda/10. The reference's intended decade
    sweep (10-100 GHz) is ``decade_lowpass_problem``."""
    s = N / 250.0  # index scale factor: keeps the physical geometry fixed

    def r(v):  # scale and round an index
        return int(round(v * s))

    c = 1.0 / np.sqrt(constants.EPSILON_0 * constants.MU_0)
    lam_min = c / band[1]
    if not dx <= lam_min / 10.0 + 1e-12:
        raise ValueError(f"dx={dx} too coarse for {band[1]:.3g} Hz "
                         f"(need <= {lam_min / 10:.3g})")

    eps_base = np.ones((N, N))
    eps_base[r(100) : r(150), 0 : r(75)] = 3.0
    eps_base[r(100) : r(150), r(175) : N] = 3.0
    source = np.zeros((N, N))
    source[r(110) : r(140), r(40)] = 3.0
    return problem_from_numpy(
        eps_base * constants.EPSILON_0, np.full((N, N), constants.MU_0), source,
        np.linspace(band[0], band[1], n_freqs),
        np.asarray([1.0] * (n_freqs // 2) + [0.0] * (n_freqs - n_freqs // 2)),
        (slice(r(75), r(175)), slice(r(75), r(175))),
        (slice(r(110), r(140)), slice(r(210), r(210) + 1)),
        dx=dx, dy=dx, pml_thickness=min(40, max(8, N // 8)), tol=tol, maxiter=maxiter,
        device=device)


DECADE_MIN_GRID = 834   # dx <= lambda(100 GHz)/10 on the 250 mm domain


def hps_grid(N: int) -> int:
    """The least grid of at least N points a side that HPS factors with its
    leaf of 8: 16 x 2^k (fdfd/hps.py ``build_plan``: a power-of-two box grid
    on each sublattice); 1024 for the decade sweep."""
    n = 16
    while n < N:
        n *= 2
    return n


def decade_lowpass_problem(N: int = 848, n_freqs: int = 10, device="cuda",
                           **kwargs) -> InverseDesignProblem:
    """The reference's full decade sweep (10-100 GHz, reference
    inverse_design.py:44-61) on a grid fine enough to resolve 100 GHz:
    dx <= lambda(100 GHz)/10 ~ 0.2998 mm on the same 250 mm domain
    => N >= 834 (default 848: dx = 0.2948 mm; 1024, dx = 0.2441 mm, the
    least that HPS factors, :func:`hps_grid`)."""
    dx = 250e-3 / N
    return lowpass_problem(N=N, n_freqs=n_freqs, band=(10e9, 100e9), dx=dx,
                           device=device, **kwargs)


def _operators(problem: InverseDesignProblem, dtype):
    """The per-omega operators of the base scene."""
    return [make_operator(problem.eps_base, problem.mu, problem.dx, problem.dy,
                          float(omega), pml_thickness=problem.pml_thickness,
                          dtype=dtype, device=problem.device)
            for omega in problem.omegas]


def _stack_ops(problem: InverseDesignProblem, dtype):
    """The per-omega operators and FDM preconditioners of the base scene,
    each stacked over F."""
    ops = _operators(problem, dtype)
    return stack_operators(ops), stack_preconditioners([fdm_preconditioner_for(op)
                                                         for op in ops])


def _fgmres_solver(problem: InverseDesignProblem, dtype):
    """(stacked operator, solve(op_d, bs, x0s, info)): one batched FGMRES
    solve with the base scene's stacked FDM preconditioners."""
    op, M = _stack_ops(problem, dtype)

    def solve(op_d, bs, x0s, info):
        return solve_helmholtz_differentiable(op_d, bs, preconditioner=M, tol=problem.tol,
                                              maxiter=problem.maxiter, x0=x0s, info=info)
    return op, solve


def _hps_solver(problem: InverseDesignProblem, dtype):
    """(stacked complex128 operator, solve): HPS factors of the design's
    operators and complex128 refinement to the problem's ``tol``, forward
    and adjoint; ``dtype`` does not apply, and a direct solve takes no warm
    start (``x0s``)."""
    op = stack_operators(_operators(problem, torch.complex128))

    def solve(op_d, bs, x0s, info):
        return solve_helmholtz_hps_differentiable(op_d, bs, target=problem.tol, info=info)
    return op, solve


SOLVERS = {"fgmres": _fgmres_solver, "hps": _hps_solver}


def make_response_fn(problem: InverseDesignProblem, dtype=torch.complex64,
                     solver: str = "fgmres"):
    """Returns ``responses(design, x0s=None) -> (F,)`` and
    ``loss(design, x0s=None)``, both differentiable in ``design`` (relative
    permittivity of the design region, on the problem's device).

    ``solver``: ``"fgmres"`` (one batched Krylov solve of ``dtype``
    operators to the problem's ``tol``) or ``"hps"`` (direct: complex128
    operators, HPS factors, fields refined to ``tol``; the responses and
    the loss then in float64), an entry of :data:`SOLVERS`.

    ``loss.value_and_grad(design, x0s=None)`` returns ``(value, grad, xs)``:
    the loss, its gradient and the (F, Nx, Ny) fields, with which an
    optimization loop may warm-start the next step's forward solves.
    ``loss.info`` holds the last solve's figures a member, forward and
    adjoint: FGMRES's iterations and residuals, or the HPS refinement's
    rounds, residuals and adjoint fields."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; one of {sorted(SOLVERS)}")
    op, solve = SOLVERS[solver](problem, dtype)
    rs, cs = problem.design_region
    pr, pc = problem.probe_region
    ideal = problem.ideal_response
    # reference RHS convention: b = +1j * omega * source (inverse_design.py:16)
    bs = (1j * op.omega)[:, None, None] * problem.source.to(op.dtype)
    info: dict = {}

    def _responses(design, x0s):
        # design lives in relative units in [1, 3] (the reference's clip
        # bounds); the scene stores absolute permittivity
        eps = problem.eps_base.clone()
        eps[rs, cs] = design * constants.EPSILON_0
        x = solve(dataclasses.replace(op, eps=eps.to(op.eps.dtype)), bs, x0s, info)
        return x.abs()[:, pr, pc].mean(dim=(-2, -1)), x

    def responses(design, x0s=None):
        return _responses(design, x0s)[0]

    def _loss(design, x0s=None):
        r, xs = _responses(design, x0s)
        r = r / r.amax()
        return ((r - ideal) ** 2).mean(), xs

    def loss(design, x0s=None):
        return _loss(design, x0s)[0]

    def value_and_grad(design, x0s=None):
        design = torch.as_tensor(design, device=problem.device).detach().requires_grad_(True)
        with torch.enable_grad():
            value, xs = _loss(design, x0s)
            (grad,) = torch.autograd.grad(value, design)
        return value.detach(), grad, xs.detach()

    loss.value_and_grad = value_and_grad
    loss.info = info
    return responses, loss


@dataclasses.dataclass
class DesignState:
    """A design loop between two steps (:func:`design_state`). ``design``
    (the design region's relative permittivity) is the optimizer's
    parameter, updated in place; ``fields``, the last step's forward
    fields, warm-start the next step where ``warm_start`` (FGMRES)."""

    design: torch.Tensor
    responses: Callable
    loss: Callable
    optimizer: torch.optim.Optimizer
    clip: Tuple[float, float]
    warm_start: bool
    fields: Optional[torch.Tensor] = None


class StepResult(NamedTuple):
    design: torch.Tensor            # the design the step started from (a copy)
    loss: torch.Tensor              # 0-d: its loss
    grad: torch.Tensor              # the loss's gradient there
    fields: torch.Tensor            # (F, Nx, Ny) forward fields
    adjoint_fields: Optional[torch.Tensor]   # (F, Nx, Ny) adjoint fields ("hps"), else None
    info: dict                      # the solvers' figures of the step (loss.info's)


def design_state(problem: InverseDesignProblem, *, solver: str = "fgmres", lr: float = 0.1,
                 clip: Tuple[float, float] = (1.0, 3.0), optimizer: str = "gd",
                 dtype=torch.complex64, design0=None) -> DesignState:
    """A design loop's start: :func:`make_response_fn` of ``solver``, the
    design (``design0``, default the midpoint of ``clip``: in torch's default
    dtype for FGMRES, float64 for ``"hps"``, whose loss is float64) and its
    optimizer. ``optimizer="gd"`` (the default, with ``lr`` 0.1 and the clip
    to [1, 3]) is the reference's plain loop, design -= lr * grad; ``"adam"``
    takes optax's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    responses, loss = make_response_fn(problem, dtype, solver)
    rs, cs = problem.design_region
    shape = (rs.stop - rs.start, cs.stop - cs.start)
    # start at the interior of the box constraints (the reference starts at
    # the lower bound, where projected GD is pinned whenever the gradient
    # points outward)
    if design0 is None:
        design = torch.full(shape, 0.5 * (clip[0] + clip[1]), device=problem.device,
                            dtype=torch.float64 if solver == "hps" else None)
    else:
        design = torch.as_tensor(design0, device=problem.device).clone()
    design.requires_grad_(True)
    if optimizer == "adam":
        opt = torch.optim.Adam([design], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif optimizer == "gd":
        opt = torch.optim.SGD([design], lr=lr)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return DesignState(design, responses, loss, opt, tuple(clip), warm_start=solver == "fgmres")


def design_step(state: DesignState) -> StepResult:
    """One step of the design loop, in span ``invdes.step``: the loss and
    its gradient at ``state.design`` (forward and adjoint solves), the
    optimizer's update and the clip to ``state.clip``, in place."""
    with span("invdes.step"):
        design_in = state.design.detach().clone()
        value, grad, xs = state.loss.value_and_grad(
            state.design, state.fields if state.warm_start else None)
        adjoint = state.loss.info.pop("adjoint_fields", None)
        state.design.grad = grad
        state.optimizer.step()
        with torch.no_grad():
            state.design.clamp_(*state.clip)
        state.fields = xs if state.warm_start else None
        return StepResult(design_in, value, grad, xs, adjoint, dict(state.loss.info))


def optimize(problem: InverseDesignProblem, *, steps: int = 100, lr: float = 0.05,
             clip: Tuple[float, float] = (1.0, 3.0), dtype=torch.complex64,
             design0=None, optimizer: str = "adam", log_every: int = 10,
             callback: Optional[Callable] = None, opt_tol: Optional[float] = 1e-4,
             info: Optional[dict] = None, solver: str = "fgmres"):
    """Projected first-order optimization of the design region: ``steps``
    of :func:`design_step`. Returns ``(design, responses, history)``.

    ``callback(step, loss, design)`` runs every ``log_every`` steps and after
    the last; when it returns True the loop stops after that step, and the
    design reached is the result. ``info``: a dict that receives the
    solvers' figures (``loss.info``'s keys: iterations, or rounds, and
    residuals a member), a dict a step under ``"steps"`` and the final
    responses' forward solve under ``"final"``.

    ``optimizer="gd"`` is the reference's plain loop (design -= lr * grad,
    clip to bounds); the default Adam (optax's defaults: b1 0.9, b2 0.999,
    eps 1e-8) normalizes the problem-dependent gradient scale.

    ``solver``: :func:`make_response_fn`'s. ``opt_tol``: FGMRES's tolerance
    INSIDE the loop (the final responses use ``problem.tol``); its
    iterations, the whole cost of a step, scale with the digits asked for.
    ``"hps"`` refines to ``problem.tol`` throughout: a direct step's cost
    hardly moves with it. ``design0`` (default: the midpoint of ``clip``,
    :func:`design_state`) sets the design's dtype.
    """
    loop_problem = problem
    if solver == "fgmres" and opt_tol is not None and opt_tol > problem.tol:
        loop_problem = dataclasses.replace(problem, tol=opt_tol)
    state = design_state(loop_problem, solver=solver, lr=lr, clip=clip, optimizer=optimizer,
                         dtype=dtype, design0=design0)
    history = []
    for step in range(steps):
        out = design_step(state)
        if info is not None:
            info.setdefault("steps", []).append(out.info)
        history.append(float(out.loss))
        if callback is not None and (step % log_every == 0 or step == steps - 1):
            if callback(step, history[-1], state.design.detach()):
                break
    design = state.design.detach()
    # final responses at the problem's own (tight) tolerance
    responses, loss = state.responses, state.loss
    if loop_problem is not problem:
        responses, loss = make_response_fn(problem, dtype, solver)
    with torch.no_grad():
        final = responses(design, state.fields)
    if info is not None:
        keys = ("forward_rounds" if solver == "hps" else "forward_iterations", "forward_residual")
        info["final"] = {k: loss.info[k] for k in keys}
    return design, final, history


def binarize(design, clip: Tuple[float, float] = (1.0, 3.0)) -> torch.Tensor:
    """Threshold a continuous design at the midpoint of the box constraints
    (the manufacturable endpoint: relative permittivity is either lo or hi)."""
    design = torch.as_tensor(design)
    mid = 0.5 * (clip[0] + clip[1])
    return torch.where(design > mid, design.new_tensor(clip[1]), design.new_tensor(clip[0]))
