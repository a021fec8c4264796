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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from fdtd2d_tpu_torch import constants
from fdtd2d_tpu_torch.fdfd.autodiff import solve_helmholtz_differentiable
from fdtd2d_tpu_torch.ops.fdm import fdm_preconditioner_for, stack_preconditioners
from fdtd2d_tpu_torch.ops.helmholtz import make_operator, stack_operators


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


def decade_lowpass_problem(N: int = 848, n_freqs: int = 10, device="cuda",
                           **kwargs) -> InverseDesignProblem:
    """The reference's full decade sweep (10-100 GHz, reference
    inverse_design.py:44-61) on a grid fine enough to resolve 100 GHz:
    dx <= lambda(100 GHz)/10 ~ 0.2998 mm on the same 250 mm domain
    => N >= 834 (default 848: dx = 0.2948 mm)."""
    dx = 250e-3 / N
    return lowpass_problem(N=N, n_freqs=n_freqs, band=(10e9, 100e9), dx=dx,
                           device=device, **kwargs)


def _stack_ops(problem: InverseDesignProblem, dtype):
    """The per-omega operators and FDM preconditioners of the base scene,
    each stacked over F."""
    ops = [make_operator(problem.eps_base, problem.mu, problem.dx, problem.dy,
                         float(omega), pml_thickness=problem.pml_thickness,
                         dtype=dtype, device=problem.device)
           for omega in problem.omegas]
    return stack_operators(ops), stack_preconditioners([fdm_preconditioner_for(op)
                                                         for op in ops])


def make_response_fn(problem: InverseDesignProblem, dtype=torch.complex64):
    """Returns ``responses(design, x0s=None) -> (F,)`` and
    ``loss(design, x0s=None)``, both differentiable in ``design`` (relative
    permittivity of the design region, on the problem's device).

    ``loss.value_and_grad(design, x0s=None)`` returns ``(value, grad, xs)``:
    the loss, its gradient and the converged (F, Nx, Ny) fields, with which
    an optimization loop warm-starts the next step's forward solves.
    ``loss.info`` holds the last solve's per-member FGMRES iterations and
    residuals, forward and adjoint."""
    op, M = _stack_ops(problem, dtype)
    rs, cs = problem.design_region
    pr, pc = problem.probe_region
    ideal = problem.ideal_response
    # reference RHS convention: b = +1j * omega * source (inverse_design.py:16)
    bs = (1j * op.omega)[:, None, None] * problem.source.to(dtype)
    info: dict = {}

    def _responses(design, x0s):
        # design lives in relative units in [1, 3] (the reference's clip
        # bounds); the scene stores absolute permittivity
        eps = problem.eps_base.clone()
        eps[rs, cs] = design * constants.EPSILON_0
        op_d = dataclasses.replace(op, eps=eps.to(op.eps.dtype))
        x = solve_helmholtz_differentiable(op_d, bs, preconditioner=M, tol=problem.tol,
                                           maxiter=problem.maxiter, x0=x0s, info=info)
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


def optimize(problem: InverseDesignProblem, *, steps: int = 100, lr: float = 0.05,
             clip: Tuple[float, float] = (1.0, 3.0), dtype=torch.complex64,
             design0=None, optimizer: str = "adam", log_every: int = 10,
             callback: Optional[Callable] = None, opt_tol: Optional[float] = 1e-4,
             info: Optional[dict] = None):
    """Projected first-order optimization of the design region. Returns
    ``(design, responses, history)``.

    ``callback(step, loss, design)`` runs every ``log_every`` steps and after
    the last; when it returns True the loop stops after that step, and the
    design reached is the result. ``info``: a dict that receives the
    solvers' figures (``loss.info``'s keys: iterations and residuals a
    member), a dict a step under ``"steps"`` and the final responses'
    forward solve under ``"final"``.

    ``optimizer="gd"`` is the reference's plain loop (design -= lr * grad,
    clip to bounds); the default Adam (optax's defaults: b1 0.9, b2 0.999,
    eps 1e-8) normalizes the problem-dependent gradient scale.

    ``opt_tol``: solver tolerance INSIDE the loop (the final responses use
    ``problem.tol``); FGMRES's iterations, the whole cost of a step, scale
    with the digits asked for. ``design0`` (default: the midpoint of
    ``clip`` in torch's default dtype) sets the design's dtype.
    """
    loop_problem = problem
    if opt_tol is not None and opt_tol > problem.tol:
        loop_problem = dataclasses.replace(problem, tol=opt_tol)
    responses, loss = make_response_fn(loop_problem, dtype)
    rs, cs = problem.design_region
    shape = (rs.stop - rs.start, cs.stop - cs.start)
    # start at the interior of the box constraints (the reference starts at
    # the lower bound, where projected GD is pinned whenever the gradient
    # points outward)
    if design0 is None:
        design = torch.full(shape, 0.5 * (clip[0] + clip[1]), device=problem.device)
    else:
        design = torch.as_tensor(design0, device=problem.device).clone()
    design.requires_grad_(True)
    if optimizer == "adam":
        opt = torch.optim.Adam([design], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif optimizer == "gd":
        opt = torch.optim.SGD([design], lr=lr)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")

    history = []
    x0s = None
    for step in range(steps):
        value, design.grad, x0s = loss.value_and_grad(design, x0s)
        if info is not None:
            info.setdefault("steps", []).append(dict(loss.info))
        opt.step()
        with torch.no_grad():
            design.clamp_(clip[0], clip[1])
        history.append(float(value))
        if callback is not None and (step % log_every == 0 or step == steps - 1):
            if callback(step, history[-1], design.detach()):
                break
    design = design.detach()
    # final responses at the problem's own (tight) tolerance
    if loop_problem is not problem:
        responses, loss = make_response_fn(problem, dtype)
    with torch.no_grad():
        final = responses(design, x0s)
    if info is not None:
        info["final"] = {k: loss.info[k] for k in ("forward_iterations", "forward_residual")}
    return design, final, history


def binarize(design, clip: Tuple[float, float] = (1.0, 3.0)) -> torch.Tensor:
    """Threshold a continuous design at the midpoint of the box constraints
    (the manufacturable endpoint: relative permittivity is either lo or hi)."""
    design = torch.as_tensor(design)
    mid = 0.5 * (clip[0] + clip[1])
    return torch.where(design > mid, design.new_tensor(clip[1]), design.new_tensor(clip[0]))
