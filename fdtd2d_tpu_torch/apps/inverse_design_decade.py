"""Reference workflow 4 at full ambition: the 10-100 GHz decade sweep
(counterpart of ``examples/inverse_design_decade.py``).

The reference intended this sweep (its inverse_design.py builds omegas over
10-100 GHz) but never ran it. Resolving 100 GHz needs dx <= lambda/10 ~ 0.3 mm
on the same 250 mm device: an 848^2 grid. Each step is one value-and-gradient
of the omega-batched adjoint FDFD stack (10 forward and 10 adjoint solves at
848^2, batched over omega); the loop solves at ``opt_tol`` 1e-4, and the
reported responses at the problem's tolerance (1e-6, maxiter 600).

After the loop: the normalized response of the continuous design, the design
thresholded to binary eps in {1, 3} (the manufacturable endpoint) and its
response at the tight tolerance. Every solve's members that stopped at
maxiter are counted, in the loop (forward and adjoint) and in both response
passes. A SIGTERM ends the loop after the step in flight; the design reached
is then evaluated and saved all the same.

Writes ``OUT/design_decade.npy`` (the continuous design, float32) and
``OUT/inverse_design_decade.npz`` (the omegas, both responses, the ideal
response, both designs, the loss history and step times), and from it
``frequency_response_decade.png``, ``frequency_response_decade_binary.png``
and ``design_decade.png``.

Run: python -m fdtd2d_tpu_torch.apps.inverse_design_decade [steps]
        [--device cuda|cpu] [--out DIR] [--draw DIR]
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time

import numpy as np
import torch

from fdtd2d_tpu_torch.apps._common import cli, synchronize
from fdtd2d_tpu_torch.apps.inverse_design import (InverseDesignProblem, binarize,
                                                  decade_lowpass_problem, make_response_fn,
                                                  optimize)

LR, OPT_TOL = 0.05, 1e-4


def at_maxiter(iterations, maxiter: int) -> int:
    """The members of a batched solve that stopped at maxiter."""
    return sum(int(i) >= maxiter for i in iterations)


def run(problem: InverseDesignProblem = None, steps: int = 100, *, dtype=torch.complex64,
        design0=None, stop: threading.Event = None, device="cuda", out=None) -> dict:
    """The script's optimization and evaluation; ``problem`` defaults to
    ``decade_lowpass_problem(N=848, n_freqs=10, tol=1e-6, maxiter=600)`` on
    ``device``. Setting ``stop`` ends the loop after the step in flight.
    ``dtype`` and ``design0`` are ``optimize``'s (the tests pass complex128
    and JAX's start). Returns its numbers (designs and responses under
    ``arrays``)."""
    if problem is None:
        problem = decade_lowpass_problem(N=848, n_freqs=10, tol=1e-6, maxiter=600,
                                         device=device)
    N = problem.eps_base.shape[0]
    print(f"decade sweep: N={N}, dx={problem.dx * 1e3:.4f} mm, "
          f"omegas {problem.omegas[0] / 1e9:.0f}-{problem.omegas[-1] / 1e9:.0f} GHz")

    info: dict = {}
    step_times, loop_at_max = [], []
    synchronize(problem.device)
    t0 = time.perf_counter()
    last = [t0]

    def cb(s, v, d):
        now = time.perf_counter()   # the loss was read: the step is done
        step_times.append(now - last[0])
        last[0] = now
        solves = info["steps"][-1]
        loop_at_max.append([at_maxiter(solves["forward_iterations"], problem.maxiter),
                            at_maxiter(solves["adjoint_iterations"], problem.maxiter)])
        print(f"step {s}: loss {v:.6f} ({now - t0:.0f}s)", flush=True)
        return stop is not None and stop.is_set()

    design, responses, history = optimize(problem, steps=steps, lr=LR, callback=cb,
                                          log_every=1, opt_tol=OPT_TOL, dtype=dtype,
                                          design0=design0, info=info)
    synchronize(problem.device)
    elapsed = time.perf_counter() - t0
    done = len(history)
    if done < steps:
        print(f"stopped after step {done - 1} of {steps}: evaluating the design it reached")
    print(f"final loss: {history[-1]:.6f} in {elapsed:.0f}s "
          f"({elapsed / max(done, 1):.1f}s per value_and_grad incl. the first's set-up)")

    r = responses.double().cpu().numpy()
    print("normalized response:", np.round(r / r.max(), 3))

    # manufacturable endpoint: threshold to binary eps in {1, 3} and
    # re-evaluate at the tight tolerance
    bdesign = binarize(design)
    responses_b, loss_b = make_response_fn(problem, dtype)
    t_b = time.perf_counter()
    with torch.no_grad():
        rb = responses_b(bdesign).double().cpu().numpy()
    binary_s = time.perf_counter() - t_b
    print("binarized response: ", np.round(rb / rb.max(), 3))

    ideal = problem.ideal_response.double().cpu().numpy()
    design_np = design.float().cpu().numpy()
    bdesign_np = bdesign.float().cpu().numpy()
    if out is not None:
        np.save(os.path.join(out, "design_decade.npy"), design_np)
        np.savez_compressed(os.path.join(out, "inverse_design_decade.npz"),
                            omegas=np.asarray(problem.omegas), responses=r, responses_binary=rb,
                            ideal=ideal, design=design_np,
                            design_binary=bdesign_np.astype(np.uint8),  # 1 or 3
                            history=np.asarray(history), step_s=np.asarray(step_times))
    warm = step_times[1:] or step_times
    return {"N": N, "n_freqs": len(problem.omegas), "dx": problem.dx, "steps": steps,
            "steps_done": done, "stopped_early": done < steps, "lr": LR, "opt_tol": OPT_TOL,
            "tol": problem.tol, "maxiter": problem.maxiter, "seconds": elapsed,
            "step_s": step_times, "s_per_step_median_warm": float(np.median(warm)),
            "history": history, "final_loss": history[-1],
            "response": (r / r.max()).tolist(), "response_binary": (rb / rb.max()).tolist(),
            "ideal": ideal.tolist(),
            "loop_members_at_maxiter": loop_at_max,
            "loop_forward_iterations": [list(map(int, s["forward_iterations"]))
                                        for s in info["steps"]],
            "continuous_members_at_maxiter": at_maxiter(info["final"]["forward_iterations"],
                                                        problem.maxiter),
            "continuous_iterations": list(map(int, info["final"]["forward_iterations"])),
            "binary_members_at_maxiter": at_maxiter(loss_b.info["forward_iterations"],
                                                    problem.maxiter),
            "binary_iterations": list(map(int, loss_b.info["forward_iterations"])),
            "binary_s": binary_s,
            "arrays": {"design": design.cpu().numpy(), "design_binary": bdesign.cpu().numpy(),
                       "responses": r, "responses_binary": rb}}


def draw(out_dir: str) -> list:
    from fdtd2d_tpu_torch.viz.plots import _plt, plot_frequency_response

    d = np.load(os.path.join(out_dir, "inverse_design_decade.npz"))
    paths = [os.path.join(out_dir, "frequency_response_decade.png"),
             os.path.join(out_dir, "frequency_response_decade_binary.png"),
             os.path.join(out_dir, "design_decade.png")]
    plot_frequency_response(d["omegas"], d["responses"], d["ideal"], paths[0])
    plot_frequency_response(d["omegas"], d["responses_binary"], d["ideal"], paths[1])
    plt = _plt()
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(10, 5))
    a1.imshow(d["design"], cmap="viridis", vmin=1.0, vmax=3.0)
    a1.set_title("continuous design (rel. eps)")
    a2.imshow(d["design_binary"], cmap="viridis", vmin=1.0, vmax=3.0)
    a2.set_title("thresholded design")
    for a in (a1, a2):
        a.axis("off")
    fig.savefig(paths[2], dpi=150, bbox_inches="tight")
    plt.close(fig)
    return paths


def main(argv=None) -> int:
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    return cli("inverse_design_decade", __doc__, run, draw, argv,
               positionals=lambda p: p.add_argument("steps", nargs="?", type=int, default=100),
               kwargs=lambda a: dict(steps=a.steps, stop=stop))


if __name__ == "__main__":
    sys.exit(main())
