"""Empirical rank study of the block-Thomas inverses W_r (counterpart of
``examples/rank_study.py``).

Can W_r, the stored (nc x nc) inverses whose memory sets the direct
solver's wall, be stored in rank-structured form? On the bench's hard
1024^2 binary-5x scene (seed 7), sublattice (0, 0), in complex128, this runs
the recursion U_r = A_r - n_r W_{r-1} s_{r-1}, W_r = U_r^{-1} and measures,
at the script's sample rows, the numerical ranks of the HODLR level-1..3
off-diagonal blocks of W_r at tolerances 1e-2, 1e-3 and 1e-4, relative to
each block's own largest singular value and to ||W_r||_2 ("global"); then
the relative Frobenius error of the best global rank-k approximation of
the last W for k = 8, 16, 32, 64. The JAX script runs on the CPU; here the
recursion and the SVDs run on ``device`` (the card by default), in
complex128 either way.

Writes ``OUT/rank_study.npz`` (the ranks, and the singular values of the
last W) and ``rank_study.png``.

Run: python -m fdtd2d_tpu_torch.apps.rank_study [--device cuda|cpu]
        [--out DIR] [--draw DIR]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from fdtd2d_tpu_torch.apps._common import cli, timed
from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
from fdtd2d_tpu_torch.fdfd.direct import five_point_coefficients, split_sublattices
from fdtd2d_tpu_torch.ops.helmholtz import make_operator

SAMPLE_AT = (1, 2, 4, 8, 16, 32, 64, 128, 256, 511)
TOLS = (1e-2, 1e-3, 1e-4)
LEVELS = (1, 2, 3)
GLOBAL_K = (8, 16, 32, 64)
SEED, OMEGA, DX = 7, 17e9, 1e-3


def tridiag(dr, er, wr) -> torch.Tensor:
    return torch.diag_embed(dr) + torch.diag_embed(er[:-1], 1) + torch.diag_embed(wr[1:], -1)


def block_ranks(W: torch.Tensor) -> dict:
    """HODLR level-1..3 off-diagonal block ranks of W: ``{level: {tol:
    (max rank relative to the block's own norm, max rank relative to
    ||W||_2)}}`` over the blocks next to the diagonal."""
    nc = W.shape[-1]
    gs = torch.linalg.matrix_norm(W, ord=2)
    out = {}
    for lev in LEVELS:
        nb = nc >> lev
        blocks = torch.stack([W[bi * nb:(bi + 1) * nb, bj * nb:(bj + 1) * nb]
                              for bi in range(1 << lev) for bj in range(1 << lev)
                              if abs(bi - bj) == 1])
        sv = torch.linalg.svdvals(blocks)          # (blocks, nb), descending
        counts = torch.stack([torch.stack([(sv > t * sv[:, :1]).sum(1).amax(),
                                           (sv > t * gs).sum(1).amax()]) for t in TOLS])
        out[lev] = {t: tuple(int(v) for v in c) for t, c in zip(TOLS, counts.tolist())}
    return out


def run(N: int = 1024, *, device="cuda", out=None) -> dict:
    """The script's recursion and ranks; returns its numbers (the last W's
    singular values under ``arrays``)."""
    def study():
        eps, mu, _ = hard_binary_scene(N, seed=SEED)
        op = make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=40, dtype=torch.complex128,
                           device=device)
        # sublattice (0, 0)
        d, e, w, s, n = (split_sublattices(a)[0] for a in five_point_coefficients(op))
        nr, nc = d.shape
        print(f"sublattice rows={nr} cols={nc}")
        samples = {}
        W = torch.linalg.inv(tridiag(d[0], e[0], w[0]))
        for r in range(1, nr):
            U = tridiag(d[r], e[r], w[r]) - n[r][:, None] * W * s[r - 1][None, :]
            W = torch.linalg.inv(U)
            if r in SAMPLE_AT:
                br = block_ranks(W)
                w_max = float(W.abs().amax())
                samples[r] = {"w_max": w_max, "ranks": br}
                print(f"r={r:4d}  |W|max={w_max:.2e}")
                for lev, tolmap in br.items():
                    parts = ", ".join(f"tol{t:g}: rel={a} glob={g}"
                                      for t, (a, g) in tolmap.items())
                    print(f"   lev{lev} (nb={nc >> lev}): {parts}")
        # a pure global-low-rank model of the last W
        sv = torch.linalg.svdvals(W)
        tail = torch.flip(torch.cumsum(torch.flip(sv ** 2, (0,)), 0), (0,))  # sum_{i>=k} sv_i^2
        errors = {}
        for k in GLOBAL_K:
            err = float(torch.sqrt(tail[k] / tail[0])) if k < nc else 0.0
            errors[k] = err
            print(f"global rank {k}: rel err {err:.3e}")
        return nr, nc, samples, errors, sv.cpu().numpy()

    (nr, nc, samples, errors, sv), seconds = timed(study, device)
    rows = sorted(samples)
    table = np.array([[[samples[r]["ranks"][lev][t] for t in TOLS] for lev in LEVELS]
                      for r in rows], np.int64).reshape(len(rows), len(LEVELS), len(TOLS), 2)
    if out is not None:
        np.savez_compressed(os.path.join(out, "rank_study.npz"), rows=np.array(rows),
                            levels=np.array(LEVELS), tols=np.array(TOLS), ranks=table,
                            w_max=np.array([samples[r]["w_max"] for r in rows]),
                            singular_values=sv, global_k=np.array(GLOBAL_K),
                            global_errors=np.array([errors[k] for k in GLOBAL_K]), nc=nc)
    return {"N": N, "seed": SEED, "nr": nr, "nc": nc, "seconds": seconds,
            "samples": {str(r): {"w_max": samples[r]["w_max"],
                                 "ranks": {str(lev): {f"{t:g}": list(v) for t, v in m.items()}
                                           for lev, m in samples[r]["ranks"].items()}}
                        for r in rows},
            "global_rank_errors": {str(k): v for k, v in errors.items()},
            "arrays": {"rows": np.array(rows), "ranks": table, "singular_values": sv}}


def draw(out_dir: str) -> list:
    from fdtd2d_tpu_torch.viz.plots import _plt

    plt = _plt()
    d = np.load(os.path.join(out_dir, "rank_study.npz"))
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(12, 5))
    for li, lev in enumerate(d["levels"]):
        for ti, t in enumerate(d["tols"]):
            a1.plot(d["rows"], d["ranks"][:, li, ti, 0], "o-", label=f"level {lev}, tol {t:g}")
    a1.set_xscale("log", base=2)
    a1.set_xlabel("recursion row r")
    a1.set_ylabel("max off-diagonal block rank (relative)")
    a1.legend(fontsize=7)
    a1.grid(alpha=0.3)
    sv = d["singular_values"]
    a2.semilogy(np.arange(1, sv.size + 1), sv / sv[0])
    a2.set_xlabel("k")
    a2.set_ylabel("sigma_k / sigma_1 of the last W")
    a2.grid(alpha=0.3)
    path = os.path.join(out_dir, "rank_study.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return [path]


def main(argv=None) -> int:
    return cli("rank_study", __doc__, run, draw, argv)


if __name__ == "__main__":
    sys.exit(main())
