"""Plain reference of one adjoint inverse-design step of the upstream's
low-pass filter (github.com/skunnavakkam/fdtd-2d,
python-src/inverse_design.py:38-132): for a design, each frequency's
operator, its exact field, the responses, the loss, the exact adjoint and
the gradient on the design region.

For each omega, with eps = eps_base (relative) outside the design region
and the design inside it, times eps0:

    A x = b,   b = 1j omega src           (the upstream's right-hand side)
    a_p = |x_p| on the probe cells,  r = mean_p a_p
    L = mean_omega (r / max_omega r - ideal)^2

A is reference/fdfd.py's operator in complex128: its part without eps
assembled with scipy once an omega and ``A^T = A`` asserted on it (to
rounding), then -omega^2 eps added to its diagonal for each design, a
diagonal that keeps A symmetric. With
c = dL/da (torch's autograd of the real function L(a), float64) and
v_p = c_p conj(x_p) / |x_p|,

    dL/deps_k = sum_omega omega^2 Re(x_k (A^-T v)_k),   A^-T v = sum_p v_p A^-1 e_p

so the probe cells' unit sources e_p are solved beside b in one pass, each
frequency factored once, and only their fields on the design region are
kept. The gradient in the design's relative units is eps0 times that.

The exact solves are reference/fdfd_sublattice.py's: the four five-point
sublattices of three frequencies at a time (``GROUP``), factored together by dense
block elimination in complex128 on the device, refined against their own
entries to rounding, then freed.

Where the program's fields of the step are given, each is held to the
operator here: the forward fields' true residuals against b, and the
adjoint fields' against v computed (as above) from the program's own
forward fields, which is the system the program's adjoint solved.

This module imports nothing of the measured program. Both of torch's TF32
flags are set False: the eliminations need full-precision products.
"""

from __future__ import annotations

import copy

import numpy as np
import scipy.sparse as sp
import torch

from portbench.reference import fdfd as ref
from portbench.reference.fdfd_sublattice import OneAtATime

MU_0 = 4.0e-7 * 3.141592653589793
SYMMETRY = 1e-15   # max |A - A^T| over max |A|: rounding
EXACT = 1e-10      # the most residual an exact field may keep
GROUP = 3          # omegas factored at once: 26 GB of inverses at 1024^2, a check's peak 64.6 GB

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def loss_and_slopes(a, ideal):
    """(L, dL/da) of the probe magnitudes a (F, P), float64."""
    a = torch.as_tensor(a, dtype=torch.float64).detach().clone().requires_grad_(True)
    r = a.mean(dim=1)
    r = r / r.max()
    loss = ((r - torch.as_tensor(ideal, dtype=torch.float64)) ** 2).mean()
    loss.backward()
    return float(loss.detach()), a.grad


def adjoint_sources(x_probe, ideal):
    """(L, v (F, P)): the loss and the adjoint right-hand side on the probe
    cells, v = dL/da conj(x) / |x|, of the forward fields' probe values
    x_probe (F, P) complex128."""
    x_probe = torch.as_tensor(x_probe, dtype=torch.complex128)
    loss, c = loss_and_slopes(x_probe.abs(), ideal)
    return loss, c * torch.conj_physical(x_probe) / x_probe.abs()


class _Stack(OneAtATime):
    """The sublattices of several operators on one leading axis (four an
    operator), factored together."""

    def __init__(self, parts):
        first = parts[0]
        self.shape, self.device, self.inv = first.shape, first.device, None
        for name in ("d0", "e", "w", "up", "lo"):
            setattr(self, name, torch.cat([getattr(p, name) for p in parts]))

    def member(self, n: int) -> "_Stack":
        """Operator n's entries alone, unfactored."""
        one = copy.copy(self)
        for name in ("d0", "e", "w", "up", "lo"):
            setattr(one, name, getattr(self, name)[4 * n : 4 * n + 4])
        one.inv = None
        return one

    def solve_split(self, f, rounds: int = 3, tol: float = 1e-12):
        """(y, relative residual of each of the (S, K) parts' columns) for
        split right-hand sides f (S, K, nr, nc), S four an operator."""
        fn = torch.linalg.vector_norm(f.unflatten(0, (-1, 4)), dim=(1, 3, 4))   # (ops, K)
        y = self._solve(f)
        for _ in range(rounds):
            r = f - self._apply(y)
            res = torch.linalg.vector_norm(r.unflatten(0, (-1, 4)), dim=(1, 3, 4)) / fn
            if float(res.max()) <= tol:
                break
            y = y + self._solve(r)
        r = f - self._apply(y)
        return y, torch.linalg.vector_norm(r.unflatten(0, (-1, 4)), dim=(1, 3, 4)) / fn


class Reference:
    """The step's numbers for an N x N scene (scenes/lowpass.py's dict),
    ``omegas`` (F,), the ideal response, the cell size ``dx`` and the UPML
    (``pml``: cells, sigma_max, order), computed on ``device``."""

    def __init__(self, scene: dict, omegas, ideal, dx: float, pml: dict, device):
        self.eps_base = np.asarray(scene["eps"], np.float64)
        self.source = np.asarray(scene["source"], np.float64)
        self.N = self.eps_base.shape[0]
        (r0, r1), (c0, c1) = scene["design"]
        self.design = (slice(r0, r1), slice(c0, c1))
        (p0, p1), (q0, q1) = scene["probe"]
        self.probe = [(i, j) for i in range(p0, p1) for j in range(q0, q1)]
        self.omegas = [float(w) for w in omegas]
        self.ideal = np.asarray(ideal, np.float64)
        self.dx, self.pml = float(dx), pml
        self.device = torch.device(device)
        self._curl = {}   # omega -> the sublattices of A without its eps term

    def operator(self, design, omega: float) -> sp.csr_matrix:
        """A of the design at ``omega``, asserted complex symmetric."""
        eps = self.eps_base.copy()
        eps[self.design] = design
        return self._assemble(eps, omega)

    def _assemble(self, eps, omega: float) -> sp.csr_matrix:
        """A of the relative permittivity ``eps``, asserted complex symmetric."""
        p = self.pml
        A = ref.operator(eps * ref.EPSILON_0, np.full(eps.shape, MU_0), self.dx, self.dx,
                         omega, p["cells"], p["sigma_max"], p["order"])
        asym = abs(A - A.T).max()
        assert asym <= SYMMETRY * abs(A).max(), f"A^T != A: {asym} of {abs(A).max()}"
        return A

    def sublattices(self, design, omega: float) -> ref.Sublattices:
        """The sublattices of A of the design at ``omega``: those of A
        without its eps term (assembled and asserted symmetric once an
        omega), their diagonal less omega^2 eps."""
        if omega not in self._curl:
            self._curl[omega] = ref.Sublattices(
                self._assemble(np.zeros_like(self.eps_base), omega), self.eps_base.shape,
                self.device)
        eps = self.eps_base.copy()
        eps[self.design] = design
        one = copy.copy(self._curl[omega])
        eps = torch.as_tensor(eps * ref.EPSILON_0, device=self.device)
        one.d0 = one.d0 - omega**2 * self._split(eps[None])[:, 0]
        return one

    def _split(self, x):
        """(K, N, N) -> (4, K, nr, nc), the sublattices' order."""
        return torch.stack([x[:, p::2, q::2] for p in (0, 1) for q in (0, 1)])

    def _join(self, y):
        x = torch.empty((y.shape[1], self.N, self.N), dtype=y.dtype, device=y.device)
        for s, (p, q) in enumerate((p, q) for p in (0, 1) for q in (0, 1)):
            x[:, p::2, q::2] = y[s]
        return x

    def _probe_values(self, x):
        """(F, P) values of (F, N, N) fields at the probe cells."""
        idx = torch.as_tensor(self.probe, device=x.device)
        return x[:, idx[:, 0], idx[:, 1]]

    def exact(self, design, adjoint_sources=None):
        """(x, y): the exact (F, N, N) forward fields and, given the adjoint
        right-hand sides on the probe cells ``adjoint_sources`` (F, P), the
        exact adjoint fields (else None); every field whole, one omega at a
        time (for grids whose fields all fit)."""
        N = self.N
        idx = torch.as_tensor(self.probe, device=self.device)
        source = torch.as_tensor(self.source, dtype=torch.complex128, device=self.device)
        xs, ys = [], []
        for f, w in enumerate(self.omegas):
            rhs = [(1j * w * source)[None]]
            if adjoint_sources is not None:
                v = torch.zeros_like(rhs[0])
                v[0, idx[:, 0], idx[:, 1]] = torch.as_tensor(adjoint_sources[f]).to(self.device)
                rhs.append(v)
            x, res = ref.Sublattices(self.operator(design, w), (N, N), self.device).solve(
                torch.cat(rhs))
            assert float(res.max()) <= EXACT, f"an exact solve kept a residual of {res.max()}"
            xs.append(x[0])
            ys.append(x[1] if adjoint_sources is not None else None)
        return torch.stack(xs), (torch.stack(ys) if adjoint_sources is not None else None)

    def step(self, design, fields=None, adjoint_fields=None) -> dict:
        """The reference's ``loss`` and ``grad`` (the design region's shape,
        float64 numpy) at ``design`` (relative permittivity, the design
        region's shape), and ``exact_residual``, the worst own residual of
        its exact solves. Given the program's forward ``fields`` and
        ``adjoint_fields`` (F, N, N), also ``residual`` (the worst true
        relative residual of the program's 2F fields against this operator)
        and ``field_err`` (the worst ||x - x_exact|| / ||x_exact|| of its
        forward fields)."""
        design = np.asarray(design, np.float64)
        N, F, P = self.N, len(self.omegas), len(self.probe)
        dev = self.device
        units = torch.zeros((P, N, N), dtype=torch.complex128, device=dev)
        for k, (i, j) in enumerate(self.probe):
            units[k, i, j] = 1.0
        source = torch.as_tensor(self.source, dtype=torch.complex128, device=dev)
        idx = torch.as_tensor(self.probe, device=dev)
        if fields is not None:
            fields = torch.as_tensor(fields).to(dev, torch.complex128)
            adjoint_fields = torch.as_tensor(adjoint_fields).to(dev, torch.complex128)
            _, v_prog = adjoint_sources(self._probe_values(fields).cpu(), self.ideal)
            v_prog = v_prog.to(dev)
        x_probe = torch.empty((F, P), dtype=torch.complex128, device=dev)
        x_design, g_design = [], []     # x and the unit sources' fields on the design region
        out = {"exact_residual": 0.0, "residual": 0.0, "field_err": 0.0}
        for f0 in range(0, F, GROUP):
            ws = self.omegas[f0 : f0 + GROUP]
            stack = _Stack([self.sublattices(design, w) for w in ws]).factor()
            rhs = torch.cat([self._split(torch.cat([(1j * w * source)[None], units]))
                             for w in ws])                    # (4 ops, 1 + P, nr, nc)
            y, res = stack.solve_split(rhs)
            out["exact_residual"] = max(out["exact_residual"], float(res.max()))
            for n, w in enumerate(ws):
                f = f0 + n
                x = self._join(y[4 * n : 4 * n + 4])          # (1 + P, N, N)
                x_probe[f] = self._probe_values(x[:1])[0]
                x_design.append(x[0][self.design].clone())
                g_design.append(x[1:][(slice(None),) + self.design].clone())
                if fields is None:
                    continue
                one = stack.member(n)
                b = (1j * w * source)[None]
                va = torch.zeros_like(b)
                va[0, idx[:, 0], idx[:, 1]] = v_prog[f]
                for got, want in ((fields[f][None], b), (adjoint_fields[f][None], va)):
                    r = want - self._join(one._apply(self._split(got)))
                    rel = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(want))
                    out["residual"] = max(out["residual"], rel if np.isfinite(rel) else np.inf)
                err = float(torch.linalg.vector_norm(fields[f] - x[0])
                            / torch.linalg.vector_norm(x[0]))
                out["field_err"] = max(out["field_err"], err if np.isfinite(err) else np.inf)
            del stack, rhs, y
        loss, v = adjoint_sources(x_probe.cpu(), self.ideal)
        v = v.to(dev)
        grad = torch.zeros(x_design[0].shape, dtype=torch.float64, device=dev)
        for f, w in enumerate(self.omegas):
            adj = torch.tensordot(v[f], g_design[f], dims=1)   # (A^-T v) on the design region
            grad += w**2 * (x_design[f] * adj).real
        out.update(loss=loss, grad=(ref.EPSILON_0 * grad).cpu().numpy())
        if fields is None:
            del out["residual"], out["field_err"]
        return out
