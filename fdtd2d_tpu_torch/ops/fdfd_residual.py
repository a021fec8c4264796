"""The complex128 work of an FDFD refinement round — CUDA kernel wrapper and
plain version.

For an unstacked complex128 operator ``op`` (ops/helmholtz.py) and complex128
fields ``x``, ``b`` of shape (Nx, Ny) or (B, Nx, Ny):

- :func:`residual_pass` returns ``(r / ||r|| in complex64, ||r|| float64)``
  with ``r = b - A x``, ||r|| per sample ((B,), or 0-d for one field), on the
  device: the two values fdfd/refine.py's residual step returns;
- :func:`norms` returns ||b|| per sample the same way;
- :func:`update` makes ``x += ||r|| d`` in place, ``d`` the complex64 inner
  correction.

Each runs ``ops/csrc/fdfd_residual.cu`` (its header gives the design and what
bounds it) on CUDA tensors only, and raises ``ValueError`` on anything the
kernels do not take: there is no fallback. :func:`takes_kernel` is the
dispatch rule of fdfd/refine.py, which runs torch's chain for everything
else.

The kernels compute r with the operator's own operations in its order, so r
is ``op.residual(b, x)`` bit for bit; the norms fold overflow-safe partials
(the max of |re|, |im| and the sum of squares scaled by it) of tiles of
``TILE_ROWS`` x ``TILE_COLS`` points in a fixed order. The plain versions
(:func:`residual_pass_reference`, :func:`norms_reference`,
:func:`update_reference`) do the same in torch ops, tile for tile. Work is
counted in utils/trace.py as ``fdfd.kernels.residual_passes`` (one a residual
pass) and ``fdfd.kernels.refine_updates`` (one an update).
"""

from __future__ import annotations

from typing import Optional

import torch

from fdtd2d_tpu_torch.ops import _build
from fdtd2d_tpu_torch.ops.helmholtz import HelmholtzOperator
from fdtd2d_tpu_torch.utils.trace import count

TILE_ROWS = 64    # rows a CTA walks down: the kernel's kRows
TILE_COLS = 256   # columns a CTA, one a thread: the kernel's kCols


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on a CUDA device: the one clause of the rule that
    the CPU tests stand in for."""
    return t.is_cuda


def _refusal(op: Optional[HelmholtzOperator], *fields: torch.Tensor) -> Optional[str]:
    """Why the kernels do not take these fields (and operator, unless None),
    or None where they do."""
    names = ("b", "x")
    for name, f in zip(names, fields):
        if f.dtype != torch.complex128:
            return f"the residual kernel takes complex128 fields; {name} is {f.dtype}"
        if not f.is_contiguous():
            return f"the residual kernel takes contiguous fields; {name} is not"
        if not _on_card(f):
            return f"no residual kernel for {name} on {f.device}"
    f = fields[0]
    if f.dim() not in (2, 3) or f.numel() == 0:
        return f"the residual kernel wants (Nx, Ny) or (B, Nx, Ny) fields, got {tuple(f.shape)}"
    for name, g in zip(names[1:], fields[1:]):
        if g.shape != f.shape or g.device != f.device:
            return f"{name} is {tuple(g.shape)} on {g.device}, b {tuple(f.shape)} on {f.device}"
    Nx, Ny = f.shape[-2:]
    B = f.shape[0] if f.dim() == 3 else 1
    if max(Nx * Ny, B * _tiles(Nx, Ny)) >= 2**31 or B > 65535:
        return (f"the residual kernels count the points of a sample and the CTAs with 32-bit "
                f"ints, and the update's grid holds at most 65535 samples: {tuple(f.shape)}")
    if op is None:
        return None
    if op.dtype != torch.complex128 or op.batch_shape != ():
        return (f"the residual kernel takes an unstacked complex128 operator, got {op.dtype} "
                f"with batch shape {op.batch_shape}")
    if (Nx, Ny) != op.shape:
        return f"fields of {tuple(f.shape)} for an operator of {op.shape}"
    parts = {"eps": (op.eps, torch.float64, (Nx, Ny)),
             "inv_mu": (op.inv_mu, torch.float64, (Nx, Ny)),
             "inv_s_row": (op.inv_s_row, torch.complex128, (Nx,)),
             "inv_s_col": (op.inv_s_col, torch.complex128, (Ny,)),
             "omega": (op.omega, torch.float64, ()),
             "inv_2dx": (op.inv_2dx, torch.float64, ()),
             "inv_2dy": (op.inv_2dy, torch.float64, ())}
    for name, (t, dtype, shape) in parts.items():
        if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != f.device):
            return (f"the operator's {name} is {t.dtype} {tuple(t.shape)} on {t.device}; the "
                    f"residual kernel wants a contiguous {dtype} {shape} on {f.device}")
    return None


def takes_kernel(op: HelmholtzOperator, b: torch.Tensor, x: torch.Tensor, inner_dtype) -> bool:
    """fdfd/refine.py's rule, taken once a refinement: contiguous CUDA
    complex128 (B, Nx, Ny) fields ``b`` and ``x``, an unstacked complex128
    operator, complex64 inner solves. Where it holds, every residual pass,
    the norm of b and every update of that refinement run the kernels."""
    return inner_dtype == torch.complex64 and b.dim() == 3 and _refusal(op, b, x) is None


def _check(op: Optional[HelmholtzOperator], *fields: torch.Tensor):
    """Raise ``ValueError`` on what the kernels do not take."""
    why = _refusal(op, *fields)
    if why is not None:
        raise ValueError(why)


def _tiles(Nx: int, Ny: int) -> int:
    return -(-Nx // TILE_ROWS) * -(-Ny // TILE_COLS)


def _geometry(f: torch.Tensor):
    """(B, Nx, Ny, tiles) of a field."""
    Nx, Ny = f.shape[-2:]
    return (f.shape[0] if f.dim() == 3 else 1), Nx, Ny, _tiles(Nx, Ny)


def _raise(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({_build.load().fdtd_error_string(err).decode()})")


def residual_pass(op: HelmholtzOperator, b: torch.Tensor, x: torch.Tensor):
    """``(r / ||r|| complex64, ||r|| float64)`` of ``r = b - A x`` by the
    kernels: three launches (sweep, combine, sweep). ||r|| is (B,) for (B, Nx,
    Ny) fields, 0-d for (Nx, Ny); a zero residual scales by 1."""
    _check(op, b, x)
    B, Nx, Ny, tiles = _geometry(b)
    partials = torch.empty((B * tiles, 2), dtype=torch.float64, device=b.device)
    rn = torch.empty(B, dtype=torch.float64, device=b.device)
    out = torch.empty(b.shape, dtype=torch.complex64, device=b.device)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    with torch.cuda.device(b.device):
        err = _build.load().fdfd_residual_pass(
            x.data_ptr(), b.data_ptr(), op.eps.data_ptr(), op.inv_mu.data_ptr(),
            op.inv_s_row.data_ptr(), op.inv_s_col.data_ptr(), op.omega.data_ptr(),
            op.inv_2dx.data_ptr(), op.inv_2dy.data_ptr(), partials.data_ptr(), rn.data_ptr(),
            out.data_ptr(), B, Nx, Ny, stream)
    _raise(err, "fdfd_residual_pass")
    count("fdfd.kernels.residual_passes")
    return out, rn.reshape(b.shape[:-2])


def norms(b: torch.Tensor) -> torch.Tensor:
    """||b|| per sample (float64, (B,) or 0-d) by the kernels' tiles,
    partials and combine: two launches."""
    _check(None, b)
    B, Nx, Ny, tiles = _geometry(b)
    partials = torch.empty((B * tiles, 2), dtype=torch.float64, device=b.device)
    rn = torch.empty(B, dtype=torch.float64, device=b.device)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    with torch.cuda.device(b.device):
        err = _build.load().fdfd_residual_norms(b.data_ptr(), partials.data_ptr(), rn.data_ptr(),
                                                B, Nx, Ny, stream)
    _raise(err, "fdfd_residual_norms")
    return rn.reshape(b.shape[:-2])


def update(x: torch.Tensor, rn: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``x += rn d`` in place by the kernel (one launch) and return ``x``:
    ``x`` a contiguous CUDA complex128 (Nx, Ny) or (B, Nx, Ny) field, ``d``
    complex64 of its shape on its device, ``rn`` its float64 norms ((B,) or
    one); raises ``ValueError`` on anything else."""
    if not (_on_card(x) and x.dtype == torch.complex128 and x.is_contiguous() and x.dim() in (2, 3)
            and x.numel() > 0 and d.dtype == torch.complex64 and d.shape == x.shape
            and d.device == x.device and rn.dtype == torch.float64 and rn.device == x.device
            and rn.numel() == (x.shape[0] if x.dim() == 3 else 1)):
        raise ValueError(f"the update kernel takes a contiguous CUDA complex128 x, a complex64 d of "
                         f"its shape and float64 norms on its device; got x {x.dtype} "
                         f"{tuple(x.shape)} on {x.device} (contiguous: {x.is_contiguous()}), d "
                         f"{d.dtype} {tuple(d.shape)} on {d.device}, rn {rn.dtype} "
                         f"{tuple(rn.shape)} on {rn.device}")
    d = d.contiguous()
    B = x.shape[0] if x.dim() == 3 else 1
    per_sample = x.numel() // B
    if per_sample >= 2**31 or B > 65535:
        raise ValueError(f"the update kernel takes at most 65535 samples of < 2^31 points: "
                         f"{tuple(x.shape)}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _build.load().fdfd_refine_update(x.data_ptr(), d.data_ptr(), rn.data_ptr(), B,
                                               per_sample, stream)
    _raise(err, "fdfd_refine_update")
    count("fdfd.kernels.refine_updates")
    return x


def _tile_partials(v: torch.Tensor) -> torch.Tensor:
    """(B, tiles, 2): each tile's (max of |re|, |im|; sum of squares scaled
    by it), tiles in the kernel's order (row tiles, then column tiles)."""
    v = torch.view_as_real(v.reshape((-1,) + tuple(v.shape[-2:]))).abs()
    B, Nx, Ny = v.shape[:3]
    tr, tc = -(-Nx // TILE_ROWS), -(-Ny // TILE_COLS)
    v = torch.nn.functional.pad(v, (0, 0, 0, tc * TILE_COLS - Ny, 0, tr * TILE_ROWS - Nx))
    v = v.reshape(B, tr, TILE_ROWS, tc, TILE_COLS, 2).permute(0, 1, 3, 2, 4, 5)
    v = v.reshape(B, tr * tc, -1)
    m = v.amax(dim=-1)
    safe = torch.where(m == 0, torch.ones_like(m), m)
    return torch.stack((m, ((v / safe[..., None]) ** 2).sum(dim=-1)), dim=-1)


def _combine(partials: torch.Tensor) -> torch.Tensor:
    """(B,) norms from (B, tiles, 2) partials: the largest max, each tile's
    sum rescaled to it."""
    m, s = partials[..., 0], partials[..., 1]
    M = m.amax(dim=-1, keepdim=True)
    q = m / torch.where(M > 0, M, torch.ones_like(M))
    return M[..., 0] * torch.sqrt((s * q * q).sum(dim=-1))


def norms_reference(b: torch.Tensor) -> torch.Tensor:
    """Plain torch ops: :func:`norms` on any device."""
    return _combine(_tile_partials(b)).reshape(b.shape[:-2])


def residual_pass_reference(op: HelmholtzOperator, b: torch.Tensor, x: torch.Tensor):
    """Plain torch ops: :func:`residual_pass` on any device. r is the
    operator's ``residual``, the norm the kernels' tiles and combine, the
    scale a product with 1 / ||r||, as torch divides a complex by a real."""
    r = op.residual(b, x)
    rn = norms_reference(r)
    safe = torch.where(rn == 0, torch.ones_like(rn), rn)
    inv = 1.0 / safe
    return (r * inv[..., None, None]).to(torch.complex64), rn


def update_reference(x: torch.Tensor, rn: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Plain torch ops: :func:`update`, in place."""
    scale = rn[..., None, None] if x.dim() == 3 else rn
    return x.add_(scale * d.to(torch.complex128))
