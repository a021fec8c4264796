"""The row sweep of the block-Thomas backsolve — CUDA kernel wrapper, planner
and plain version.

For stored inverses ``Ws`` (..., nr, nc, nc) (``W_r = U_r^{-1}`` of
fdfd/direct.py), couplings ``nvals`` and ``svals`` (..., nr, nc) and right-hand
sides ``b`` (..., K, nr, nc), the two recurrences

    z_0 = W_0 b_0,          z_r = W_r (b_r - n_r o z_{r-1})    (forward)
    x_{nr-1} = z_{nr-1},    x_r = z_r - W_r (s_r o x_{r+1})    (backward)

give x = A^{-1} b of one sublattice, or of several stacked on the leading
axes. :func:`row_sweep` runs each direction as one cooperative launch of
``ops/csrc/fdfd_rowsweep.cu`` (its header gives the design and what bounds it),
on CUDA complex64 tensors only, and raises on anything else: there is no
fallback. :func:`row_sweep_reference` is its plain version, the torch loop
of three operations a row; fdfd/direct.py runs it for every other input (CPU
tensors, complex128 factors on the card).

:func:`plan_row_sweep` cuts the work from the shapes alone: each leading
index is a group, the right-hand sides split into chunks of at most 16, and
the CTAs of the card are shared out over the (group, chunk) units, each
owning a slab of the nc rows of every W_r and streaming it through a ring of
``rows``-row tiles in shared memory. Launches are counted in utils/trace.py
as ``fdfd.kernels.row_sweeps`` (two an inner solve, one a direction, more
only where the units outnumber the SMs).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from fdtd2d_tpu_torch.ops import _build, fdtd_fused
from fdtd2d_tpu_torch.utils.trace import count

THREADS = 256       # a CTA
KPADS = (4, 8, 16)  # the right-hand sides of a chunk, padded: the kernel's instantiations
RING_ROWS = (64, 32, 16, 8, 4)   # rows of W a ring tile may hold, largest first
# SMs and shared memory a block of an H100: what the CPU tests plan with
H100 = (132, 232_448)


def smem_bytes(nc: int, kp: int, rows: int) -> int:
    """Dynamic shared memory of a CTA: two ring tiles of ``rows`` x nc, the
    carried vector (nc rows of kp + 2 complex values), 256 partial sums and
    two operands of each of the tile's rows x kp outputs."""
    return 8 * (2 * rows * nc + nc * (kp + 2) + THREADS + 2 * rows * kp)


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    groups: int   # independent systems: the product of the leading axes
    nr: int
    nc: int
    K: int        # right-hand sides a group
    chunks: int   # the right-hand sides run as chunks of kc (the last may hold fewer)
    kc: int
    kp: int       # kc padded to one of KPADS
    ctas: int     # CTAs a unit (a group and a chunk): each owns a slab of the nc rows
    rows: int     # rows of W a ring tile
    per_launch: int   # units a launch; more units run as more launches

    @property
    def units(self) -> int:
        return self.groups * self.chunks

    @property
    def launches(self) -> int:
        """Launches a direction."""
        return -(-self.units // self.per_launch)

    @property
    def grid(self) -> int:
        """CTAs of the largest launch."""
        return self.per_launch * self.ctas

    @property
    def smem(self) -> int:
        return smem_bytes(self.nc, self.kp, self.rows)


@functools.lru_cache(maxsize=256)
def plan_row_sweep(groups: int, nr: int, nc: int, K: int, sms: int = H100[0],
                   smem: int = H100[1]) -> SweepPlan:
    """The launch shape for ``groups`` systems of nr block rows of nc, each
    with K right-hand sides, on a device with ``sms`` SMs and ``smem`` bytes
    of shared memory a block: the fewest chunks whose carried vector and a
    ring of at least 4-row tiles fit, then as many CTAs a unit as the SMs
    give (at least 4 rows a slab), and the largest ring tile that the slab
    needs and shared memory holds. Raises ``ValueError`` where not even a
    4-column chunk fits."""
    if min(groups, nr, nc, K) < 1:
        raise ValueError(f"no row sweep for {groups} groups of {nr} x {nc} rows, K = {K}")
    for chunks in range(-(-K // KPADS[-1]), K + 1):
        kc = -(-K // chunks)
        kp = next(p for p in KPADS if kc <= p)
        fits = [r for r in RING_ROWS if r * kp <= THREADS and smem_bytes(nc, kp, r) <= smem]
        if fits:
            break
    else:
        raise ValueError(f"rows of {nc} do not fit the row sweep: {smem_bytes(nc, 4, 4)} bytes "
                         f"of shared memory for the least tile, {smem} on the device")
    units = groups * chunks
    per_launch = min(units, sms)
    ctas = max(1, min(sms // per_launch, -(-nc // 4)))
    slab = -(-nc // ctas)
    need = max(4, 1 << (slab - 1).bit_length())
    rows = next((r for r in fits if r <= need), fits[-1])
    return SweepPlan(groups, nr, nc, K, chunks, kc, kp, ctas, rows, per_launch)


def row_sweep_reference(Ws, nvals, svals, b):
    """Plain torch ops: x = A^{-1} b from stored inverses, b (..., K, nr,
    nc), in the dtype and on the device of the inputs. The right-hand sides
    ride as the last axis of each row's matmul, one matmul and two
    elementwise operations a row."""
    bl = b.movedim(-3, -1).contiguous()
    nr = bl.shape[-3]
    z = Ws[..., 0, :, :] @ bl[..., 0, :, :]
    zs = [z]
    for r in range(1, nr):
        z = Ws[..., r, :, :] @ (bl[..., r, :, :] - nvals[..., r, :, None] * z)
        zs.append(z)
    x = zs[-1]
    xs = [x]
    for r in range(nr - 2, -1, -1):
        x = zs[r] - Ws[..., r, :, :] @ (svals[..., r, :, None] * x)
        xs.append(x)
    return torch.stack(xs[::-1], dim=-3).movedim(-1, -3)


def check_inputs(Ws, nvals, svals, b):
    """Raise ``ValueError`` on anything the kernel does not take: other than
    complex64, not contiguous, not on one CUDA device, or shapes that do not
    match."""
    tensors = {"Ws": Ws, "nvals": nvals, "svals": svals, "b": b}
    for name, t in tensors.items():
        if t.dtype != torch.complex64:
            raise ValueError(f"the row-sweep kernel takes complex64 only; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the row-sweep kernel takes contiguous tensors; {name} is not")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != Ws.device:
            raise ValueError(f"no row-sweep kernel for {name} on {t.device} (Ws on {Ws.device})")
    if Ws.dim() < 3 or Ws.shape[-1] != Ws.shape[-2]:
        raise ValueError(f"Ws must be (..., nr, nc, nc), got {tuple(Ws.shape)}")
    lead, (nr, nc) = tuple(Ws.shape[:-3]), tuple(Ws.shape[-3:-1])
    for name, t in (("nvals", nvals), ("svals", svals)):
        if tuple(t.shape) != lead + (nr, nc):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {lead + (nr, nc)}")
    if b.dim() != Ws.dim() or tuple(b.shape[:-3]) != lead or tuple(b.shape[-2:]) != (nr, nc):
        raise ValueError(f"b has shape {tuple(b.shape)}, expected {lead + ('K', nr, nc)}")
    if max(nr, nc, b.shape[-3]) >= 2**31:
        raise ValueError(f"the kernel indexes rows, columns and right-hand sides with 32-bit ints")


@functools.lru_cache(maxsize=32)
def _check_layout(kp: int, nc: int, rows: int, device: torch.device):
    """Raise ``RuntimeError`` unless the built kernel asks for the shared
    memory that the planner counted and an SM holds one of its CTAs."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = _build.load().fdfd_rowsweep_layout(kp, nc, rows, out)
    if err != 0:
        raise RuntimeError(f"fdfd_rowsweep_layout failed: CUDA error {err}")
    if out[0] != smem_bytes(nc, kp, rows) or out[2] < 1:
        raise RuntimeError(
            f"row_sweep<{kp}> at nc {nc}, {rows}-row tiles asks for {out[0]} bytes of shared "
            f"memory (the planner counts {smem_bytes(nc, kp, rows)}) and fits {out[2]} CTAs an "
            f"SM: update ops/fdfd_rowsweep.py to match ops/csrc/fdfd_rowsweep.cu")


class _Tags:
    """One 64-bit slot a CTA, made once per device and stream; ``base``
    counts the tags they have carried, so every launch uses tags of its own
    and the slots are never cleared."""

    def __init__(self, n, device):
        self.slots = torch.zeros(n, dtype=torch.int64, device=device)
        self.base = 0


@functools.lru_cache(maxsize=16)
def _tags(device: torch.device, stream: int, n: int):
    return _Tags(n, device)


def launch(Ws, nvals, svals, b, x, exch, plan: SweepPlan, backward: bool, unit0: int):
    """One launch of one direction over units ``unit0`` onwards (as many as
    ``plan.per_launch`` allows). Raises ``RuntimeError`` when the runtime
    refuses it. Checks neither the inputs nor ``plan``: its callers do."""
    lib = _build.load()
    units = min(plan.per_launch, plan.units - unit0)
    stream = torch.cuda.current_stream(Ws.device).cuda_stream
    tags = _tags(Ws.device, stream, fdtd_fused.device_numbers(Ws.device)[0])
    with torch.cuda.device(Ws.device):
        err = lib.fdfd_rowsweep_run(
            Ws.data_ptr(), nvals.data_ptr(), svals.data_ptr(), b.data_ptr(), x.data_ptr(),
            exch.data_ptr(), tags.slots.data_ptr(), tags.base, int(backward), units, unit0,
            plan.ctas, plan.nr, plan.nc, plan.K, plan.kc, plan.chunks, plan.kp, plan.rows,
            stream)
    if err != 0:
        raise RuntimeError(f"fdfd_rowsweep_run refused {units * plan.ctas} CTAs "
                           f"({units} units of {plan.ctas}): CUDA error {err} "
                           f"({lib.fdtd_error_string(err).decode()})")
    tags.base += max(plan.nr - int(backward) - 1, 0)   # the launch's tags: one a step but the last
    count("fdfd.kernels.row_sweeps")


def row_sweep(Ws, nvals, svals, b):
    """x = A^{-1} b, b (..., K, nr, nc), by the row-sweep kernel: a new
    (..., K, nr, nc) tensor. CUDA complex64 contiguous tensors only; raises
    ``ValueError`` on anything else."""
    check_inputs(Ws, nvals, svals, b)
    x = torch.empty_like(b)
    if b.numel() == 0:
        return x
    nr, nc, K = Ws.shape[-3], Ws.shape[-1], b.shape[-3]
    sms, _, smem = fdtd_fused.device_numbers(Ws.device)
    plan = plan_row_sweep(math.prod(Ws.shape[:-3]), nr, nc, K, sms, smem)
    _check_layout(plan.kp, nc, plan.rows, Ws.device)
    exch = torch.empty(plan.per_launch * 2 * nc * plan.kp, dtype=torch.complex64,
                       device=Ws.device)
    # the launches run after this returns; freeing exch then is safe: the
    # caching allocator hands its memory only to work queued later on the stream
    for unit0 in range(0, plan.units, plan.per_launch):
        launch(Ws, nvals, svals, b, x, exch, plan, False, unit0)
        if nr > 1:
            launch(Ws, nvals, svals, b, x, exch, plan, True, unit0)
    return x
