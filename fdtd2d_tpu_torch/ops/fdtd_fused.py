"""K1: fused multi-step FDTD — CUDA kernel wrapper, planner and plain versions.

Counterpart of ``fdtd2d_tpu/ops/pallas_fdtd.py``. The kernels are in
``ops/csrc/fdtd_fused.cu`` (its header comment gives the design and what
bounds each mode on the card). Two modes compute the same function:

- ``"resident"``: one cooperative launch for the whole call, each block
  holding one tile of the grid in its registers for all ``nsteps`` (the
  Hopper form of the TPU kernel's on-chip state). :func:`plan_resident` cuts
  the grid into tiles from the device's numbers, or raises ``ValueError``
  beyond what the card's SMs hold (1034^2 cells on an H100).
- ``"streaming"``: the fields in device memory, two launches a step; any grid.

The public entry point :func:`fdtd_multistep_fused` has the signature of
``fdtd_multistep_pallas`` and dispatches on the device of its tensors: a CPU
tensor goes to :func:`fdtd_multistep_fused_reference` (or, with
``mode="resident"``, to the tile emulation
:func:`fdtd_multistep_resident_reference`); a CUDA tensor launches a kernel or
raises — there is no fallback. With ``mode=None`` a CUDA call runs resident
where the planner admits the grid and streaming elsewhere.

All paths work on the padded (N, M) layout and return new tensors in the
staggered shapes; the caller's tensors are never modified.
:func:`advance_padded` is the same without the padding and unpadding, for
callers that keep the padded state across calls (``fdtd/simulate.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from fdtd2d_tpu_torch.core.sources import source_amplitudes
from fdtd2d_tpu_torch.fdtd.step import MUR_BAND, multistep
from fdtd2d_tpu_torch.ops import _build
from fdtd2d_tpu_torch.utils.trace import count

S = MUR_BAND + 1  # cells a Mur chain spans: the least a resident tile owns a side
MIN_SIDE = 16     # smallest grid side the kernels take
MODES = ("resident", "streaming")
# SMs, registers an SM and shared memory a block of an H100: the card the
# timings behind simulate's "auto" rule were taken on, and the numbers the
# CPU emulation plans with
H100 = (132, 65_536, 232_448)

# The planner's copy of resident_steps' layout in fdtd_fused.cu; every launch
# first holds it to what the built kernel reports (_check_layout). A block is
# 3 warps across and `warps_y` down; a thread holds `rows` cells of one window
# column in registers: Ez, Hx, Hy and, unless `coef_shared` parks them in
# shared memory, ce and ch.
WINDOW_COLS = 96
TILE_BYTES = 64      # the block's Tile struct in static shared memory
SM_RESERVED = 1024   # shared memory the system keeps of each resident block


@dataclasses.dataclass(frozen=True)
class Variant:
    index: int            # the library's number for it
    rows: int             # cells of one column a thread holds
    coef_shared: bool     # ce and ch in shared memory instead of registers
    warps_y: int          # warps down a window
    registers: int        # registers a thread, as ptxas built it

    @property
    def threads(self) -> int:
        return 96 * self.warps_y

    @property
    def window(self):
        """(rows, columns) of the window a block holds."""
        return self.warps_y * self.rows, WINDOW_COLS

    @property
    def static_smem(self) -> int:
        """The warps' exchange buffers (Ez and Hx rows of (warps_y + 1) x 96
        floats, Ez and Hy columns of (3 + 1) x window rows) and the Tile."""
        return 4 * (2 * (self.warps_y + 1) * WINDOW_COLS + 2 * 4 * self.window[0]) + TILE_BYTES

    @property
    def dynamic_smem(self) -> int:
        """Floats private to each thread: the pre-step Ez of its cells, for
        the Mur chains, and the parked ce and ch."""
        return 4 * self.rows * self.threads * (3 if self.coef_shared else 1)


VARIANTS = (Variant(0, 8, False, 5, 92), Variant(1, 8, True, 9, 72),
            Variant(2, 15, True, 6, 96))

# Kernel launches made by fdtd_multistep_fused and advance_padded are counted
# in utils/trace.py as "fdtd.kernels.k1" (one per call in resident mode, two per
# step in streaming mode), the resident ones also as "fdtd.kernels.k1_resident",
# and all in the layer's total "fdtd.kernels.launches". A run shows it went
# through the kernel by the counters' deltas.


@dataclasses.dataclass(frozen=True)
class ResidentPlan:
    variant: Variant
    nth: int  # tiles down
    ntw: int  # tiles across

    @property
    def blocks(self) -> int:
        return self.nth * self.ntw


def tile_bounds(n: int, nt: int):
    """``[(own0, own1), ...]``: the balanced cut of ``n`` cells into ``nt``
    tiles that ``resident_steps`` computes for itself."""
    return [(t * n // nt, (t + 1) * n // nt) for t in range(nt)]


def window_extent(n: int, nt: int) -> int:
    """The longest window along an axis: the largest tile and its ring (a
    tile at the domain's edge has no ring on that side)."""
    return -(-n // nt) + min(nt - 1, 2)


def coresident_blocks(variant: Variant, sms: int, registers: int, smem: int) -> int:
    """Blocks of ``variant`` that a device with ``sms`` SMs, ``registers``
    32-bit registers an SM and ``smem`` bytes of shared memory a block holds
    at once."""
    by_registers = registers // (variant.threads * variant.registers)
    by_smem = (smem + SM_RESERVED) // (variant.static_smem + variant.dynamic_smem + SM_RESERVED)
    return sms * min(by_registers, by_smem)


def check_resident_plan(N: int, M: int, plan: ResidentPlan, sms: int, registers: int,
                        smem: int):
    """Raise ``ValueError`` unless the resident kernel can run ``plan``."""
    WH, WW = plan.variant.window
    if plan.nth < 2 or plan.ntw < 2 or N // plan.nth < S or M // plan.ntw < S:
        raise ValueError(f"{plan.nth} x {plan.ntw} tiles on a {(N, M)} grid: there must be "
                         f"at least two tiles each way, each owning at least {S} cells "
                         f"a side")
    if window_extent(N, plan.nth) > WH or window_extent(M, plan.ntw) > WW:
        raise ValueError(f"{plan.nth} x {plan.ntw} tiles on a {(N, M)} grid exceed the "
                         f"{(WH, WW)} window of variant {plan.variant.index}")
    limit = coresident_blocks(plan.variant, sms, registers, smem)
    if plan.blocks > limit:
        raise ValueError(f"{plan.blocks} tiles, but only {limit} blocks can be resident "
                         f"at once: a {(N, M)} grid is beyond the resident mode")


@functools.lru_cache(maxsize=64)
def plan_resident(N: int, M: int, sms: int, registers: int, smem: int,
                  tiles=None) -> ResidentPlan:
    """The tile grid of the resident mode for an (N, M) grid on a device with
    ``sms`` SMs, ``registers`` registers an SM and ``smem`` bytes of shared
    memory a block: the first variant (fields and coefficients in
    registers) where its windows hold the grid in the blocks that can be
    resident, else the second. ``tiles`` = (nth, ntw) forces the tile grid.
    Raises ``ValueError`` beyond capacity."""
    if N < MIN_SIDE or M < MIN_SIDE:
        raise ValueError(f"grid {(N, M)} is smaller than {MIN_SIDE} a side")
    # the last refusal's text, not the exception: an exception kept in a local
    # of the frame its traceback holds is a cycle, and that cycle keeps every
    # caller's frame (a rollout's tensors) alive until the cyclic collector runs
    refusal = ""
    for variant in VARIANTS:
        if tiles is None:
            nth = next((nt for nt in range(2, N // S + 1)
                        if window_extent(N, nt) <= variant.window[0]), N)
            ntw = next((nt for nt in range(2, M // S + 1)
                        if window_extent(M, nt) <= variant.window[1]), M)
        else:
            nth, ntw = tiles
        plan = ResidentPlan(variant, nth, ntw)
        try:
            check_resident_plan(N, M, plan, sms, registers, smem)
            return plan
        except ValueError as e:
            refusal = str(e)
    raise ValueError(refusal)


@functools.lru_cache(maxsize=8)
def device_numbers(device: torch.device):
    """(SMs, registers an SM, shared memory a block may use) of a CUDA device."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = _build.load().fdtd_device_numbers(out)
    if err != 0:
        raise RuntimeError(f"fdtd_device_numbers failed: CUDA error {err}")
    return tuple(out)


def pad_field(a, N, M):
    """A new contiguous (N, M) tensor holding ``a`` at its top left, zero elsewhere."""
    out = a.new_zeros((N, M))
    out[: a.shape[0], : a.shape[1]] = a
    return out


def pad_state(Ez, Hx, Hy):
    """Pad staggered fields to a common (N, M) shape (phantom cells zero).
    Returns new contiguous tensors; ``Ez`` is copied too."""
    N, M = Ez.shape
    return pad_field(Ez, N, M), pad_field(Hx, N, M), pad_field(Hy, N, M)


def unpad_state(Ez, Hxp, Hyp):
    """Drop the phantom cells: views in the staggered shapes."""
    N, M = Ez.shape
    return Ez, Hxp[:, : M - 1], Hyp[: N - 1, :]


def fdtd_multistep_fused_reference(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy,
                                   nsteps: int, source_kind: str, step_offset: int):
    """Plain torch ops: ``nsteps`` x (fdtd_step_padded + source add) on the
    padded layout, in the dtype and on the device of ``Ez``."""
    N, M = Ez.shape
    Ez, Hxp, Hyp = pad_state(Ez, Hx, Hy)
    amps = source_amplitudes(source_kind, step_offset, nsteps, dt, fc,
                             Ez.dtype, Ez.device)
    multistep(Ez, Hxp, Hyp, ce, pad_field(ch, N, M), coef, amps, sx, sy)
    return unpad_state(Ez, Hxp, Hyp)


def fdtd_multistep_resident_reference(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy,
                                      nsteps: int, source_kind: str, step_offset: int,
                                      tiles=None):
    """Plain torch emulation of the resident tiling, in the dtype and on the
    device of ``Ez``. Each tile's window (its owned cells and a one-cell
    ring) is set into a zero grid, all tiles as one batch, once for the
    whole call. Per step the plain :func:`fdtd_step` runs on the batch; then
    the only exchange: each tile's ring Ez is taken from the tiles that own
    those cells. Hx and Hy of a window are never refreshed: the ring rows and
    columns recompute their neighbours' values, as the kernel's do. The
    band, corner and source stages of the plain step act in domain
    coordinates, so the tile that owns a band or corner applies it to its
    own cells. ``tiles`` = (nth, ntw) defaults to :func:`plan_resident`'s
    choice for an H100."""
    N, M = Ez.shape
    plan = plan_resident(N, M, *H100, tiles)
    fields = pad_state(Ez, Hx, Hy)
    chp = pad_field(ch, N, M)
    amps = source_amplitudes(source_kind, step_offset, nsteps, dt, fc,
                             Ez.dtype, Ez.device)
    rows, cols = tile_bounds(N, plan.nth), tile_bounds(M, plan.ntw)
    inside = torch.zeros((plan.blocks, N, M), dtype=torch.bool, device=Ez.device)
    owner = torch.empty((1, N, M), dtype=torch.long, device=Ez.device)
    for a, (r0, r1) in enumerate(rows):
        for b, (c0, c1) in enumerate(cols):
            t = a * plan.ntw + b
            inside[t, max(r0 - 1, 0) : r1 + 1, max(c0 - 1, 0) : c1 + 1] = True
            owner[0, r0:r1, c0:c1] = t
    owned = torch.zeros_like(inside).scatter_(0, owner, True)
    ring = inside & ~owned
    Et, Hxt, Hyt = (torch.where(inside, f, 0.0) for f in fields)
    for amp in amps:
        multistep(Et, Hxt, Hyt, ce, chp, coef, amp[None], sx, sy)
        published = Et.gather(0, owner)  # (1, N, M): every cell from its owner
        Et = torch.where(ring, published, Et)
    return unpad_state(*(t.gather(0, owner)[0] for t in (Et, Hxt, Hyt)))


def check_kernel_inputs(Ez, Hx, Hy, ce, ch, sx, sy, nsteps):
    """Raise ``ValueError`` on anything the kernel does not take."""
    N, M = Ez.shape
    tensors = {"Ez": Ez, "Hx": Hx, "Hy": Hy, "ce": ce, "ch": ch}
    for name, t in tensors.items():
        if t.device != Ez.device:
            raise ValueError(f"{name} is on {t.device}, Ez on {Ez.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"the CUDA kernels take float32 only; {name} is {t.dtype}")
    shapes = {"Hx": ((N, M - 1), (N, M)), "Hy": ((N - 1, M), (N, M)),
              "ce": ((N, M),), "ch": ((N - 1, M - 1), (N, M))}
    for name, allowed in shapes.items():
        if tuple(tensors[name].shape) not in allowed:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, "
                             f"expected one of {allowed} for Ez {(N, M)}")
    if N < MIN_SIDE or M < MIN_SIDE:
        raise ValueError(f"grid {(N, M)} is smaller than {MIN_SIDE} a side")
    if N * M >= 2**31:
        raise ValueError(f"grid {(N, M)} has 2^31 cells or more: the kernels "
                         "index a field with 32-bit ints")
    if not (0 <= sx < N and 0 <= sy < M):
        raise ValueError(f"source {(sx, sy)} lies outside the grid {(N, M)}")
    if nsteps < 0:
        raise ValueError(f"nsteps must be >= 0, got {nsteps}")
    if not ce.is_contiguous():
        raise ValueError("ce must be contiguous")


@functools.lru_cache(maxsize=8)
def _check_layout(variant: Variant, device: torch.device):
    """Raise ``RuntimeError`` unless the built kernel's shared memory, window,
    threads and registers for ``variant``, and the blocks that ``device``
    holds resident at once, are those the planner plans with."""
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        err = _build.load().fdtd_fused_resident_layout(variant.index, out)
    if err != 0:
        raise RuntimeError(f"fdtd_fused_resident_layout failed: CUDA error {err}")
    planned = (variant.static_smem, variant.dynamic_smem, *variant.window, variant.threads,
               variant.registers, coresident_blocks(variant, *device_numbers(device)))
    if tuple(out) != planned:
        raise RuntimeError(
            f"resident_steps' layout (static, dynamic shared memory, window rows, "
            f"columns, threads, registers, resident blocks) is {tuple(out)}, the "
            f"planner's {planned}: update ops/fdtd_fused.py to match "
            f"ops/csrc/fdtd_fused.cu")


class _Scratch:
    """The exchange rows and columns of one plan on one stream (64-bit
    words: a value and the tag of its step), made once; ``base`` counts the
    steps they have carried, so that every launch uses tags of its own."""

    def __init__(self, N, M, plan, device):
        self.rows = torch.zeros(2 * 2 * plan.nth * M, dtype=torch.int64, device=device)
        self.cols = torch.zeros(2 * 2 * plan.ntw * N, dtype=torch.int64, device=device)
        self.base = 0


@functools.lru_cache(maxsize=16)
def _scratch(N: int, M: int, plan: ResidentPlan, device: torch.device, stream: int):
    return _Scratch(N, M, plan, device)


def launch_resident(Ezp, Hxp, Hyp, ce, chp, amps, sx, sy, coef, plan: ResidentPlan):
    """One cooperative launch of ``resident_steps`` over ``len(amps)`` >= 1
    steps on padded contiguous CUDA tensors; returns new padded tensors.
    Raises ``RuntimeError`` when the runtime refuses the launch. Counts
    nothing and does not check ``plan`` against the device: its callers do."""
    lib = _build.load()
    N, M = Ezp.shape
    out = tuple(torch.empty_like(f) for f in (Ezp, Hxp, Hyp))
    stream = torch.cuda.current_stream(Ezp.device).cuda_stream
    scratch = _scratch(N, M, plan, Ezp.device, stream)
    nsteps = amps.shape[0]
    with torch.cuda.device(Ezp.device):
        err = lib.fdtd_fused_resident_run(
            Ezp.data_ptr(), Hxp.data_ptr(), Hyp.data_ptr(), ce.data_ptr(), chp.data_ptr(),
            amps.data_ptr(), *(f.data_ptr() for f in out), scratch.rows.data_ptr(),
            scratch.cols.data_ptr(), scratch.base, N, M,
            plan.nth, plan.ntw, plan.variant.index, nsteps, int(sx), int(sy), float(coef),
            stream)
    if err != 0:
        raise RuntimeError(f"fdtd_fused_resident_run refused {plan.blocks} blocks of variant "
                           f"{plan.variant.index}: CUDA error {err} "
                           f"({lib.fdtd_error_string(err).decode()})")
    scratch.base = (scratch.base + nsteps) % 2**32
    return out


def resolve_mode(N: int, M: int, device: torch.device, mode=None, tiles=None):
    """``(mode, plan)`` for a CUDA call: ``plan`` is the resident tile grid
    or None for streaming. ``mode=None`` takes resident where the planner
    admits the grid; ``mode="resident"`` raises ``ValueError`` where not."""
    if mode not in (None, *MODES):
        raise ValueError(f"unknown K1 mode {mode!r}; expected one of {MODES}")
    if mode == "streaming":
        return mode, None
    try:
        plan = plan_resident(N, M, *device_numbers(device), tiles)
    except ValueError:
        if mode == "resident":
            raise
        return "streaming", None
    return "resident", plan


def advance_padded(Ezp, Hxp, Hyp, ce, chp, coef, dt, fc, sx, sy, nsteps: int,
                   source_kind: str, step_offset: int, mode=None, tiles=None, amps=None):
    """:func:`fdtd_multistep_fused` on padded contiguous (N, M) tensors,
    returning new padded tensors: no pad copy going in, no view coming out.
    CPU tensors take the plain version (the tile emulation with
    ``mode="resident"``). ``amps``, where given, are the call's ``nsteps``
    source amplitudes (``source_amplitudes(source_kind, step_offset, nsteps,
    ...)``, float32 on the device), which a caller of many short calls
    computes once for all of them."""
    if Ezp.device.type == "cpu":
        if mode == "resident":
            out = fdtd_multistep_resident_reference(Ezp, Hxp, Hyp, ce, chp, coef, dt, fc, sx,
                                                    sy, nsteps, source_kind, step_offset, tiles)
        else:
            out = fdtd_multistep_fused_reference(Ezp, Hxp, Hyp, ce, chp, coef, dt, fc, sx, sy,
                                                 nsteps, source_kind, step_offset)
        return pad_state(*out)
    if Ezp.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {Ezp.device}")
    check_kernel_inputs(Ezp, Hxp, Hyp, ce, chp, sx, sy, nsteps)
    N, M = Ezp.shape
    for name, t in (("Ez", Ezp), ("Hx", Hxp), ("Hy", Hyp), ("ch", chp)):
        if tuple(t.shape) != (N, M) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous padded {(N, M)} tensor")
    mode, plan = resolve_mode(N, M, Ezp.device, mode, tiles)
    if nsteps == 0:
        return Ezp.clone(), Hxp.clone(), Hyp.clone()
    lib = _build.load()
    if amps is None:
        amps = source_amplitudes(source_kind, step_offset, nsteps, dt, fc,
                                 torch.float32, Ezp.device)
    elif (amps.shape != (nsteps,) or amps.dtype != torch.float32 or amps.device != Ezp.device
          or not amps.is_contiguous()):
        raise ValueError(f"amps must hold {nsteps} contiguous float32 values on {Ezp.device}")
    # The launches run after this function returns. Freeing amps (and the
    # inputs) then is safe: the caching allocator hands their memory only to
    # work queued later on the same stream.
    if mode == "resident":
        _check_layout(plan.variant, Ezp.device)
        out = launch_resident(Ezp, Hxp, Hyp, ce, chp, amps, sx, sy, coef, plan)
        _count_launches(1, resident=True)
        return out
    out = Ezp.clone(), Hxp.clone(), Hyp.clone()
    with torch.cuda.device(Ezp.device):
        err = lib.fdtd_fused_run(
            *(f.data_ptr() for f in out), ce.data_ptr(), chp.data_ptr(), amps.data_ptr(),
            N, M, nsteps, int(sx), int(sy), float(coef),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fdtd_fused_run failed: CUDA error {err} "
                           f"({lib.fdtd_error_string(err).decode()})")
    _count_launches(2 * nsteps)
    return out


def _count_launches(n: int, resident: bool = False):
    count("fdtd.kernels.launches", n)
    count("fdtd.kernels.k1", n)
    if resident:
        count("fdtd.kernels.k1_resident", n)


def fdtd_multistep_fused(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy,
                         nsteps: int, source_kind: str, step_offset: int,
                         mode=None, tiles=None):
    """Advance ``nsteps`` steps from global step ``step_offset``.

    Standard staggered shapes in and out (the padded layout is accepted too,
    and then nothing is copied going in). CPU tensors run the plain version,
    or the resident tile emulation with ``mode="resident"``; CUDA tensors run
    a K1 kernel, which takes float32 only and raises on anything else:
    ``mode`` is ``"resident"``, ``"streaming"`` or None (resident where the
    grid fits the card's SMs); ``tiles`` = (nth, ntw) forces the resident
    tile grid.
    """
    if Ez.device.type == "cpu":
        if mode not in (None, *MODES):
            raise ValueError(f"unknown K1 mode {mode!r}; expected one of {MODES}")
        if mode == "resident":
            return fdtd_multistep_resident_reference(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy,
                                                     nsteps, source_kind, step_offset, tiles)
        return fdtd_multistep_fused_reference(Ez, Hx, Hy, ce, ch, coef, dt, fc,
                                              sx, sy, nsteps, source_kind,
                                              step_offset)
    if Ez.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {Ez.device}")
    check_kernel_inputs(Ez, Hx, Hy, ce, ch, sx, sy, nsteps)
    N, M = Ez.shape

    def padded(a):
        return a if tuple(a.shape) == (N, M) and a.is_contiguous() else pad_field(a, N, M)

    out = advance_padded(padded(Ez), padded(Hx), padded(Hy), ce, padded(ch), coef, dt, fc,
                         sx, sy, nsteps, source_kind, step_offset, mode, tiles)
    return unpad_state(*out)
