"""K1: fused multi-step FDTD — CUDA kernel wrapper and its plain version.

Counterpart of ``fdtd2d_tpu/ops/pallas_fdtd.py``. The kernel is
``ops/csrc/fdtd_fused.cu`` (its header comment gives the design and the
bound on the card). The public entry point :func:`fdtd_multistep_fused` has
the signature of ``fdtd_multistep_pallas`` and dispatches on the device of
its tensors: a CPU tensor goes to :func:`fdtd_multistep_fused_reference`; a
CUDA tensor launches the kernel or raises — there is no fallback.

Both paths work on the padded (N, M) layout and return new tensors in the
staggered shapes; the caller's tensors are never modified.
"""

from __future__ import annotations

import torch

from fdtd2d_tpu_torch.core.sources import source_amplitudes
from fdtd2d_tpu_torch.fdtd.step import MUR_BAND, multistep
from fdtd2d_tpu_torch.ops import _build

S = MUR_BAND + 1  # width of each saved pre-step Ez strip
MIN_SIDE = 16     # smallest grid side the kernel takes

# Kernel launches made by fdtd_multistep_fused (three per step); a run
# shows it went through the kernel by reading this before and after.
launches = 0


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


def fdtd_multistep_fused(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy,
                         nsteps: int, source_kind: str, step_offset: int):
    """Advance ``nsteps`` steps from global step ``step_offset``.

    Standard staggered shapes in and out (the padded layout is accepted too).
    CPU tensors run the plain version; CUDA tensors run the K1 kernel, which
    takes float32 only and raises on anything else.
    """
    global launches
    if Ez.device.type == "cpu":
        return fdtd_multistep_fused_reference(Ez, Hx, Hy, ce, ch, coef, dt, fc,
                                              sx, sy, nsteps, source_kind,
                                              step_offset)
    if Ez.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {Ez.device}")
    check_kernel_inputs(Ez, Hx, Hy, ce, ch, sx, sy, nsteps)
    lib = _build.load()
    N, M = Ez.shape
    Ez, Hxp, Hyp = pad_state(Ez, Hx, Hy)
    chp = pad_field(ch, N, M)
    amps = source_amplitudes(source_kind, step_offset, nsteps, dt, fc,
                             torch.float32, Ez.device)
    strips = torch.empty(2 * N * S + 2 * S * M, dtype=torch.float32, device=Ez.device)
    # The launches run after this function returns. Freeing amps, strips and
    # chp then is safe: the caching allocator hands their memory only to work
    # queued later on the same stream.
    with torch.cuda.device(Ez.device):
        err = lib.fdtd_fused_run(
            Ez.data_ptr(), Hxp.data_ptr(), Hyp.data_ptr(), ce.data_ptr(),
            chp.data_ptr(), amps.data_ptr(), strips.data_ptr(), N, M, nsteps,
            int(sx), int(sy), float(coef), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fdtd_fused_run failed: CUDA error {err} "
                           f"({lib.fdtd_error_string(err).decode()})")
    launches += 3 * nsteps
    return unpad_state(Ez, Hxp, Hyp)
