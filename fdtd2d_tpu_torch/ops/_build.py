"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

The sources in ``ops/csrc/`` are compiled for Hopper (``sm_90a``) into one
shared library with a plain C interface, at the first call that needs it,
never at import: one nvcc per ``.cu`` file, all started together, then one
link. The library goes to ``build/kernels/<hash>/`` at the root of the
checkout (listed in ``.gitignore``), keyed by a hash of the sources and the
flags, so an edited source rebuilds. There is no fallback: a missing nvcc or
a failed build raises ``RuntimeError`` with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libfdtd2d_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def find_nvcc() -> str:
    """nvcc on PATH, else ``$CUDA_HOME/bin/nvcc`` (default /usr/local/cuda)."""
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(home, "bin", "nvcc")
        if os.access(candidate, os.X_OK):
            path = candidate
    if path is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
            "kernels of fdtd2d_tpu_torch must be built on a machine with the "
            "CUDA toolkit")
    return path


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_logged(cmd, log: Path) -> subprocess.Popen:
    """Start ``cmd`` with its output going to ``log``; return the process."""
    with open(log, "w") as out:
        return subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)


def build() -> Path:
    """Compile the kernels if this version of the sources is not built yet;
    return the library's path. nvcc's report (``-Xptxas -v``: registers,
    shared memory, spills per kernel) is kept beside it as ``build.log``."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    out_dir = BUILD_DIR / _digest(sources)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    units = [s for s in sources if s.suffix == ".cu"]
    objects = [out_dir / f"{s.stem}.{tag}.o" for s in units]
    logs = [out_dir / f"{s.stem}.{tag}.log" for s in units]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in zip(units, objects)]
    procs = [_run_logged(cmd, log) for cmd, log in zip(cmds, logs)]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{log.read_text()}")
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    (out_dir / "build.log").write_text("".join(log.read_text() for log in logs))
    for path in (*objects, *logs):
        path.unlink()
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


def load() -> ctypes.CDLL:
    """Build if needed, load the library once and declare its C signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fdtd_fused_run.argtypes = [p, p, p, p, p, p,      # ez hx hy ce ch amp
                                       i, i, i, i, i,         # N M nsteps sx sy
                                       f, p]                  # coef stream
        lib.fdtd_fused_run.restype = i
        lib.fdtd_fused_resident_run.argtypes = [
            p, p, p, p, p, p,          # ez hx hy (inputs) ce ch amp
            p, p, p, p, p,             # ez hx hy (outputs) rows cols
            ctypes.c_uint,             # base
            i, i, i, i, i, i, i, i,    # N M nth ntw variant nsteps sx sy
            f, p]                      # coef stream
        lib.fdtd_fused_resident_run.restype = i
        lib.fdtd_fused_resident_layout.argtypes = [i, ctypes.POINTER(i)]  # variant out[7]
        lib.fdtd_fused_resident_layout.restype = i
        lib.fdtd_device_numbers.argtypes = [ctypes.POINTER(i)]            # out[3]
        lib.fdtd_device_numbers.restype = i
        lib.fdtd_ttiled_run.argtypes = [p, p, p, p, p, p,     # ez hx hy: a, then b
                                        p, p, p, p, i, p,     # ce ch amp tiles n_tiles counters
                                        i, i, i,              # N M ldg
                                        i, i, i, i,           # r_lo r_hi c_lo c_hi
                                        i, i, i, i,           # ar ac AN AM
                                        i, i, i, i,           # TH TW K nsteps
                                        i, i, i, i,           # WH WW sx sy
                                        f, p]                 # coef stream
        lib.fdtd_ttiled_run.restype = i
        lib.fdtd_ttiled_layout.argtypes = [i, i, ctypes.POINTER(i)]  # WH WW out[4]
        lib.fdtd_ttiled_layout.restype = i
        lib.fdfd_rowsweep_run.argtypes = [p, p, p, p, p,                # W nv sv b x
                                          p, p, ctypes.c_ulonglong,     # exch tags base
                                          i, i, i, i,                   # backward units unit0 ctas
                                          i, i, i, i, i, i, i,          # nr nc K kc chunks kp tr
                                          p]                            # stream
        lib.fdfd_rowsweep_run.restype = i
        lib.fdfd_rowsweep_layout.argtypes = [i, i, i, ctypes.POINTER(i)]  # kp nc tr out[3]
        lib.fdfd_rowsweep_layout.restype = i
        lib.fdfd_residual_pass.argtypes = [p, p, p, p, p, p,     # x b eps imu isr isc
                                           p, p, p,              # omega inv_2dx inv_2dy
                                           p, p, p,              # partials norms out
                                           i, i, i,              # B Nx Ny
                                           p]                    # stream
        lib.fdfd_residual_pass.restype = i
        lib.fdfd_residual_norms.argtypes = [p, p, p, i, i, i, p]  # b partials norms B Nx Ny stream
        lib.fdfd_residual_norms.restype = i
        lib.fdfd_refine_update.argtypes = [p, p, p, i, i, p]   # x d norms B per_sample stream
        lib.fdfd_refine_update.restype = i
        ll = ctypes.c_longlong
        lib.fdfd_hps_level_run.argtypes = [i, i, p, p, p, p,           # down kp Y E table order
                                           p, ll, ll, ll, i,           # child: ptr g p k held
                                           p, p, i,                    # parent g y_t
                                           i, i, i, i, i, i,           # items P nJ nR tc ni
                                           p]                          # stream
        lib.fdfd_hps_level_run.restype = i
        lib.fdfd_hps_level_layout.argtypes = [i, i, i, i, ctypes.POINTER(i)]  # down kp tc ni out[3]
        lib.fdfd_hps_level_layout.restype = i
        lib.fdtd_error_string.argtypes = [i]
        lib.fdtd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
