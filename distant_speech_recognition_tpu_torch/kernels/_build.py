"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface (``csrc/dsr_kernels.h``), which is
loaded with ctypes.  The library lands in the package's ``build/``
directory under a name that carries a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is reused.  Nothing here runs
when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "SOURCES", "nvcc_path", "build", "library", "check"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = (
    "analysis_tm.cu", "gsc_rls_zelinski.cu", "synthesis_tm.cu",
    "aec_scan.cu", "wpe_stats.cu", "wpe_resid.cu", "gj_solve.cu",
    "zelinski_apply.cu", "fw_mono.cu", "gsc_mono.cu", "polyphase_fir.cu", "gsc_lms_zelinski.cu",
    "coherence_postfilter.cu", "fastdiv_check.cu",
)
HEADERS = ("dsr_kernels.h", "dsr_device.h", "dsr_fft.h", "gsc_step.h", "gsc_scan.h")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "dsr_analysis_tm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "dsr_analysis_tm_dense": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "dsr_synthesis_tm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "dsr_synthesis_tm_rows": [_I],
    "dsr_gsc_rls_zelinski": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _F, _F, _F, _F, _F, _F, _F, _F, _I, _F, _F, _I, _F, _F, _F, _F, _I, _I, _P,
    ],
    "dsr_gsc_rls_zelinski_steered": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _F, _F, _F, _F, _F, _F, _F, _F, _I, _F, _F, _I, _F, _F, _F, _F, _I, _I, _P,
    ],
    "dsr_gsc_rls_zelinski_energy_floats": [_I, _I, _I],
    "dsr_gsc_rls_zelinski_shape": [_I, _I, _I, _P, _P, _P, _P, _P, _P],
    "dsr_lms_gates": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P],
    "dsr_gsc_lms_zelinski": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _F, _F, _F, _F, _F, _F, _F, _I, _I, _F, _F, _F, _F, _I, _I, _P,
    ],
    "dsr_gsc_lms_zelinski_steered": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _F, _F, _F, _F, _F, _F, _F, _I, _I, _F, _F, _F, _F, _I, _I, _P,
    ],
    "dsr_gsc_lms_zelinski_args_ok": [_I, _I, _I, _I, _I, _I],
    "dsr_gsc_lms_zelinski_shape": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "dsr_fastdiv_check": [_P, _P, _P, _P, _I, _I, _P],
    "dsr_zelinski_apply": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _P],
    "dsr_zelinski_apply_steered": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _P],
    "dsr_zelinski_apply_shape": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "dsr_coherence_postfilter": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P,
    ],
    "dsr_fw_mono": [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _F, _F, _F, _F, _I, _I, _P,
    ],
    "dsr_gsc_mono": [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _F, _F, _F, _F, _F, _F, _F, _F, _I, _F, _F, _I, _F, _F, _F, _F, _I, _I, _P,
    ],
    "dsr_gsc_analysis": [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _F, _F, _F, _F, _F, _F, _F, _F, _I, _F, _F, _I, _F, _F, _F, _F, _I, _I, _P,
    ],
    "dsr_gsc_mono_occupancy": [_I, _I, _I, _P, _P],
    "dsr_polyphase_fir": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "dsr_aec_scan": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P],
    "dsr_aec_scan_block_kalman": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P],
    "dsr_aec_scan_shape": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "dsr_wpe_stats": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "dsr_wpe_resid": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dsr_wpe_stats_occupancy": [_I, _I, _I, _P, _P, _P],
    "dsr_wpe_resid_occupancy": [_I, _I, _I, _I, _P, _P, _P],
    "dsr_gj_solve": [_P, _P, _P, _I, _I, _P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if no library for the current sources exists;
    return the library's path.  The compiler's report (registers, shared
    memory, spills per kernel) is kept in `build_log`."""
    global build_log
    out = BUILD_DIR / f"libdsr_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", obj, str(CSRC_DIR / s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, obj in zip(SOURCES, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        lib = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, "-shared", "-o", lib, *objs], capture_output=True, text=True)
        build_log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{build_log}")
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.dsr_error_string.argtypes = [ctypes.c_int]
            lib.dsr_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported an error."""
    if code != 0:
        msg = library().dsr_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (code {code})")
