"""Builds the integrate kernel with ``nvcc`` and loads it with ``ctypes``.

One shared library per integrand set: ``csrc/integrate.cu`` includes the
integrand source that ``ops/lower.py`` generated.  Libraries are cached
under ``build/tpu_montecarlo_torch/`` at the repository root, keyed by the
sha256 of the sources and the flags, so a second process with the same
integrands loads the library without compiling.  The C entry points take
plain pointers and ints, so no PyTorch header is compiled (seconds, not
minutes).  Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "load_integrate_library"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_montecarlo_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3",
    "--fmad=false",
    "-std=c++17",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
_SOURCES = ("integrate.cu", "integrand_math.cuh")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernel cannot be built"
        )
    return found


def load_integrate_library(integrand_source: str) -> ctypes.CDLL:
    """Build (once) and load the kernel library for one integrand set.

    The returned library carries ``build_log`` (nvcc's register and spill
    report; empty when the library came from the cache)."""
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(integrand_source.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_DIR / h.hexdigest()[:24]
    so_path = out_dir / "libtmc_integrate.so"
    log = ""
    if not so_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "tmc_integrands.inc").write_text(integrand_source)
        tmp = out_dir / f"libtmc_integrate.{os.getpid()}.tmp"
        cmd = [
            _nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-I", str(out_dir),
            str(CSRC / "integrate.cu"), "-o", str(tmp),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}"
            )
        log = proc.stderr
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    lib.tmc_integrate.argtypes = [
        ctypes.c_int,       # kind
        ctypes.c_uint32,    # seed word
        ctypes.c_void_p,    # params (2,) float32 on the device
        ctypes.c_int,       # loops per program
        ctypes.c_longlong,  # tiles = programs * loops
        ctypes.c_int,       # CUDA grid size
        ctypes.c_void_p,    # partials (grid, K) float32
        ctypes.c_void_p,    # cudaStream_t
    ]
    lib.tmc_integrate.restype = ctypes.c_int
    lib.tmc_error_string.argtypes = [ctypes.c_int]
    lib.tmc_error_string.restype = ctypes.c_char_p
    lib.build_log = log
    return lib
