"""Builds the port's kernels with ``nvcc`` and loads them with ``ctypes``.

One shared library per (kernel source, integrand set): each kernel
source in ``csrc/`` includes the integrand source that ``ops/lower.py``
generated.  Libraries are cached under ``build/tpu_montecarlo_torch/`` at
the repository root, keyed by the sha256 of that kernel source, the
shared headers, the integrands and the flags, so each kernel caches on
its own and a second process with the same integrands loads the library
without compiling.  The C entry points take plain pointers and ints, so
no PyTorch header is compiled (seconds, not minutes).  Nothing is built
when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "load_kernel_library"]

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
# Headers every kernel source may include.
_HEADERS = (
    "counter_rng.cuh", "hmc_move.cuh", "integrand_math.cuh",
    "integrate_draw.cuh", "log_pdf_grad.cuh", "mcmc_nd_common.cuh",
    "mcmc_pipeline.cuh", "rows_sum.cuh", "sobol.cuh",
)


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


def load_kernel_library(source: str, integrand_source: str,
                        defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<source>`` (or ``source``, an absolute
    path) for one integrand set, with ``defines`` (``"NAME=VALUE"``)
    passed to nvcc as ``-D`` flags.

    Every library exports ``tmc_error_string``; the caller declares the
    argument types of its own entry points.  The returned library carries
    ``build_log`` (nvcc's register and spill report; empty when the
    library came from the cache)."""
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    h = hashlib.sha256()
    for name in (source, *_HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(integrand_source.encode())
    h.update(" ".join(flags).encode())
    out_dir = BUILD_DIR / h.hexdigest()[:24]
    stem = Path(source).stem
    so_path = out_dir / f"libtmc_{stem}.so"
    log = ""
    if not so_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "tmc_integrands.inc").write_text(integrand_source)
        # Unique per process and thread: two threads may build one library.
        tmp = out_dir / (
            f"libtmc_{stem}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [
            _nvcc(), *flags, "-I", str(CSRC), "-I", str(out_dir),
            str(CSRC / source), "-o", str(tmp),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} ({proc.returncode}):\n{proc.stderr}"
            )
        log = proc.stderr
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    lib.tmc_error_string.argtypes = [ctypes.c_int]
    lib.tmc_error_string.restype = ctypes.c_char_p
    lib.build_log = log
    return lib
