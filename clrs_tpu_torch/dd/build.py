"""Build and load the CUDA kernels (``clrs_tpu_torch/csrc``).

``nvcc`` compiles the sources into one shared library with a plain C
interface at first use, into ``build/kernels/`` beside the package (listed
in ``.gitignore``); ctypes loads it. The library's name carries a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is reused. Nothing here runs at import time: the CPU tests import every
module, and this machine may have no nvcc.

The flags keep the error-free transforms exact: ``-fmad=false`` (no FMA
contraction), IEEE division and square root, and no flush of subnormals;
never ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("kernels.cu",)
HEADERS = ("expansion.cuh",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-prec-div=true", "-prec-sqrt=true", "-ftz=false"]

_LIB = None
build_seconds = None      # wall seconds of the last build (None: reused)


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit required)")


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _declare(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.clrs_error_string.argtypes = [i]
    lib.clrs_error_string.restype = ctypes.c_char_p
    lib.clrs_limb_extract.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
    lib.clrs_limb_gemm.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.clrs_chol.argtypes = [vp, vp, vp, i, i, i, vp]
    lib.clrs_tri_solve.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
    for fn in (lib.clrs_limb_extract, lib.clrs_limb_gemm, lib.clrs_chol,
               lib.clrs_tri_solve):
        fn.restype = i
    return lib


def build(verbose=False):
    """Compile the kernels if this source digest has no library yet;
    returns the library path."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libclrs_kernels_{_digest()}.so"
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.time() - t0
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr[-8000:]}")
    (BUILD_DIR / "ptxas.log").write_text(r.stderr)
    if verbose:
        print(r.stderr)
    os.replace(tmp, out)
    return out


def library():
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        _LIB = _declare(ctypes.CDLL(str(build())))
    return _LIB
