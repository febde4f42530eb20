"""Build and load the CUDA kernels (``clrs_tpu_torch/csrc``).

``nvcc`` compiles each source into an object, all of them at once, and
links them into one shared library with a plain C interface at first use,
into ``build/kernels/`` beside the package (listed in ``.gitignore``);
ctypes loads it. The library's name carries a hash of
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
from pathlib import Path

from .. import tracing

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("kernels.cu", "limb_gemm.cu", "int8_gemm.cu", "chol.cu", "expmap.cu",
           "exptree.cu", "expfuse.cu", "expf64.cu", "eig.cu", "graphwalk.cu")
HEADERS = ("expansion.cuh", "common.cuh", "limbs.cuh", "expview.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false",
              "-prec-div=true", "-prec-sqrt=true", "-ftz=false"]

_LIB = None
build_seconds = None      # the last build's span ``kernels.build`` (None: reused)


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
    lib.clrs_limb_extract.argtypes = [ctypes.POINTER(vp),
                                      ctypes.POINTER(ctypes.c_longlong), vp,
                                      vp, i, i, i, i, i, i, i, vp]
    lib.clrs_limb_gemm.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.clrs_chol.argtypes = [vp, vp, vp, i, i, i, vp]
    lib.clrs_tri_solve.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, vp]
    lib.clrs_int8_gemm.argtypes = [vp, vp, vp, i, i, i, i, vp]
    lib.clrs_cascade.argtypes = [vp, vp, vp, i, i, i, i, i, i, vp]
    lib.clrs_plmap.argtypes = [i, ctypes.POINTER(vp),
                               ctypes.POINTER(ctypes.c_longlong),
                               ctypes.POINTER(i), vp, i, i, i, i, i, vp]
    ll = ctypes.c_longlong
    lib.clrs_expmap.argtypes = [i, ctypes.POINTER(vp), ctypes.POINTER(ll),
                                ctypes.POINTER(i), ctypes.POINTER(i), i, vp,
                                ll, i, vp]
    f = ctypes.c_float
    lib.clrs_tree_sum.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ll),
                                  ctypes.POINTER(i), vp, ctypes.POINTER(ll),
                                  f, i, ctypes.POINTER(i), i, i, vp, ll, ll,
                                  ll, i, i, i, i, i, i, i, i, i, vp]
    lib.clrs_expfuse.argtypes = [i, ctypes.POINTER(vp), ctypes.POINTER(ll),
                                 ctypes.POINTER(i), vp, ctypes.POINTER(ll), f,
                                 i, vp, ctypes.POINTER(ll), ctypes.POINTER(vp),
                                 ctypes.POINTER(ll), ctypes.POINTER(i), i, ll,
                                 i, vp]
    lib.clrs_expselect.argtypes = [vp, ctypes.POINTER(vp), ctypes.POINTER(vp),
                                   ctypes.POINTER(ll), i, i, vp]
    lib.clrs_expf64.argtypes = [i, ctypes.POINTER(vp), ctypes.POINTER(ll), i,
                                vp, ctypes.POINTER(ll), vp, ctypes.POINTER(i),
                                i, vp, ll, i, i, vp]
    lib.clrs_eig_scratch.argtypes = [i, i]
    lib.clrs_eig_scratch.restype = ll
    lib.clrs_eig_lowest.argtypes = [vp, vp, vp, i, i, vp]
    lib.clrs_eig_pairs.argtypes = [vp, vp, vp, i, i, vp]
    lib.clrs_eig_pairs_vec.argtypes = [vp, vp, i, i, vp]
    lib.clrs_graph_phase_nodes.argtypes = [vp, ctypes.POINTER(vp), i,
                                           ctypes.POINTER(ll)]
    for fn in (lib.clrs_limb_extract, lib.clrs_limb_gemm, lib.clrs_chol,
               lib.clrs_tri_solve, lib.clrs_int8_gemm, lib.clrs_cascade,
               lib.clrs_plmap, lib.clrs_expmap, lib.clrs_tree_sum,
               lib.clrs_expfuse, lib.clrs_expselect, lib.clrs_expf64,
               lib.clrs_eig_lowest,
               lib.clrs_eig_pairs, lib.clrs_eig_pairs_vec,
               lib.clrs_graph_phase_nodes):
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
    with tracing.span("kernels.build") as sp:
        tmp, log = _compile(out)
    build_seconds = sp.ns / 1e9
    tracing.count("kernels.builds")
    if verbose:
        print(log)
    os.replace(tmp, out)
    return out


def _compile(out):
    """nvcc: every source into an object at once, then the link into a
    temporary file beside ``out``: (its path, the ``-Xptxas -v`` log, also
    written to ``ptxas.log``)."""
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    errs = [o.with_suffix(".log") for o in objs]
    procs = []
    for s, o, e in zip(SOURCES, objs, errs):   # one nvcc per source, at once
        with open(e, "w") as f:
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(o),
                 str(CSRC / s)], stdout=f, stderr=subprocess.STDOUT))
    rcs = [p.wait() for p in procs]
    logs = [f"== {s}\n{e.read_text()}" for s, e in zip(SOURCES, errs)]
    for e in errs:
        e.unlink()
    for s, rc, log in zip(SOURCES, rcs, logs):
        if rc != 0:
            raise RuntimeError(f"nvcc failed on {s} ({rc}):\n{log[-8000:]}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                       capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                           f"{r.stderr[-8000:]}")
    log = "\n".join(logs)
    (BUILD_DIR / "ptxas.log").write_text(log)
    return tmp, log


def library():
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        _LIB = _declare(ctypes.CDLL(str(build())))
    return _LIB
