"""Native (C++) kernels for the host-side exact-arithmetic layer.

The reference's exact path is FLINT C code reached through Nemo
(SURVEY.md section 2.9); this package holds the equivalent native kernels
for the Python framework. Kernels are built on first use with the system
g++ (no network, no pip deps) and loaded through ctypes; every caller has a
pure-Python fallback, so a missing compiler only costs speed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_OUT = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build(src: str, out: str) -> bool:
    # several processes may build at once: each writes its own file and
    # renames it into place, so none loads another's half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        os.makedirs(_OUT, exist_ok=True)
        r = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", src, "-o", tmp],
            capture_output=True, timeout=120)
        if r.returncode == 0 and os.path.exists(tmp):
            os.replace(tmp, out)
        return r.returncode == 0 and os.path.exists(out)
    except (OSError, subprocess.TimeoutExpired):
        return False


def get_lib():
    """The loaded shared library, or None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = os.path.join(_OUT, "librref_modp.so")
        src = os.path.join(_DIR, "rref_modp.cpp")
        if not os.path.exists(so) or (os.path.exists(src)
                                      and os.path.getmtime(src) > os.path.getmtime(so)):
            if not _build(src, so):
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.rref_mod_p_u64.restype = ctypes.c_int64
        lib.rref_mod_p_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_int64)]
        lib.matvec_mod_p_u64.restype = None
        lib.matvec_mod_p_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64)]
        _LIB = lib
        return _LIB
