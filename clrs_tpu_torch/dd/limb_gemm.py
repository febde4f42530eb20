"""Exact GEMM of f32 expansions through int8 limbs (batched).

Port of ``clrs_tpu/dd/limb_gemm.py::fx_matmul`` in its fused form: each
operand is scaled per row (A) or per column (B) by a power of two so its
value lies in [-1/2, 1/2], cut into L 7-bit limbs in [-65, 65]
(:func:`.kernels.limb_extract`), and the limb products are summed per
significance diagonal and cascaded into nw f32 words
(:func:`.kernels.limb_gemm`). Every step is exact IEEE f32, int8 or int32
arithmetic; the only losses are the final nw-word rounding and the
truncation below 2^-(24 nw + 21) of rowscale(A) * colscale(B).

The leading batch axis is written out: it replaces every
``jax.vmap(fx_matmul)`` of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels as K

LIMB_BITS = K.LIMB_BITS
# int32 diagonal sums stay exact: limb products <= 65^2 < 2^13, k <= 2^13
# terms, <= L <= 48 tiles per diagonal
MAX_K_EXACT = 1 << 13


def fx_matmul(a, b, nw=None, pre_a=None, pre_b=None):
    """Batched f32-expansion GEMM [B, m, k] @ [B, k, n] -> nw words [B, m, n].

    ``pre_a``/``pre_b`` = (int8 limbs [B, L, m, k] / [B, L, k, n], int32
    exps [B, m, 1] / [B, 1, n]) from :func:`host_precompute` (moved to the
    device) skip that operand's scaling and extraction; nw must then be
    given."""
    nw = nw or len(a if a is not None else b)
    if pre_a is None:
        Bt, m, k = a[0].shape
        dev = a[0].device
    else:
        Bt, _, m, k = pre_a[0].shape
        dev = pre_a[0].device
    n = b[0].shape[2] if pre_b is None else pre_b[0].shape[3]
    if k == 0 or m == 0 or n == 0:
        z = torch.zeros((Bt, m, n), dtype=torch.float32, device=dev)
        return (z,) * nw
    L, _ = K.limb_params(nw)
    if L > 48 or k > MAX_K_EXACT:
        raise ValueError(f"fx_matmul: L={L} > 48 or k={k} > {MAX_K_EXACT} "
                         "would overflow the exact int32 diagonal sums")
    if pre_a is None:
        A3, ea = K.limb_extract(a, L, "a")
    else:
        A3, ea = pre_a
    if pre_b is None:
        B3, eb = K.limb_extract(b, L, "b")
    else:
        B3, eb = pre_b
    if A3.shape[1] != L or B3.shape[1] != L:
        raise ValueError(f"fx_matmul: limb counts {A3.shape[1]}/"
                         f"{B3.shape[1]} do not match nw={nw} (L={L})")
    eab = (ea + eb).expand(Bt, m, n).contiguous()
    return K.limb_gemm(A3, B3, eab, nw)


# ---------------------------------------------------------------------------
# host-side limb forms of CONSTANT operands (numpy f32, IEEE: the same
# contract as the device extraction). Ported line for line from
# clrs_tpu/dd/limb_gemm.py:386-424, which imports JAX and so is not shared.
# ---------------------------------------------------------------------------

def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _np_two_sum(a, b):
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _np_vec_sum(cs):
    n = len(cs)
    out = [None] * n
    s = cs[n - 1]
    for i in range(n - 2, -1, -1):
        s, e = _np_two_sum(cs[i], s)
        out[i + 1] = e
    out[0] = s
    return out


def host_precompute(words, nw, axis):
    """Limb form of a constant operand: (int8 limbs [L, *shape], int32 exp
    keepdims-shaped). ``axis=1`` for a left operand (row exponents over K),
    ``axis=0`` for a right operand (column exponents)."""
    bits_needed = 24 * nw + 21
    L = _ceil_div(bits_needed, LIMB_BITS)
    ws = [np.asarray(w, np.float32) for w in words]
    mag = np.max(np.abs(ws[0]), axis=axis, keepdims=True)
    mag = np.where(mag == 0, np.float32(1.0), mag).astype(np.float32)
    e = (np.frexp(mag)[1]).astype(np.int32)     # mag = m * 2^e, m in [0.5,1)
    e = e + 1                                   # |v| <= 1/2 after scaling
    ws = [np.ldexp(c.astype(np.float64), -e).astype(np.float32) for c in ws]
    limbs = []
    for _ in range(L):
        ws = [c * np.float32(1 << LIMB_BITS) for c in ws]
        ws = _np_vec_sum(ws)
        d = np.rint(ws[0]).astype(np.float32)
        ws[0] = ws[0] - d
        limbs.append(d.astype(np.int8))
    return np.stack(limbs), e
