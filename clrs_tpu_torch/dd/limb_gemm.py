"""Exact GEMM of f32 expansions through int8 limbs (batched).

Port of ``clrs_tpu/dd/limb_gemm.py::fx_matmul`` with the JAX package's TPU
routing: each operand is scaled per row (A) or per column (B) by a power
of two so its value lies in [-1/2, 1/2], cut into L 7-bit limbs in
[-65, 65] (:func:`.kernels.limb_extract`), and the limb products are summed
per significance diagonal and cascaded into nw f32 words, on one of two
routes:

- **fused** (:func:`.kernels.limb_gemm`): products, diagonal sums and
  cascade in one kernel, so the int32 product never exists in memory;
- **split**: limbs in the GEMM layouts, one int8 GEMM for the whole int32
  product C [B, L m, L n] (:func:`.kernels.int8_gemm`), then the diagonal
  sums and cascade from C (:func:`.kernels.cascade_from_c`).

Every step is exact IEEE f32, int8 or int32 arithmetic, so both routes give
the same words; the only losses are the final nw-word rounding and the
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
MAX_K_EXACT = K.INT8_GEMM_MAX_K

# The JAX package's route threshold on the int32 product C, in bytes
# (clrs_tpu/dd/limb_gemm.py:52, _PLCASCADE_C_BUDGET). It reproduces the
# TPU package's routing, a budget of the TPU's VMEM; it is not a limit of
# the H100's memory.
JAX_ROUTE_C_BYTES = 6 << 20


def _jax_fused_tiling_exists(m, n, L, k, budget=JAX_ROUTE_C_BYTES):
    """Whether clrs_tpu's fused kernel has a tiling for this GEMM
    (pallas_linalg.py:571-587, _fused_tile_sizes is not None)."""
    tn = 128 if n >= 128 else n
    tm = 8 if m >= 8 else m
    while tm >= 8 and tm * 2 <= min(128, m):
        tm *= 2

    def fp(tm, tn):
        return L * tm * k + L * k * tn + 11 * tm * tn * 4

    while fp(tm, tn) > budget and tm > 8:
        tm //= 2
    return fp(tm, tn) <= budget


def gemm_route(m, k, n, nw):
    """'fused' or 'split': the route clrs_tpu's fx_matmul takes on the TPU
    for an [m, k] @ [k, n] product of nw words (limb_gemm.py:243-331)."""
    L, _ = K.limb_params(nw)
    if ((L * m) * (L * n) * 4 > JAX_ROUTE_C_BYTES
            and _jax_fused_tiling_exists(m, n, L, k)):
        return "fused"
    return "split"


# When set to a list, every fx_matmul call appends the int8 tensor-core ops
# it issues (2 per MAC, the limb blowup included; clrs_tpu/dd/limb_gemm.py:
# 149-164): the fused route multiplies only the limb pairs of the ndiag
# diagonals it keeps, the split route all L^2 pairs, as int8_gemm does over
# [B, L m, k] x [B, k, L n]. torch_bench.py runs one step with it set. The
# batch is the operands' explicit leading axis, so the JAX package's
# mac_scale, which undoes vmap hiding the batch, has no counterpart here.
_MAC_COUNTER = None


def _count_macs(L, ndiag, m, n, k, fused, batch=1):
    if fused:
        npairs = sum(min(d, L - 1) - max(0, d - L + 1) + 1
                     for d in range(ndiag))
    else:
        npairs = L * L
    _MAC_COUNTER.append(2 * npairs * m * n * k * batch)


def fx_matmul(a, b, nw=None, pre_a=None, pre_b=None, route=None):
    """Batched f32-expansion GEMM [B, m, k] @ [B, k, n] -> nw words [B, m, n].

    ``pre_a``/``pre_b`` = (int8 limbs [B, L, m, k] / [B, L, k, n], int32
    exps [B, m, 1] / [B, 1, n]) from :func:`host_precompute` (moved to the
    device) skip that operand's scaling and extraction; nw must then be
    given. The operands may carry other word counts than the product's nw
    (default: a's), as the certified step-length route's one-word
    eigenvectors do: each is cut into the L limbs of an nw-word product.
    ``route`` ('fused' or 'split') overrides :func:`gemm_route`; both give
    the same words."""
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
    for pre in (pre_a, pre_b):
        if pre is not None and pre[0].shape[1] != L:
            raise ValueError(f"fx_matmul: limb count {pre[0].shape[1]} does "
                             f"not match nw={nw} (L={L})")
    route = route or gemm_route(m, k, n, nw)
    if _MAC_COUNTER is not None:
        _count_macs(L, K.limb_params(nw)[1], m, n, k, route == "fused", Bt)
    if route == "fused":
        A3, ea = K.limb_extract(a, L, "a") if pre_a is None else pre_a
        B3, eb = K.limb_extract(b, L, "b") if pre_b is None else pre_b
        eab = (ea + eb).expand(Bt, m, n).contiguous()
        return K.limb_gemm(A3, B3, eab, nw)
    if route != "split":
        raise ValueError(f"route must be 'fused' or 'split', got {route!r}")
    if pre_a is None:
        A2, ea = K.limb_extract(a, L, "a", layout="gemm")    # [B, L m, k]
    else:
        A2, ea = pre_a[0].reshape(Bt, L * m, k), pre_a[1]
    if pre_b is None:
        B2, eb = K.limb_extract(b, L, "b", layout="gemm")    # [B, k, L n]
    else:
        # limb-major [B, L, k, n] -> [B, k, L n] (limb_gemm.py:303)
        B2 = pre_b[0].permute(0, 2, 1, 3).reshape(Bt, k, L * n)
        eb = pre_b[1]
    C = K.int8_gemm(A2, B2)
    eab = (ea + eb).expand(Bt, m, n).contiguous()
    return K.cascade_from_c(C, eab, nw)


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
