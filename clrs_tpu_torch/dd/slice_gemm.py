"""Exact multi-word f64 GEMM by mantissa slicing (Ozaki), batched.

Port of ``clrs_tpu/dd/slice_gemm.py::slice_matmul`` (its IEEE branches):

1. each row of A (column of B) is scaled by a power of two so that its
   value lies in (-1, 1) (exponents from ``frexp`` of the row maximum of
   word 0; powers of two built from bits);
2. T slices of S bits each are cut off the full multi-word value (VecSum
   sweeps fold the lower words in); every slice is an integer held
   exactly in f64;
3. ONE f64 GEMM (T M, K) @ (K, T N) over the slice-stacked operands: with
   2 S + ceil(log2 K) + ceil(log2 T) + 2 <= 53 every partial sum is an
   integer below 2^53, so the product is exact in any summation order
   (cuBLAS DGEMM on the card, split-K included);
4. the slice-pair tiles are summed per significance diagonal d = ta + tb
   (exact), scaled back, and cascaded into nw words with the error-free
   renormalisations of :mod:`.f64ops`.

The result is exact up to the final nw-word rounding and a truncation
below 2^-(53 nw + 12) of rowmax(A) colmax(B) K. The leading axes are a
batch: each member takes its own exponents, so a batched call equals the
member-by-member calls bit for bit (the reference's ``jax.vmap(dd_matmul)``,
clrs_tpu/solver/step.py:148-157).
"""

from __future__ import annotations

import math

import torch

from .f64ops import renorm, vec_sum
from .ops import broadcast_shapes

__all__ = ["slice_params", "mul_pow2", "row_exponents", "extract_slices",
           "slice_matmul"]

F64 = torch.float64
_MAGIC = 1.5 * 2.0 ** 52    # round-to-nearest-integer magic constant
_POW2_STEP = 1022           # |e| of one bit-built power-of-two factor


def _ceil_log2(n: int) -> int:
    return max(0, (int(n) - 1).bit_length())


# When set to a list, every slice_matmul appends the f64 tensor-core ops of
# its one DGEMM, 2 B (T m) k (T n) over the batch B (the f64 counterpart of
# limb_gemm._MAC_COUNTER; torch_bench.py runs one step with it set).
_OP_COUNTER = None


def slice_params(k, nw):
    """(slice bits S, slice count T, bits kept) for depth k and nw words
    (clrs_tpu/dd/slice_gemm.py:133-143)."""
    bits_needed = 53 * nw + 29
    lk = _ceil_log2(k)
    sbits = max(4, min(24, (53 - lk - 8) // 2))
    nsl = -(-bits_needed // sbits)
    while 2 * sbits + lk + _ceil_log2(nsl) + 2 > 53 and sbits > 4:
        sbits -= 1
        nsl = -(-bits_needed // sbits)
    return sbits, nsl, bits_needed


def _pow2(h):
    """Exact f64 2^h for int tensors h with |h| <= 1022, from bits."""
    return ((h.to(torch.int64) + 1023) << 52).view(F64)


def mul_pow2(x, e, steps=2):
    """x * 2^e exactly wherever the result is a normal number, e an int
    tensor with |e| <= 1022 steps: one bit-built factor per step, each
    taking the next 1022 of e, so no factor leaves the range and no
    intermediate rounds (what ``jnp.ldexp`` gives, where ``torch.ldexp``
    overflows its 2^e)."""
    rem = e
    for _ in range(steps):
        h = torch.clamp(rem, -_POW2_STEP, _POW2_STEP)
        x = x * _pow2(h)
        rem = rem - h
    return x


def row_exponents(hi, dim):
    """Power-of-two exponent e per row (dim -1) or column (dim -2) with
    |value| 2^-e < 1: ``frexp`` of the maximum magnitude, plus one."""
    mag = torch.amax(hi.abs(), dim=dim, keepdim=True)
    mag = torch.where(mag == 0, 1.0, mag)
    return torch.frexp(mag).exponent + 1


def extract_slices(words, nslices, sbits):
    """Integer f64 slices of a scaled multi-word value (|v| < 1): slice t
    has |slice| <= 2^S and v = sum_t slice_t 2^-(S (t + 1)) + r with
    |r| < 2^-(S T) (clrs_tpu/dd/slice_gemm.py:95-112)."""
    r = list(words)
    scale = float(1 << sbits)
    slices = []
    for _ in range(nslices):
        r = [c * scale for c in r]                # exact pow2 scaling
        if len(r) > 1:
            r = vec_sum(r)                        # error-free compression
        d = (r[0] + _MAGIC) - _MAGIC              # rint, ties to even
        r[0] = r[0] - d                           # exact (same ulp grid)
        slices.append(d)
    return slices


def slice_matmul(a, b, nw=None):
    """Multi-word f64 GEMM [..., M, K] @ [..., K, N] -> nw words
    [..., M, N] (default nw = the operands' word count)."""
    nw = nw or len(a)
    m, k = a[0].shape[-2:]
    n = b[0].shape[-1]
    batch = broadcast_shapes(a[0].shape[:-2], b[0].shape[:-2])
    if k == 0 or m == 0 or n == 0:
        z = torch.zeros(batch + (m, n), dtype=F64, device=a[0].device)
        return (z,) * nw
    sbits, nsl, bits_needed = slice_params(k, nw)
    if _OP_COUNTER is not None:
        _OP_COUNTER.append(2 * math.prod(batch) * (nsl * m) * k * (nsl * n))
    ea = row_exponents(a[0], -1)                  # [..., M, 1]
    eb = row_exponents(b[0], -2)                  # [..., 1, N]
    asc = tuple(mul_pow2(c, -ea) for c in a)
    bsc = tuple(mul_pow2(c, -eb) for c in b)
    A = torch.cat(extract_slices(asc, nsl, sbits), dim=-2)   # [.., T M, K]
    B = torch.cat(extract_slices(bsc, nsl, sbits), dim=-1)   # [.., K, T N]
    C = torch.matmul(A, B)                        # exact: one f64 GEMM

    # diagonal sums d = ta + tb of the tiles C[ta M:(ta+1) M, tb N:(tb+1) N],
    # one slab of T tiles per ta (exact integer sums below 2^53)
    C5 = C.reshape(batch + (nsl, m, nsl, n)).transpose(-3, -2)  # ta,tb,M,N
    ndiag = 2 * nsl - 1
    D = torch.zeros(batch + (ndiag, m, n), dtype=F64, device=C.device)
    for ta in range(nsl):
        D[..., ta:ta + nsl, :, :] += C5[..., ta, :, :, :]

    # cascade the kept diagonals into nw + 2 words, most significant first
    eab = ea + eb                                 # [.., M, N]
    steps = -(-(2 * 1026 + sbits * (ndiag + 1)) // _POW2_STEP)
    exp = None
    for d in range(ndiag):
        if d * sbits > bits_needed:
            continue                              # below truncation floor
        contrib = mul_pow2(D[..., d, :, :], eab - sbits * (d + 2), steps)
        if exp is None:
            exp = [contrib]
        else:
            exp = list(renorm(exp + [contrib], nw + 2, sweeps=1))
    return renorm(exp, nw, sweeps=2)
