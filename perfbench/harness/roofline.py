"""The least time one IPM iteration's work could take on an NVIDIA H100,
counted from the cell's own shapes, whatever kernels implement it.

Per cluster of P constraint rows (P x P Schur complement S) and per block
of size n whose constraint matrices have rank r:
- the Cholesky factorizations of S and of each block's X and Y;
- the triangular solve of each block's X factor on its P r constraint
  vectors, and the forward and transposed solves with S's factor for the
  predictor and the corrector;
- the two limb GEMMs of each block's share of S ((L^-1 V)^T (L^-1 V) and
  V^T Y V, P r x n x P r);
- the step-length eigensolver on each block's X and Y step matrices.
Blocks of size 1 (the scalar packs) are left out.

The closed forms are ``chip_smoke.py``'s (``cost_chol``, ``cost_tri``,
``cost_limb_gemm``, ``cost_eig_lowest``, ``bound`` and the expansion
operation counts under them), copied; the limb parameters are
``clrs_tpu_torch/dd/kernels.py::limb_params``'s rule. Operations: one per
f32 or int32 arithmetic, compare or bit operation of the expansion
arithmetic, two per int8 multiply-add, f64 for the eigensolver. Bytes:
each input read once and each output written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"scalar": 67e12,   # f32 outside the tensor cores
                  "f64": 34e12,      # f64 outside the tensor cores
                  "int8": 1979e12}   # int8 tensor-core operations
LIMB_BITS = 7
LAPACK_BISECTION_COUNTS = 53         # dstebz's halvings to f64 precision


def bound(nbytes, ops):
    """(least ms, 'bytes' or 'operations'): the units run concurrently, so
    the operations take as long as the busiest unit."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(n / PEAK_OPS_PER_S[k] for k, n in ops.items())
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def limb_params(nw):
    bits = 24 * nw + 21
    L = -(-bits // LIMB_BITS)
    return L, min(2 * L - 1, bits // LIMB_BITS + 1)


def _vec_sum(k):
    return 6 * (k - 1)


def _renorm(k, w):
    return 3 * _vec_sum(k) + (k - w)


def exp_add_ops(w):
    return 6 * w + _renorm(2 * w, w)


def exp_mul_ops(w):
    if w == 1:
        return 1
    return (4 * (w - 1) + 9 * w * (w - 1) // 2 + (3 * w - 2)
            + _renorm((w - 1) ** 2 + 1, w))


def _mul_f32_ops(w):
    return 11 * (w - 1) + 2 + _renorm(2 * w - 2, w)


def _pow2_ops(w, steps=3):
    return 5 * steps + w * steps


def _widths(nw):
    w, out = 1, []
    while w < nw:
        w = min(2 * w, nw)
        out.append(w)
    return out


def exp_rsqrt_ops(nw):
    core = 2 + sum(1 + 2 * exp_mul_ops(w) + 2 + exp_add_ops(w)
                   + _mul_f32_ops(w) + exp_mul_ops(w) + exp_add_ops(w)
                   for w in _widths(nw))
    return 5 + 2 * _pow2_ops(nw) + 1 + core


def exp_div_ops(nw):
    core = 1 + sum(1 + 2 * exp_mul_ops(w) + 2 + 2 * exp_add_ops(w)
                   for w in _widths(nw))
    return 4 + 2 * _pow2_ops(nw) + core + 3 * exp_mul_ops(nw) \
        + 2 * exp_add_ops(nw)


def _fold_ops(nw, ndiag):
    return ndiag * (37 + _vec_sum(nw + 4)) + 2 * _vec_sum(nw + 2) + 2


def _npairs(L, ndiag):
    return sum(min(d, L - 1) - max(0, d - L + 1) + 1 for d in range(ndiag))


def _tree_adds(lo, hi):
    if hi - lo == 1:
        return 0
    mid = lo + (hi - lo) // 2
    return (hi - 1) + _tree_adds(lo, mid) + _tree_adds(mid, hi)


def cost_limb_gemm(nw, B, m, k, n):
    L, nd = limb_params(nw)
    return (B * L * (m * k + k * n) + 4 * B * m * n * (1 + nw),
            {"int8": 2 * _npairs(L, nd) * B * m * n * k,
             "scalar": B * m * n * _fold_ops(nw, nd)})


def cost_chol(nw, B, n):
    per = n * (nw + 1 + exp_rsqrt_ops(nw) + exp_mul_ops(nw))
    per += sum(2 * r * exp_mul_ops(nw) + r * r * (exp_mul_ops(nw)
                                                  + exp_add_ops(nw))
               for r in range(n))
    return 8 * nw * B * n * n + 4 * B, {"scalar": B * per}


def cost_tri(nw, B, n, m, trans):
    mul, add = exp_mul_ops(nw), exp_add_ops(nw)
    sums = _tree_adds(0, n) if trans else n * (n - 1) // 2
    per_col = n * (n - 1) // 2 * mul + sums * add + n * (mul + add * trans)
    ops = B * (n * exp_div_ops(nw) + m * per_col)
    return 4 * nw * B * (n * (n + 1) // 2 + 2 * n * m), {"scalar": ops}


def cost_eig_lowest(B, n):
    ops = sum(4 * m * m for m in range(1, n))
    ops += LAPACK_BISECTION_COUNTS * 5 * n
    return 8 * B * n * n + 8 * B, {"f64": B * ops}


def iteration_work(shape, nw):
    """(bytes, {unit: operations}) of one iteration of a problem of
    ``shape``: {"clusters": [{"P": rows, "blocks": [[n, r], ...]}]}."""
    parts = []
    for cl in shape["clusters"]:
        P = cl["P"]
        parts.append(cost_chol(nw, 1, P))
        for trans in (False, True):
            parts += [cost_tri(nw, 1, P, 1, trans)] * 2
        for n, r in cl["blocks"]:
            if n < 2:
                continue
            parts += [cost_chol(nw, 1, n)] * 2
            parts.append(cost_tri(nw, 1, n, P * r, False))
            parts += [cost_limb_gemm(nw, 1, P * r, n, P * r)] * 2
            parts += [cost_eig_lowest(1, n)] * 2
    nbytes = sum(b for b, _ in parts)
    ops = {}
    for _, o in parts:
        for k, v in o.items():
            ops[k] = ops.get(k, 0) + v
    return nbytes, ops


def least_ms(shape, nw):
    """(least ms of one iteration on the card, what bounds it)."""
    return bound(*iteration_work(shape, nw))
