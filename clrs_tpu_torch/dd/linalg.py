"""Expansion linear algebra on torch tensors (port of the f32 half of
``clrs_tpu/dd/linalg.py``).

Values are tuples of nw float32 tensors. GEMMs go through the exact limb
GEMM (:func:`.limb_gemm.fx_matmul`); the batched factorizations
``b_cholesky``/``b_solve_tril``/``b_solve_tril_t`` call the kernel wrappers
of :mod:`.kernels` (the CUDA kernels for CUDA tensors, their plain
versions for CPU tensors). From n >= 96 they take the blocked
right-looking forms: the row-sequential recurrences run only on nb = 64
diagonal blocks, the trailing updates as expansion GEMMs.
"""

from __future__ import annotations

import torch

from . import kernels as K
from .limb_gemm import fx_matmul
from .ops import exp_add, exp_mul, exp_sub

__all__ = ["dd_zeros", "dd_eye", "dd_transpose", "dd_sum", "dd_dot",
           "dd_max_abs", "dd_matmul", "bmm", "dd_symmetrize", "b_cholesky",
           "b_solve_tril", "b_solve_tril_t", "b_solve_cholesky",
           "s_cholesky", "s_solve_tril", "s_solve_tril_t", "s_solve_cholesky"]


def dd_zeros(shape, nw, device):
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return (z,) * nw


def dd_eye(n, nw, device):
    e = torch.eye(n, dtype=torch.float32, device=device)
    return (e,) + (torch.zeros_like(e),) * (nw - 1)


def dd_transpose(x):
    """Transpose the last two axes."""
    return tuple(c.transpose(-1, -2) for c in x)


def dd_sum(x, axis):
    """Pairwise (tree) expansion sum along ``axis``
    (clrs_tpu/dd/linalg.py:110-127: the same pairing order)."""
    ws = [c.movedim(axis, 0) for c in x]
    n = ws[0].shape[0]
    while n > 1:
        half = (n + 1) // 2
        a = tuple(c[:n // 2] for c in ws)
        b = tuple(c[half:half + n // 2] for c in ws)
        s = exp_add(a, b)
        if n % 2 == 1:
            s = tuple(torch.cat([sc, c[n // 2:half]], dim=0)
                      for sc, c in zip(s, ws))
        ws = list(s)
        n = half
    if ws[0].shape[0] == 0:
        z = torch.zeros(ws[0].shape[1:], dtype=ws[0].dtype,
                        device=ws[0].device)
        return (z,) * len(ws)
    return tuple(c[0] for c in ws)


def dd_dot(x, y):
    """Expansion trace inner product sum(x * y) over all elements."""
    p = exp_mul(x, y)
    return dd_sum(tuple(c.reshape(-1) for c in p), axis=0)


def dd_max_abs(x):
    """max |x| as a float64 tensor (error reporting only: words are summed
    in f64)."""
    s = x[0].to(torch.float64)
    for c in x[1:]:
        s = s + c.to(torch.float64)
    if s.numel() == 0:
        return torch.zeros((), dtype=torch.float64, device=s.device)
    return s.abs().max()


def bmm(a, b):
    """Batched expansion GEMM [B, m, k] @ [B, k, n]."""
    return fx_matmul(a, b)


def dd_matmul(a, b):
    """Unbatched expansion GEMM [m, k] @ [k, n]."""
    out = fx_matmul(tuple(c[None] for c in a), tuple(c[None] for c in b))
    return tuple(c[0] for c in out)


def dd_symmetrize(x):
    s = exp_add(x, dd_transpose(x))
    return tuple(0.5 * c for c in s)            # exact scaling


# ---------------------------------------------------------------------------
# batched factorization front-ends
# ---------------------------------------------------------------------------

BLK_NB = 64     # diagonal block size of the blocked formulations
BLK_MIN = 96    # blocked factorizations from this size up


def _blk_ranges(n, nb=BLK_NB):
    return [(k0, min(k0 + nb, n)) for k0 in range(0, n, nb)]


def _sub(x, r0, r1, c0, c1):
    return tuple(c[:, r0:r1, c0:c1] for c in x)


def _set(dst, src, r0, r1, c0, c1):
    for d, s in zip(dst, src):
        d[:, r0:r1, c0:c1] = s


def _b_cholesky_blocked(a):
    """Blocked right-looking Cholesky (clrs_tpu/dd/linalg.py:373-405)."""
    nw = len(a)
    Lb, n, _ = a[0].shape
    out = [torch.zeros_like(a[0]) for _ in range(nw)]
    A = [c.clone() for c in a]
    ok = torch.ones((Lb,), dtype=torch.bool, device=a[0].device)
    for (k0, k1) in _blk_ranges(n):
        Lkk, okb = b_cholesky(_sub(A, k0, k1, k0, k1))
        ok = ok & okb
        _set(out, Lkk, k0, k1, k0, k1)
        if k1 < n:
            A21 = _sub(A, k1, n, k0, k1)
            # panel P with P L_kk^T = A21  <=>  L_kk P^T = A21^T
            Pt = b_solve_tril(Lkk, dd_transpose(A21))
            Pn = dd_transpose(Pt)
            _set(out, Pn, k1, n, k0, k1)
            upd = bmm(tuple(c.contiguous() for c in Pn), Pt)
            A22 = exp_sub(_sub(A, k1, n, k1, n), upd)
            _set(A, A22, k1, n, k1, n)
    return tuple(out), ok


def _b_solve_tril_blocked(l, b):
    """Blocked forward substitution (clrs_tpu/dd/linalg.py:408-424)."""
    nw = len(l)
    Lb, n, _ = l[0].shape
    m = b[0].shape[2]
    x = [torch.zeros((Lb, n, m), dtype=torch.float32, device=l[0].device)
         for _ in range(nw)]
    for (k0, k1) in _blk_ranges(n):
        rhs = _sub(b, k0, k1, 0, m)
        if k0 > 0:
            rhs = exp_sub(rhs, bmm(_sub(l, k0, k1, 0, k0),
                                   _sub(x, 0, k0, 0, m)))
        xk = b_solve_tril(_sub(l, k0, k1, k0, k1), rhs)
        _set(x, xk, k0, k1, 0, m)
    return tuple(x)


def _b_solve_tril_t_blocked(l, b):
    """Blocked backward substitution L^T X = B from the LOWER factor
    (clrs_tpu/dd/linalg.py:427-443)."""
    nw = len(l)
    Lb, n, _ = l[0].shape
    m = b[0].shape[2]
    x = [torch.zeros((Lb, n, m), dtype=torch.float32, device=l[0].device)
         for _ in range(nw)]
    for (k0, k1) in reversed(_blk_ranges(n)):
        rhs = _sub(b, k0, k1, 0, m)
        if k1 < n:
            Lcol = _sub(l, k1, n, k0, k1)
            rhs = exp_sub(rhs, bmm(dd_transpose(Lcol),
                                   _sub(x, k1, n, 0, m)))
        xk = b_solve_tril_t(_sub(l, k0, k1, k0, k1), rhs)
        _set(x, xk, k0, k1, 0, m)
    return tuple(x)


def _contig(x):
    return tuple(c.contiguous() for c in x)


def b_cholesky(a):
    """Batched Cholesky of [B, n, n] words -> (lower factor, ok [B])."""
    n = a[0].shape[-1]
    if n == 0:
        return a, torch.ones(a[0].shape[0], dtype=torch.bool,
                             device=a[0].device)
    if n >= BLK_MIN:
        return _b_cholesky_blocked(a)
    return K.chol_batched(_contig(a))


def b_solve_tril(l, b):
    """Batched forward substitution L X = B ([B, n, n] @ [B, n, m])."""
    if b[0].shape[-1] == 0 or l[0].shape[-1] == 0:
        return b
    if l[0].shape[-1] >= BLK_MIN:
        return _b_solve_tril_blocked(l, b)
    return K.tri_solve_batched(_contig(l), _contig(b), trans=False)


def b_solve_tril_t(l, b):
    """Batched backward substitution L^T X = B given the LOWER factor."""
    if b[0].shape[-1] == 0 or l[0].shape[-1] == 0:
        return b
    if l[0].shape[-1] >= BLK_MIN:
        return _b_solve_tril_t_blocked(l, b)
    return K.tri_solve_batched(_contig(l), _contig(b), trans=True)


def b_solve_cholesky(l, b):
    """Batched (L L^T) X = B."""
    return b_solve_tril_t(l, b_solve_tril(l, b))


def _b1(x):
    return tuple(c[None] for c in x)


def _ub1(x):
    return tuple(c[0] for c in x)


def s_cholesky(a):
    L, ok = b_cholesky(_b1(a))
    return _ub1(L), ok[0]


def s_solve_tril(l, b):
    return _ub1(b_solve_tril(_b1(l), _b1(b)))


def s_solve_tril_t(l, b):
    return _ub1(b_solve_tril_t(_b1(l), _b1(b)))


def s_solve_cholesky(l, b):
    return _ub1(b_solve_cholesky(_b1(l), _b1(b)))
