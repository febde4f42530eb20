"""Expansion linear algebra on torch tensors (port of
``clrs_tpu/dd/linalg.py``), on f32 or f64 words.

Values are tuples of nw float32 or float64 tensors; every function
dispatches on the word dtype, as the JAX package's do:

- f32 words: GEMMs go through the exact limb GEMM
  (:func:`.limb_gemm.fx_matmul`), and the batched factorizations
  ``b_cholesky``/``b_solve_tril``/``b_solve_tril_t`` call the kernel
  wrappers of :mod:`.kernels` (the CUDA kernels for CUDA tensors, their
  plain versions for CPU tensors);
- f64 words: GEMMs go through the slice GEMM
  (:func:`.slice_gemm.slice_matmul`, one f64 GEMM each), and the
  factorizations are the JAX package's XLA loops (``dd_cholesky``,
  ``dd_solve_tril``, ``dd_solve_triu``, clrs_tpu/dd/linalg.py:218-318)
  batched over the leading axis, in PyTorch ops: the JAX package has no
  Pallas kernel on this path.

From n >= 96 both take the blocked right-looking forms: the
row-sequential recurrences run only on nb = 64 diagonal blocks, the
trailing updates as expansion GEMMs.
"""

from __future__ import annotations

import torch

from . import f64ops as F
from . import kernels as K
from .arith import dd_add, dd_div, dd_mul, dd_sub, is_f64
from .limb_gemm import fx_matmul
from .slice_gemm import slice_matmul

__all__ = ["dd_zeros", "dd_eye", "dd_transpose", "dd_sum", "dd_sum_prod",
           "dd_dot",
           "dd_max_abs", "dd_matmul", "bmm", "dd_symmetrize", "b_cholesky",
           "b_solve_tril", "b_solve_tril_t", "b_solve_cholesky",
           "s_cholesky", "s_solve_tril", "s_solve_tril_t", "s_solve_cholesky"]


def dd_zeros(shape, nw, device, dtype=torch.float32):
    z = torch.zeros(shape, dtype=dtype, device=device)
    return (z,) * nw


def dd_eye(n, nw, device, dtype=torch.float32):
    e = torch.eye(n, dtype=dtype, device=device)
    return (e,) + (torch.zeros_like(e),) * (nw - 1)


def dd_transpose(x):
    """Transpose the last two axes."""
    return tuple(c.transpose(-1, -2) for c in x)


def dd_sum(x, axis):
    """Pairwise (tree) expansion sum along ``axis``
    (clrs_tpu/dd/linalg.py:110-127: the same pairing order): f32 words
    through :func:`.kernels.tree_sum` (one tree_sum<NW> launch for CUDA
    words), f64 words by the f64 add level by level."""
    if is_f64(x):
        return K.pairwise_sum(x, axis, dd_add)
    return K.tree_sum(x, axis)


def dd_sum_prod(x, y, axis, acc=None, sub=False, scale=None, scale_on="x"):
    """acc +- dd_sum(x y) over ``axis`` (``y`` None: of x), x's words (or,
    ``scale_on="product"``, the product's) times the exact word or float
    ``scale`` first. ``axis`` is an int, consecutive axes or None (all):
    their entries are summed in row-major order, as a reshape of them to
    one axis orders them. f32 words: one tree_sum<NW, PRO> launch for CUDA
    words (:func:`.kernels.tree_sum_fused`), the composition of the plain
    ops for CPU words; f64 words: the composition of dd_mul, dd_sum and
    dd_add or dd_sub."""
    if scale is None:
        scale_on = None
    if not is_f64(x):
        return K.tree_sum_fused(x, y, axis, acc, sub, scale, scale_on)
    if scale_on == "x":
        x = tuple(c * scale for c in x)
    p = dd_mul(x, y) if y is not None else x
    if scale_on == "product":
        p = tuple(c * scale for c in p)
    s = dd_sum(*K.flatten_sum_axes(p, axis))
    if acc is None:
        return s
    return dd_sub(acc, s) if sub else dd_add(acc, s)


def dd_dot(x, y, acc=None):
    """Expansion trace inner product [acc +] sum(x * y) over all elements
    (f32: one tree_sum<NW, PRO_MUL> launch for CUDA words)."""
    return dd_sum_prod(x, y, None, acc)


def dd_max_abs(x, acc=None):
    """max |x| as a float64 tensor (error reporting only: words are summed
    in f64), ``torch.maximum(acc, max |x|)`` with a float64 scalar acc
    (f32 words on the card: one expf64 launch, the maximum included)."""
    return K.expf64_max_abs(x, acc)


def bmm(a, b):
    """Batched expansion GEMM [B, m, k] @ [B, k, n]: the limb GEMM on f32
    words, the slice GEMM on f64 words."""
    if is_f64(a):
        return slice_matmul(a, b)
    return fx_matmul(a, b)


def dd_matmul(a, b):
    """Unbatched expansion GEMM [m, k] @ [k, n]."""
    out = bmm(tuple(c[None] for c in a), tuple(c[None] for c in b))
    return tuple(c[0] for c in out)


def dd_symmetrize(x):
    """(x + x^T) / 2 over the last two axes (f32: one expmap launch for
    CUDA words)."""
    if not is_f64(x):
        return K.ew_symmetrize(x)
    s = dd_add(x, dd_transpose(x))
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
            A22 = dd_sub(_sub(A, k1, n, k1, n), upd)
            _set(A, A22, k1, n, k1, n)
    return tuple(out), ok


def _b_solve_tril_blocked(l, b):
    """Blocked forward substitution (clrs_tpu/dd/linalg.py:408-424)."""
    nw = len(l)
    Lb, n, _ = l[0].shape
    m = b[0].shape[2]
    x = [torch.zeros((Lb, n, m), dtype=l[0].dtype, device=l[0].device)
         for _ in range(nw)]
    for (k0, k1) in _blk_ranges(n):
        rhs = _sub(b, k0, k1, 0, m)
        if k0 > 0:
            rhs = dd_sub(rhs, bmm(_sub(l, k0, k1, 0, k0),
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
    x = [torch.zeros((Lb, n, m), dtype=l[0].dtype, device=l[0].device)
         for _ in range(nw)]
    for (k0, k1) in reversed(_blk_ranges(n)):
        rhs = _sub(b, k0, k1, 0, m)
        if k1 < n:
            Lcol = _sub(l, k1, n, k0, k1)
            rhs = dd_sub(rhs, bmm(dd_transpose(Lcol),
                                   _sub(x, k1, n, 0, m)))
        xk = b_solve_tril_t(_sub(l, k0, k1, k0, k1), rhs)
        _set(x, xk, k0, k1, 0, m)
    return tuple(x)


def _contig(x):
    return tuple(c.contiguous() for c in x)


# ---------------------------------------------------------------------------
# the f64 factorizations: clrs_tpu/dd/linalg.py's dd_cholesky, _diag_recip,
# dd_solve_tril and dd_solve_triu with the [B] batch written out (the
# reference runs them under jax.vmap); every op is elementwise across the
# batch, so a member's words equal its own unbatched run
# ---------------------------------------------------------------------------

def _chol_f64(a):
    """Row-sequential Cholesky of [B, n, n] f64 words -> (L, ok [B]).

    Per pivot j (clrs_tpu/dd/linalg.py:218-263): ok &= d0 > 0, a failed
    pivot is replaced by 1, one inverse square root rs serves the pivot
    (d rs) and the column (col rs), and the trailing matrix takes the
    rank-1 update. The update is computed on the trailing block only: the
    reference's mask leaves every other entry as it was, and the entries
    above the diagonal it does update are never read into the factor."""
    nw = len(a)
    Bt, n, _ = a[0].shape
    dev, dt = a[0].device, a[0].dtype
    ws = [c.clone() for c in a]
    ok = torch.ones((Bt,), dtype=torch.bool, device=dev)
    one = (torch.ones((), dtype=dt, device=dev),) + \
        (torch.zeros((), dtype=dt, device=dev),) * (nw - 1)
    for j in range(n):
        d = tuple(c[:, j, j] for c in ws)
        pos = d[0] > 0
        ok = ok & pos
        d_safe = F.dd_where(pos, d, one)
        rs = F.dd_rsqrt(d_safe)
        rt = dd_mul(d_safe, rs)
        coll = dd_mul(tuple(c[:, j + 1:, j] for c in ws),
                      tuple(r[:, None] for r in rs))
        if j + 1 < n:
            upd = dd_mul(tuple(c[:, :, None] for c in coll),
                         tuple(c[:, None, :] for c in coll))
            u = dd_sub(tuple(c[:, j + 1:, j + 1:] for c in ws), upd)
            for c, uc in zip(ws, u):
                c[:, j + 1:, j + 1:] = uc
        for c, cc, rc in zip(ws, coll, rt):
            c[:, :j, j] = 0.0
            c[:, j, j] = rc
            c[:, j + 1:, j] = cc
    tril = torch.tril(torch.ones((n, n), dtype=torch.bool, device=dev))
    return tuple(torch.where(tril, c, 0.0) for c in ws), ok


def _diag_recip(m):
    """Reciprocals of the diagonals of [B, n, n] words, one division for
    all rows (clrs_tpu/dd/linalg.py:265-273)."""
    diag = tuple(torch.diagonal(c, dim1=1, dim2=2) for c in m)
    one = (torch.ones_like(diag[0]),) + tuple(torch.zeros_like(c)
                                              for c in diag[1:])
    return dd_div(one, diag)


def _solve_rows(t, b, order, before):
    """X with T X = B for a triangular [B, n, n] ``t``, one row i per step
    in ``order`` (clrs_tpu/dd/linalg.py:275-318): x_i = (b_i - sum_k
    t_ik x_k) / t_ii over the k with ``before(k, i)``, the masked
    products summed by the full-length tree."""
    n = t[0].shape[-1]
    idx = torch.arange(n, device=t[0].device)
    dinv = _diag_recip(t)
    x = [torch.zeros_like(c) for c in b]
    for i in order:
        mask = before(idx, i).to(t[0].dtype)[:, None]
        row = tuple(c[:, i, :, None] * mask for c in t)
        s = dd_sum(dd_mul(row, tuple(x)), axis=1)
        rhs = dd_sub(tuple(c[:, i, :] for c in b), s)
        xi = dd_mul(rhs, tuple(c[:, i, None] for c in dinv))
        for xc, xic in zip(x, xi):
            xc[:, i, :] = xic
    return tuple(x)


def _solve_tril_f64(l, b):
    """L X = B by forward substitution (dd_solve_tril, batched)."""
    n = l[0].shape[-1]
    return _solve_rows(l, b, range(n), lambda idx, i: idx < i)


def _solve_tril_t_f64(l, b):
    """L^T X = B by backward substitution on U = L^T (dd_solve_triu of
    dd_transpose(L), batched)."""
    n = l[0].shape[-1]
    return _solve_rows(dd_transpose(l), b, range(n - 1, -1, -1),
                       lambda idx, i: idx > i)


def b_cholesky(a):
    """Batched Cholesky of [B, n, n] words -> (lower factor, ok [B])."""
    n = a[0].shape[-1]
    if n == 0:
        return a, torch.ones(a[0].shape[0], dtype=torch.bool,
                             device=a[0].device)
    if n >= BLK_MIN:
        return _b_cholesky_blocked(a)
    if is_f64(a):
        return _chol_f64(a)
    return K.chol_batched(_contig(a))


def b_solve_tril(l, b):
    """Batched forward substitution L X = B ([B, n, n] @ [B, n, m])."""
    if b[0].shape[-1] == 0 or l[0].shape[-1] == 0:
        return b
    if l[0].shape[-1] >= BLK_MIN:
        return _b_solve_tril_blocked(l, b)
    if is_f64(l):
        return _solve_tril_f64(l, b)
    return K.tri_solve_batched(_contig(l), _contig(b), trans=False)


def b_solve_tril_t(l, b):
    """Batched backward substitution L^T X = B given the LOWER factor."""
    if b[0].shape[-1] == 0 or l[0].shape[-1] == 0:
        return b
    if l[0].shape[-1] >= BLK_MIN:
        return _b_solve_tril_t_blocked(l, b)
    if is_f64(l):
        return _solve_tril_t_f64(l, b)
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
