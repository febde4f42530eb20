"""The four hand-written CUDA kernels of the f32-expansion IPM, their
wrappers, their plain PyTorch versions and their launch counters.

Each wrapper takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches its kernel (built from ``csrc/`` at first use,
:mod:`.build`) or raises: there is no fallback. ``<wrapper>.launches``
counts kernel launches and ``<plain>.calls`` counts plain-version calls,
so a run can show which route it took (:func:`reset_counts`,
:func:`counts`).

| wrapper          | kernel (csrc/kernels.cu)     | replaces (clrs_tpu/dd/pallas_linalg.py)       |
|------------------|------------------------------|-----------------------------------------------|
| limb_extract     | limb_extract_{exp,limbs}     | _extract_call / pl_extract ('a3'/'b3')         |
| limb_gemm        | limb_gemm_fused              | _limb_gemm_fused_call / pl_limb_gemm_fused     |
| chol_batched     | chol_batched                 | _chol_call / pl_cholesky_b                     |
| tri_solve_batched| tri_solve_batched<TRANS>     | _tril_call, _tril_t_call / pl_solve_tril(_t)_b |

Operands are word tuples with a leading batch axis, as the JAX kernels'
[L] grid axis; the kernels take them stacked word-major, [B, nw, ...].
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import ops as O

LIMB_BITS = 7
KERNEL_NW = (5, 6, 7, 8)   # word counts the CUDA kernels are built for


def limb_params(nw):
    """(L limbs, ndiag kept diagonals) for an nw-word product
    (clrs_tpu/dd/limb_gemm.py:233-241)."""
    bits = 24 * nw + 21
    L = -(-bits // LIMB_BITS)
    return L, min(2 * L - 1, bits // LIMB_BITS + 1)


def reset_counts():
    for f in _COUNTED:
        f.launches = 0
    for f in _PLAIN:
        f.calls = 0


def counts():
    """{name: launches} for the kernels and {name_plain: calls} for the
    plain versions."""
    out = {f.__name__: f.launches for f in _COUNTED}
    out.update({f.__name__: f.calls for f in _PLAIN})
    return out


def _counted_plain(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kw):
        wrapper.calls += 1
        return fn(*args, **kw)

    wrapper.calls = 0
    return wrapper


# ---------------------------------------------------------------------------
# shared plain helpers
# ---------------------------------------------------------------------------

def mul_pow2_f32(x, e, steps=4):
    """x * 2^e (f32 x, int32 e), exact where representable; |e| <= 126*steps
    (clrs_tpu/dd/limb_gemm.py:79-89)."""
    out = x
    rem = e
    for _ in range(steps):
        h = torch.clamp(rem, -126, 126)
        out = out * O.f32_pow2(h)
        rem = rem - h
    return out


@functools.lru_cache(maxsize=None)
def _tree_schedule(n):
    """Bottom-up schedule of the recursive halving tree of
    ``_exp_sum_axis0`` (pallas_linalg.py:76-82) over n leaves: per height,
    (left, right, out) node indices, leaves 0..n-1. Nodes of one height are
    independent, so each height is one batched exp_add with the same
    operands, in the same (left, right) order, as the recursion."""
    levels = {}
    counter = [n]

    def build(lo, hi):
        if hi - lo == 1:
            return lo, 0
        mid = lo + (hi - lo) // 2
        a, ha = build(lo, mid)
        b, hb = build(mid, hi)
        node = counter[0]
        counter[0] += 1
        h = max(ha, hb) + 1
        levels.setdefault(h, []).append((a, b, node))
        return node, h

    root, _ = build(0, n)
    sched = []
    for h in sorted(levels):
        a, b, o = zip(*levels[h])
        sched.append((list(a), list(b), list(o)))
    return sched, root, counter[0]


def tree_sum_rows(ws):
    """Tree-sum expansion words [B, n, m] over axis 1 -> [B, 1, m], with the
    recursive halving order of ``_exp_sum_axis0``."""
    n = ws[0].shape[1]
    if n == 1:
        return tuple(c[:, :1] for c in ws)
    sched, root, nodes = _tree_schedule(n)
    dev = ws[0].device
    buf = [torch.cat([c, c.new_zeros((c.shape[0], nodes - n) + c.shape[2:])],
                     dim=1) for c in ws]
    for a, b, o in sched:
        ia = torch.tensor(a, device=dev)
        ib = torch.tensor(b, device=dev)
        io = torch.tensor(o, device=dev)
        s = O.exp_add(tuple(c.index_select(1, ia) for c in buf),
                      tuple(c.index_select(1, ib) for c in buf))
        for c, sc in zip(buf, s):
            c.index_copy_(1, io, sc)
    return tuple(c[:, root:root + 1] for c in buf)


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; the tests and chip_smoke's comparisons)
# ---------------------------------------------------------------------------

@_counted_plain
def limb_extract_plain(words, L, side):
    """words: nw f32 [B, d0, d1] -> (int8 limbs [B, L, d0, d1], int32 exps
    [B, d0, 1] for side 'a' (per row) or [B, 1, d1] for side 'b').

    clrs_tpu/dd/limb_gemm.py:_row_exp_f32 + mul_pow2_f32 + _extract_limbs:
    per-row/column power-of-two scaling from max|word0| so |value| <= 1/2,
    then L rounds of x128, vec_sum, round-to-nearest-even, subtract."""
    ax = 2 if side == "a" else 1
    mag = words[0].abs().amax(dim=ax, keepdim=True)
    mag = torch.where(mag == 0, torch.ones_like(mag), mag)
    e = ((mag.view(torch.int32) >> 23) & 0xFF) - 125
    ws = [mul_pow2_f32(c, -e) for c in words]
    limbs = []
    for _ in range(L):
        ws = [c * 128.0 for c in ws]
        ws = O.vec_sum(ws)
        d = torch.round(ws[0])                      # round half to even
        ws[0] = ws[0] - d
        limbs.append(d.to(torch.int8))
    return torch.stack(limbs, dim=1), e


def _cascade(diags, eab, nw):
    """Fold int32 diagonal sums into nw f32 words
    (pallas_linalg.py:_cascade_fold/_cascade_out, limb_gemm.py:345-375)."""
    acc = [torch.zeros_like(eab, dtype=torch.float32)] * (nw + 2)
    for d, tile in enumerate(diags):
        hi_i = tile >> 15
        lo_i = tile - (hi_i << 15)
        sc = eab - LIMB_BITS * (d + 2)
        hi = mul_pow2_f32(hi_i.to(torch.float32) * 32768.0, sc)
        lo = mul_pow2_f32(lo_i.to(torch.float32), sc)
        cs = O.vec_sum(acc + [hi, lo])
        low = cs[-2] + cs[-1]
        cs = cs[:-2]
        cs[-1] = cs[-1] + low
        acc = cs
    cs = O.vec_sum(O.vec_sum(acc))
    out = list(cs[:nw])
    for i in range(nw, nw + 2):
        out[-1] = out[-1] + cs[i]
    return tuple(out)


@_counted_plain
def limb_gemm_plain(a3, b3, eab, nw):
    """a3 int8 [B, L, m, k], b3 int8 [B, L, k, n], eab int32 [B, m, n] ->
    nw f32 words [B, m, n]. The limb products run as ONE float64 batched
    GEMM, exact: every partial sum is an integer below 2^53 (limbs <= 65,
    k <= 2^13). Diagonal sums D[d] = sum_{ta+tb=d} A[ta] B[tb] are then
    exact int32, as in the int8 MXU path."""
    Bt, L, m, k = a3.shape
    n = b3.shape[3]
    _, ndiag = limb_params(nw)
    A = a3.to(torch.float64).reshape(Bt, L * m, k)
    Bm = b3.to(torch.float64).permute(0, 2, 1, 3).reshape(Bt, k, L * n)
    C = torch.bmm(A, Bm).view(Bt, L, m, L, n)
    diags = []
    for d in range(ndiag):
        acc = None
        for ta in range(max(0, d - (L - 1)), min(d, L - 1) + 1):
            t = C[:, ta, :, d - ta, :]
            acc = t if acc is None else acc + t
        diags.append(acc.to(torch.int32))
    return _cascade(diags, eab, nw)


def _one_like(w0, nw):
    return (torch.ones_like(w0),) + (torch.zeros_like(w0),) * (nw - 1)


@_counted_plain
def chol_plain(a):
    """Batched expansion Cholesky of nw words [B, n, n] -> (lower factor
    words, ok bool [B]); ok = every pivot > 0 (pallas_linalg.py:108-174).
    The rank-1 update reads column j AND row j of the trailing matrix:
    expansion products are not bitwise symmetric in their operands."""
    nw = len(a)
    Bt, n, _ = a[0].shape
    ws = [c.clone() for c in a]
    ok = torch.ones(Bt, dtype=torch.bool, device=a[0].device)
    for j in range(n):
        d = tuple(c[:, j, j] for c in ws)
        pos = d[0] > 0
        ok = ok & pos
        one = _one_like(d[0], nw)
        d_safe = tuple(torch.where(pos, c, o) for c, o in zip(d, one))
        rs = O.exp_rsqrt(d_safe)
        rt = O.exp_mul(d_safe, rs)
        if j + 1 < n:
            rs1 = tuple(c[:, None] for c in rs)
            coll = O.exp_mul(tuple(c[:, j + 1:, j] for c in ws), rs1)
            rowl = O.exp_mul(tuple(c[:, j, j + 1:] for c in ws), rs1)
            upd = O.exp_mul(tuple(c[:, :, None] for c in coll),
                            tuple(c[:, None, :] for c in rowl))
            u = O.exp_sub(tuple(c[:, j + 1:, j + 1:] for c in ws), upd)
            for c, uc, cc in zip(ws, u, coll):
                c[:, j + 1:, j + 1:] = uc
                c[:, j + 1:, j] = cc
        for c, rc in zip(ws, rt):
            c[:, j, j] = rc
    tril = torch.tril(torch.ones(n, n, dtype=torch.bool,
                                 device=a[0].device))
    return tuple(torch.where(tril, c, torch.zeros_like(c)) for c in ws), ok


def _dinv(l):
    """1 / diag(L) as words [B, n] (one vectorized exp_div,
    pallas_linalg.py:_dinv_of)."""
    diag = tuple(torch.diagonal(c, dim1=1, dim2=2) for c in l)
    return O.exp_div(_one_like(diag[0], len(l)), diag)


@_counted_plain
def tri_solve_plain(l, b, trans=False):
    """Batched triangular solve with the LOWER factor l [B, n, n]:
    L X = B (trans=False, right-looking column updates,
    pallas_linalg.py:188-239) or L^T X = B (trans=True, each row rebuilt
    from a column-masked product tree-summed over all n rows,
    pallas_linalg.py:242-293). b: [B, n, m] words."""
    nw = len(l)
    Bt, n, _ = l[0].shape
    m = b[0].shape[2]
    dinv = _dinv(l)
    x = [torch.zeros_like(c) for c in b]
    if not trans:
        bw = [c.clone() for c in b]
        for i in range(n):
            xi = O.exp_mul(tuple(c[:, i, :] for c in bw),
                           tuple(c[:, i:i + 1] for c in dinv))
            for c, xc in zip(x, xi):
                c[:, i, :] = xc
            if i + 1 < n:
                upd = O.exp_mul(tuple(c[:, i + 1:, i:i + 1] for c in l),
                                tuple(c[:, None, :] for c in xi))
                r = O.exp_sub(tuple(c[:, i + 1:, :] for c in bw), upd)
                for c, rc in zip(bw, r):
                    c[:, i + 1:, :] = rc
        return tuple(x)
    rows = torch.arange(n, device=l[0].device)[None, :, None]
    for t in range(n):
        i = n - 1 - t
        colb = tuple(torch.where(rows > i, c[:, :, i:i + 1],
                                 torch.zeros_like(c[:, :, i:i + 1]))
                     for c in l)
        prod = O.exp_mul(colb, tuple(x))            # [B, n, m]
        s = tree_sum_rows(prod)                      # [B, 1, m]
        rhs = O.exp_sub(tuple(c[:, i:i + 1, :] for c in b), s)
        xi = O.exp_mul(rhs, tuple(c[:, i:i + 1, None] for c in dinv))
        for c, xc in zip(x, xi):
            c[:, i:i + 1, :] = xc
    return tuple(x)


_PLAIN = (limb_extract_plain, limb_gemm_plain, chol_plain, tri_solve_plain)


# ---------------------------------------------------------------------------
# wrappers: plain version for CPU tensors, the CUDA kernel for CUDA tensors
# ---------------------------------------------------------------------------

def _route(t):
    """True for CUDA tensors; False for CPU; raises for anything else."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel route for device {t.device}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check_words(words, name):
    nw = len(words)
    if nw not in KERNEL_NW:
        raise ValueError(f"{name}: CUDA kernels are built for nw in "
                         f"{KERNEL_NW}, got {nw}")
    for c in words:
        if c.dtype != torch.float32 or not c.is_cuda:
            raise ValueError(f"{name}: words must be float32 CUDA tensors")
        if c.shape != words[0].shape or c.device != words[0].device:
            raise ValueError(f"{name}: words differ in shape or device")


def _stack(words):
    return torch.stack(words, dim=1).contiguous()


def _unstack(w):
    return tuple(w[:, i] for i in range(w.shape[1]))


def _launched(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({_cuda_error_name(rc)})")


def _cuda_error_name(rc):
    from .build import library

    return library().clrs_error_string(rc).decode()


def limb_extract(words, L, side):
    """Scaled L-limb int8 form of nw f32 words [B, d0, d1]; see
    :func:`limb_extract_plain` for the contract."""
    if side not in ("a", "b"):
        raise ValueError(side)
    if not _route(words[0]):
        return limb_extract_plain(words, L, side)
    from .build import library

    _check_words(words, "limb_extract")
    W = _stack(words)
    Bt, nw, d0, d1 = W.shape
    if L != limb_params(nw)[0]:
        raise ValueError(f"limb_extract: L={L} does not match nw={nw}")
    limbs = torch.empty((Bt, L, d0, d1), dtype=torch.int8, device=W.device)
    eshape = (Bt, d0, 1) if side == "a" else (Bt, 1, d1)
    e = torch.empty(eshape, dtype=torch.int32, device=W.device)
    rc = library().clrs_limb_extract(_ptr(W), _ptr(limbs), _ptr(e), Bt, nw,
                                     d0, d1, int(side == "a"), _stream())
    _launched(rc, "limb_extract")
    limb_extract.launches += 1
    return limbs, e


def limb_gemm(a3, b3, eab, nw):
    """nw f32 words [B, m, n] of the limb product; see
    :func:`limb_gemm_plain` for the contract."""
    if not _route(a3):
        return limb_gemm_plain(a3, b3, eab, nw)
    from .build import library

    if nw not in KERNEL_NW:
        raise ValueError(f"limb_gemm: kernels are built for nw in "
                         f"{KERNEL_NW}, got {nw}")
    L, _ = limb_params(nw)
    Bt, La, m, k = a3.shape
    n = b3.shape[3]
    if (a3.dtype != torch.int8 or b3.dtype != torch.int8
            or eab.dtype != torch.int32 or La != L
            or b3.shape != (Bt, L, k, n) or eab.shape != (Bt, m, n)
            or not (b3.is_cuda and eab.is_cuda)):
        raise ValueError(f"limb_gemm: bad operands {a3.shape} {a3.dtype} "
                         f"{b3.shape} {b3.dtype} {eab.shape} {eab.dtype}")
    a3, b3, eab = a3.contiguous(), b3.contiguous(), eab.contiguous()
    out = torch.empty((Bt, nw, m, n), dtype=torch.float32, device=a3.device)
    rc = library().clrs_limb_gemm(_ptr(a3), _ptr(b3), _ptr(eab), _ptr(out),
                                  Bt, m, k, n, nw, _stream())
    _launched(rc, "limb_gemm")
    limb_gemm.launches += 1
    return _unstack(out)


def chol_batched(a):
    """Batched expansion Cholesky; see :func:`chol_plain`."""
    if not _route(a[0]):
        return chol_plain(a)
    from .build import library

    _check_words(a, "chol_batched")
    W = _stack(a)
    Bt, nw, n, n2 = W.shape
    if n != n2:
        raise ValueError(f"chol_batched: matrices must be square, got {n}x{n2}")
    out = torch.empty_like(W)
    ok = torch.empty((Bt,), dtype=torch.int32, device=W.device)
    rc = library().clrs_chol(_ptr(W), _ptr(out), _ptr(ok), Bt, n, nw,
                             _stream())
    _launched(rc, "chol_batched")
    chol_batched.launches += 1
    return _unstack(out), ok != 0


def tri_solve_batched(l, b, trans=False):
    """Batched triangular solve with the lower factor; see
    :func:`tri_solve_plain`."""
    if not _route(l[0]):
        return tri_solve_plain(l, b, trans)
    from .build import library

    _check_words(l, "tri_solve_batched")
    _check_words(b, "tri_solve_batched")
    Lw, Bw = _stack(l), _stack(b)
    Bt, nw, n, _ = Lw.shape
    m = Bw.shape[3]
    if Lw.shape[3] != n or Bw.shape[:3] != (Bt, nw, n):
        raise ValueError(f"tri_solve_batched: {Lw.shape} vs {Bw.shape}")
    x = torch.empty_like(Bw)
    work = Bw.clone() if not trans else x
    rc = library().clrs_tri_solve(_ptr(Lw), _ptr(Bw), _ptr(x), _ptr(work),
                                  Bt, n, m, nw, int(trans), _stream())
    _launched(rc, "tri_solve_batched")
    tri_solve_batched.launches += 1
    return _unstack(x)


_COUNTED = (limb_extract, limb_gemm, chol_batched, tri_solve_batched)
for _f in _COUNTED:
    _f.launches = 0
