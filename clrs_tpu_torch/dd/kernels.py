"""The hand-written CUDA kernels of the f32-expansion IPM, their wrappers,
their plain PyTorch versions and their launch counters.

Each wrapper takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches its kernel (built from ``csrc/`` at first use,
:mod:`.build`) or raises: there is no fallback. ``<wrapper>.launches``
counts kernel launches and ``<plain>.calls`` counts plain-version calls,
so a run can show which route it took (:func:`reset_counts`,
:func:`counts`).

| wrapper            | kernel (csrc/kernels.cu unless named) | replaces (clrs_tpu/dd/pallas_linalg.py) |
|--------------------|----------------------------|------------------------------------------------|
| limb_extract       | limb_extract<NW>           | _extract_call / pl_extract (all four layouts)  |
| limb_gemm          | limb_gemm_fused (limb_gemm.cu) | _limb_gemm_fused_call / pl_limb_gemm_fused |
| int8_gemm          | int8_gemm (int8_gemm.cu)   | the XLA int8 dot_general (limb_gemm.py:307)    |
| cascade_from_c     | cascade<FROM_C>            | _cascade_tiles(_grid)_call / pl_cascade_tiles(_grid) |
| cascade_from_diags | cascade<FROM_DIAGS>        | _cascade_call / pl_cascade                     |
| chol_batched       | chol_batched (chol.cu)     | _chol_call / pl_cholesky_b                     |
| tri_solve_batched  | tri_solve_batched<TRANS>   | _tril_call, _tril_t_call / pl_solve_tril(_t)_b |
| plmap_add          | plmap<NW, 0>               | pl_map, corrector sum (solver/step.py:1556)    |
| plmap_axpy         | plmap<NW, 1>               | pl_map, state update (solver/step.py:1244)     |
| plmap_residual     | plmap<NW, 2 or 3>          | pl_map, residual R (solver/step.py:1387)       |
| ew_add, ew_sub, ew_mul, ew_div, ew_neg, ew_symmetrize | expmap<NW, OP> (expmap.cu) | XLA-fused expops (dd/core.py:448-499) |
| tree_sum, tree_sum_fused | tree_sum<NW, PRO> (exptree.cu) | XLA-fused dd_sum (dd/linalg.py:110-127) and the products and adds around it |
| ew_fma, ew_fms, ew_msub, ew_mms, ew_sub2 | expfuse<NW, FORM> (expfuse.cu) | XLA-fused chains of expops (solver/step.py:1621) |
| ew_select          | expselect<NW> (expfuse.cu) | the commit's jnp.where (solver/step.py:1661-1666) |
| expf64_sum, expf64_max_abs, expf64_split | expf64<NW, FORM> (expf64.cu) | XLA-fused _f64sum, dd_max_abs and _scalar_split (solver/step.py:104-140, dd/linalg.py:136-144) |
| eig_lowest         | eig_lowest (eig.cu)        | jnp.linalg.eigvalsh(A64) in the jitted step off the TPU (solver/step.py:1163) |
| eig_pairs          | eig_pairs (eig.cu): the sweeps on A | jnp.linalg.eigh(A32), XLA's Jacobi, in the jitted TPU step (solver/step.py:1123) |
| eig_pairs_vec      | eig_pairs_vec (eig.cu): the eigenvectors, the sweeps' rotations replayed on V = I | the same call's eigenvectors |

The eigensolver kernels take float64 (eig_lowest) and float32 (eig_pairs)
matrices, not words; the expf64 forms take f32 words of any count 1..8
(and the split a float64 tensor), and leave f64 words, which they do not
convert, to their plain versions. The others are built for nw = 5..8, the
f32 substrate's ladder; besides, limb_extract takes operands of 1..8 words to
the limb count L its caller gives, and limb_gemm and cascade_from_c take
nw = 2: the word counts of the certified step-length route
(clrs_tpu/solver/step.py:1096-1143).

The two forms of tri_solve_batched are also counted apart
(``tri_solve_batched.launches_by_form``, keyed by ``trans``, and in
:func:`counts` under their kernels' names).

Operands are word tuples with a leading batch axis, as the JAX kernels'
[L] grid axis; most kernels take them stacked word-major, [B, nw, ...];
the ``plmap_*`` chains, the ``ew_*`` ops and the tree sums read each word
where it lies, through its strides (``ew_*`` over any broadcast shape,
``tree_sum``/``tree_sum_fused`` along any axis or run of consecutive
axes); ``ew_select`` writes its destinations in place.

The fused forms' plain versions compose the functions the plain versions
of the fused ops run (``ew_fma_plain`` is ``ops.exp_mul`` then
``ops.exp_add``), so each plain counter counts its own route only and the
CPU's counters name the kernels the card launches.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
import weakref

import torch

from . import ops as O
from .f64ops import sqrt_rn
from .slice_gemm import _pow2

LIMB_BITS = 7
KERNEL_NW = (5, 6, 7, 8)   # word counts the CUDA kernels are built for
# limb_gemm and cascade_from_c also at nw 2, the product V^T V of the
# certified step-length route (clrs_tpu/solver/step.py:1137); limb_extract
# takes an operand of any word count 1..8 to the limb count its caller gives
PRODUCT_NW = (2,) + KERNEL_NW
OPERAND_NW = tuple(range(1, 9))
MAX_LIMBS = 48             # fx_matmul's bound: int32 diagonal sums stay exact
INT8_GEMM_MAX_K = 1 << 13  # csrc/common.cuh MAX_K_EXACT: |C| < 2^31 for limbs <= 65
_MAX_NW = 8                # csrc/kernels.cu MAX_NW


def limb_params(nw):
    """(L limbs, ndiag kept diagonals) for an nw-word product
    (clrs_tpu/dd/limb_gemm.py:233-241)."""
    bits = 24 * nw + 21
    L = -(-bits // LIMB_BITS)
    return L, min(2 * L - 1, bits // LIMB_BITS + 1)


# the two forms of tri_solve_batched, counted apart: trans -> kernel name
TRI_FORMS = {False: "tri_solve_batched<false>", True: "tri_solve_batched<true>"}


class ReplayTally:
    """The launches a captured graph's capture counted ({name: n}, named as
    :func:`counts` names them) and its replays since the last
    :func:`reset_counts`; ``owner`` is a weak reference to the graph's
    holder. :func:`counts` adds launches x replays when it is read, so a
    replay only increments ``replays``."""

    __slots__ = ("launches", "replays", "owner")

    def __init__(self, owner, launches):
        self.launches = launches
        self.replays = 0
        self.owner = weakref.ref(owner)


_TALLIES = []


def replay_tally(owner, launches):
    """A new :class:`ReplayTally`, read by :func:`counts` from now on.
    The tallies of graphs that are gone are folded into the counters and
    dropped, so a long-lived process keeps only the live ones."""
    live = []
    for t in _TALLIES:
        if t.owner() is not None:
            live.append(t)
        elif t.replays:
            add_counts(t.launches, t.replays)
    _TALLIES[:] = live
    t = ReplayTally(owner, launches)
    _TALLIES.append(t)
    return t


def reset_counts():
    for f in _COUNTED:
        f.launches = 0
    tri_solve_batched.launches_by_form = dict.fromkeys(TRI_FORMS, 0)
    for f in _PLAIN:
        f.calls = 0
    # a graph that is gone replays no more: its tally can go too
    _TALLIES[:] = [t for t in _TALLIES if t.owner() is not None]
    for t in _TALLIES:
        t.replays = 0


def counts():
    """{name: launches} for the kernels (and for each form of
    tri_solve_batched under its kernel's name) and {name_plain: calls} for
    the plain versions, the replays of captured graphs included."""
    out = {f.__name__: f.launches for f in _COUNTED}
    out.update({TRI_FORMS[t]: v
                for t, v in tri_solve_batched.launches_by_form.items()})
    out.update({f.__name__: f.calls for f in _PLAIN})
    for t in _TALLIES:
        if t.replays:
            for name, n in t.launches.items():
                out[name] += n * t.replays
    return out


def launch_total():
    """Kernel launches counted by the wrappers so far (each launch once,
    replays of captured graphs left out)."""
    return sum(f.launches for f in _COUNTED)


def add_counts(delta, times=1):
    """Add ``times`` x ``delta`` ({name: n}, named as :func:`counts` names
    them) to the counters (:mod:`clrs_tpu_torch.solver.graph` takes a
    capture's counts back out with ``times`` -1)."""
    forms = {name: t for t, name in TRI_FORMS.items()}
    fns = {f.__name__: f for f in _COUNTED + _PLAIN}
    for name, n in delta.items():
        if name in forms:
            tri_solve_batched.launches_by_form[forms[name]] += times * n
        elif name in _COUNTED_NAMES:
            fns[name].launches += times * n
        else:
            fns[name].calls += times * n


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


@functools.lru_cache(maxsize=None)
def tree_table(n):
    """:func:`_tree_schedule` (n) flattened as the transposed solve kernel
    reads it: (int32 table, H heights). The table holds H + 1 node offsets
    (0, then the running count of nodes per height: the nodes of height
    h + 1 are entries off[h] .. off[h + 1] - 1), then (left, right, out) of
    each of the n - 1 nodes in the schedule's order; the last node is the
    root (leaf 0 when n = 1)."""
    sched, _, _ = _tree_schedule(n)
    offs, nodes = [0], []
    for a, b, o in sched:
        offs.append(offs[-1] + len(a))
        nodes.extend(v for t in zip(a, b, o) for v in t)
    return torch.tensor(offs + nodes, dtype=torch.int32), len(sched)


@functools.lru_cache(maxsize=None)
def _tree_table_on(n, device):
    """:func:`tree_table` (n) on ``device``, copied there once."""
    table, H = tree_table(n)
    return table.to(device), H


def _pad3(shape):
    """[L, *dims] (at most two dims) -> [L, D1, D2], the dims padded with
    leading ones as pl_map pads its blocks to 2-D (pallas_linalg.py:712-723)."""
    if not 1 <= len(shape) <= 3:
        raise ValueError(f"pl_map chains take [L] + at most 2 dims, got "
                         f"{tuple(shape)}")
    return tuple(shape[:1]) + (1,) * (3 - len(shape)) + tuple(shape[1:])


def _as3(c):
    return c.reshape(_pad3(c.shape))


def _chain_shape(ops):
    """(broadcast [L, D1, D2], output shape [L, *dims]) of pl_map operands:
    the dims broadcast across all words (a [L, 1, 1] scalar may come
    first)."""
    shapes = [c.shape for op in ops for c in op]
    dims = O.broadcast_shapes(*(s[1:] for s in shapes))
    L = O.broadcast_shapes(*(s[:1] for s in shapes))
    return _pad3(tuple(L) + tuple(dims)), tuple(L) + tuple(dims)


# ---------------------------------------------------------------------------
# plain versions (CPU tensors; the tests and chip_smoke's comparisons)
# ---------------------------------------------------------------------------

@_counted_plain
def limb_extract_plain(words, L, side, layout="limb"):
    """words: nw f32 [B, d0, d1] -> (int8 limbs, int32 exps [B, d0, 1] for
    side 'a' (per row) or [B, 1, d1] for side 'b' (per column)).

    ``layout="limb"``: limbs [B, L, d0, d1] (pl_extract 'a3'/'b3');
    ``layout="gemm"``: the GEMM operands of the split route, [B, L d0, d1]
    for side 'a' and [B, d0, L d1] for side 'b' (pl_extract 'a'/'b').

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
    limbs = torch.stack(limbs, dim=1)
    return _layout(limbs, side, layout), e


def _layout(limbs, side, layout):
    """Limb-major [B, L, d0, d1] -> the requested layout."""
    if layout == "limb":
        return limbs
    if layout != "gemm":
        raise ValueError(f"layout must be 'limb' or 'gemm', got {layout!r}")
    Bt, L, d0, d1 = limbs.shape
    if side == "a":
        return limbs.reshape(Bt, L * d0, d1)
    return limbs.permute(0, 2, 1, 3).reshape(Bt, d0, L * d1)


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


def _int8_product(a, b):
    """Exact int32 batched product of int8 [B, M, K] and [B, K, N]: one
    float64 GEMM, whose partial sums are integers below 2^53."""
    return torch.bmm(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def _diags_from_c(C, L, m, n, ndiag):
    """int32 diagonal sums D[d] = sum_{ta+tb=d} C[ta m:(ta+1) m,
    tb n:(tb+1) n] of C [B, L m, L n] (exact int32 adds)."""
    C5 = C.reshape(C.shape[0], L, m, L, n)
    diags = []
    for d in range(ndiag):
        acc = None
        for ta in range(max(0, d - (L - 1)), min(d, L - 1) + 1):
            t = C5[:, ta, :, d - ta, :]
            acc = t if acc is None else acc + t
        diags.append(acc)
    return diags


@_counted_plain
def limb_gemm_plain(a3, b3, eab, nw):
    """a3 int8 [B, L, m, k], b3 int8 [B, L, k, n], eab int32 [B, m, n] ->
    nw f32 words [B, m, n]. The limb products run as ONE exact GEMM
    (limbs <= 65, k <= 2^13); diagonal sums D[d] = sum_{ta+tb=d} A[ta]
    B[tb] are then exact int32, as in the int8 MXU path."""
    Bt, L, m, k = a3.shape
    n = b3.shape[3]
    _, ndiag = limb_params(nw)
    C = _int8_product(a3.reshape(Bt, L * m, k),
                      b3.permute(0, 2, 1, 3).reshape(Bt, k, L * n))
    return _cascade(_diags_from_c(C, L, m, n, ndiag), eab, nw)


@_counted_plain
def int8_gemm_plain(a, b):
    """int8 [B, M, K] @ int8 [B, K, N] -> exact int32 [B, M, N]."""
    return _int8_product(a, b)


@_counted_plain
def cascade_from_c_plain(C, eab, nw):
    """C int32 [B, L m, L n] (limb-major row and column blocks), eab int32
    [B, m, n] -> nw f32 words [B, m, n] (pl_cascade_tiles(_grid))."""
    L, ndiag = limb_params(nw)
    m, n = C.shape[1] // L, C.shape[2] // L
    return _cascade(_diags_from_c(C, L, m, n, ndiag), eab, nw)


@_counted_plain
def cascade_from_diags_plain(diags, eab, nw):
    """diags int32 [B, ndiag, m, n], eab int32 [B, m, n] -> nw f32 words
    [B, m, n] (pl_cascade)."""
    return _cascade(list(diags.unbind(1)), eab, nw)


def _full(res, shape3, out_shape):
    return tuple(c.expand(shape3).reshape(out_shape) for c in res)


@_counted_plain
def plmap_add_plain(x, d):
    """exp_add(x, d) over [L, *dims] words with pl_map's broadcasting
    (the corrector sum X + dX, clrs_tpu/solver/step.py:1556-1568)."""
    shape3, out_shape = _chain_shape([x, d])
    x, d = (tuple(_as3(c) for c in op) for op in (x, d))
    return _full(O.exp_add(x, d), shape3, out_shape)


@_counted_plain
def plmap_axpy_plain(x, d, a):
    """X + alpha dX with alpha as three words (``a``, typically [L, 1, 1])
    padded to nw by a[0] * 0, the fused form of
    clrs_tpu/solver/step.py:1248-1255."""
    shape3, out_shape = _chain_shape([x, d, a])
    x, d, a = (tuple(_as3(c) for c in op) for op in (x, d, a))
    z = a[0] * 0.0
    af = tuple(a) + (z,) * (len(x) - len(a))
    return _full(O.exp_add(x, O.exp_mul(d, af)), shape3, out_shape)


@_counted_plain
def plmap_residual_plain(mu, mask, xy, dxdy=None):
    """R = mask (mu I - XY [- dX dY]) with mu I formed word by word as
    mu * eye (clrs_tpu/solver/step.py:1391-1406); ``mask`` is one f32
    tensor, ``mu`` words are typically [L, 1, 1]."""
    ops = [mu, (mask,), xy] + ([dxdy] if dxdy is not None else [])
    shape3, out_shape = _chain_shape(ops)
    if shape3[1] != shape3[2]:
        raise ValueError(f"residual chain needs square blocks, got {shape3}")
    mu, (mask,), xy = (tuple(_as3(c) for c in op) for op in ops[:3])
    eye = torch.eye(shape3[2], dtype=torch.float32, device=xy[0].device)
    r = O.exp_sub(tuple(mw * eye for mw in mu), xy)
    if dxdy is not None:
        r = O.exp_sub(r, tuple(_as3(c) for c in dxdy))
    return _full(tuple(c * mask for c in r), shape3, out_shape)


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


def pairwise_sum(x, axis, add):
    """Tree sum of expansion words along ``axis`` with the expansion add
    ``add`` (clrs_tpu/dd/linalg.py:110-127: the same pairing order): at
    each level of n entries, entry i < n // 2 becomes add(entry i, entry
    ceil(n / 2) + i) and the odd middle entry is carried. n = 0 gives
    zeros."""
    ws = [c.movedim(axis, 0) for c in x]
    n = ws[0].shape[0]
    while n > 1:
        half = (n + 1) // 2
        a = tuple(c[:n // 2] for c in ws)
        b = tuple(c[half:half + n // 2] for c in ws)
        s = add(a, b)
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


@_counted_plain
def ew_add_plain(x, y):
    return O.exp_add(x, y)


@_counted_plain
def ew_sub_plain(x, y):
    return O.exp_sub(x, y)


@_counted_plain
def ew_mul_plain(x, y):
    return O.exp_mul(x, y)


@_counted_plain
def ew_div_plain(x, y):
    return O.exp_div(x, y)


@_counted_plain
def ew_neg_plain(x):
    return O.exp_neg(x)


@_counted_plain
def ew_symmetrize_plain(x):
    """(x + x^T) / 2 over the last two axes: exp_add, then an exact
    halving of each word (clrs_tpu_torch/dd/linalg.py dd_symmetrize)."""
    s = O.exp_add(x, tuple(c.transpose(-1, -2) for c in x))
    return tuple(0.5 * c for c in s)


@_counted_plain
def tree_sum_plain(x, axis):
    return pairwise_sum(x, axis, O.exp_add)


def flatten_sum_axes(p, axis):
    """(words, axis): an int ``axis`` as it is; several consecutive axes
    (or None, all) moved to the end and reshaped to one, row-major, as the
    step's callers reshape them before a tree sum."""
    if isinstance(axis, int):
        return p, axis
    shape = tuple(O.broadcast_shapes(*(c.shape for c in p)))
    a0, a1 = sum_axes(axis, len(shape)) if shape else (0, 0)
    tail = tuple(range(len(shape) - (a1 - a0), len(shape)))
    return tuple(c.expand(shape).movedim(tuple(range(a0, a1)), tail)
                 .reshape(shape[:a0] + shape[a1:] + (-1,)) for c in p), -1


def _scaled(x, s):
    """Each word times an exact word or float (solver/step.py _dd_scale)."""
    return tuple(c * s for c in x)


def _masked(r, mask):
    return r if mask is None else _scaled(r, mask)


# The fused forms' plain versions compose the same functions as the plain
# versions of the ops they fuse (ops.exp_*, pairwise_sum), not those counted
# plain versions: each counter counts its own route, as on the card.

@_counted_plain
def tree_sum_fused_plain(x, y, axis, acc=None, sub=False, scale=None,
                         scale_on=None):
    """acc +- tree sum over ``axis`` of x y (or x), with x or the product
    scaled as ``scale_on`` says: the plain ew_mul, tree_sum and ew_add or
    ew_sub in turn. Several consecutive axes (or None, all) are reshaped
    to one, row-major, as the step's callers reshape them."""
    if scale_on == "x":
        x = _scaled(x, scale)
    p = O.exp_mul(x, y) if y is not None else x
    if scale_on == "product":
        p = _scaled(p, scale)
    p, axis = flatten_sum_axes(p, axis)
    s = pairwise_sum(p, axis, O.exp_add)
    if acc is not None:
        s = (O.exp_sub if sub else O.exp_add)(acc, s)
    return s


@_counted_plain
def ew_fma_plain(a, b, c, mask=None):
    """(a + b c) [mask]: the plain ew_mul, then ew_add, then the mask."""
    return _masked(O.exp_add(a, O.exp_mul(b, c)), mask)


@_counted_plain
def ew_fms_plain(a, b, c, mask=None):
    """(a - b c) [mask]: the plain ew_mul, then ew_sub, then the mask."""
    return _masked(O.exp_sub(a, O.exp_mul(b, c)), mask)


@_counted_plain
def ew_msub_plain(a, b, c, mask=None):
    """(a b - c) [mask]: the plain ew_mul, then ew_sub, then the mask."""
    return _masked(O.exp_sub(O.exp_mul(a, b), c), mask)


@_counted_plain
def ew_mms_plain(a, b, c, d, mask=None):
    """(a b - c d) [mask]: two plain ew_mul, ew_sub, then the mask."""
    return _masked(O.exp_sub(O.exp_mul(a, b), O.exp_mul(c, d)), mask)


@_counted_plain
def ew_sub2_plain(a, b, c, c_scale=None, mask=None):
    """((a - b) - c s) [mask]: two plain ew_sub, c's words scaled first."""
    cs = c if c_scale is None else _scaled(c, c_scale)
    return _masked(O.exp_sub(O.exp_sub(a, b), cs), mask)


@_counted_plain
def ew_select_plain(cond, pairs):
    """dst = torch.where(cond, src, dst), word by word, copied into dst
    (the commit's select and assignment)."""
    pairs = list(pairs)
    for src, dst in pairs:
        for d, c in zip(dst, src):
            d.copy_(torch.where(cond, c, d))
    return [dst for _, dst in pairs]


# ---------------------------------------------------------------------------
# the step-length eigensolver (csrc/eig.cu): plain versions, op for op
# ---------------------------------------------------------------------------

@_counted_plain
def expf64_sum_plain(x):
    """Multi-word value -> float64 (exact word casts, summed in f64), f32
    or f64 words (clrs_tpu/solver/step.py:131-138)."""
    out = x[0].to(torch.float64)
    for c in x[1:]:
        out = out + c.to(torch.float64)
    return out


@_counted_plain
def expf64_max_abs_plain(x, acc=None):
    """max |x| as a float64 tensor (error reporting only: words are summed
    in f64; clrs_tpu/dd/linalg.py:136-144), 0 for an empty x;
    torch.maximum(acc, max |x|) with an accumulator."""
    s = x[0].to(torch.float64)
    for c in x[1:]:
        s = s + c.to(torch.float64)
    if s.numel() == 0:
        m = torch.zeros((), dtype=torch.float64, device=s.device)
    else:
        m = s.abs().max()
    return m if acc is None else torch.maximum(acc, m)


@_counted_plain
def expf64_split_plain(v, nw):
    """float64 tensor -> nw f32 words: up to three by successive rounding,
    so the full f64 value enters the expansion arithmetic, then +0 words
    (clrs_tpu/solver/step.py:104-122, f32 words)."""
    words = []
    r = v
    for _ in range(min(nw, 3)):
        w = r.to(torch.float32)
        words.append(w)
        r = r - w.to(torch.float64)
    words += [torch.zeros_like(words[0])] * (nw - len(words))
    return tuple(words)


EIG_LO_THREADS = 512        # csrc/eig.cu LO_THREADS: the shifts of a round
EIG_LO_MAX_ROUNDS = 10      # csrc/eig.cu LO_MAX_ROUNDS
EIG_PAIRS_THREADS = 1024    # csrc/eig.cu PR_SUM: the partials of its sums
EIG_PAIRS_MAX_SWEEPS = 30   # csrc/eig.cu PR_MAX_SWEEPS
EIG_PAIRS_MAX_N = 2048      # csrc/eig.cu PR_MAX_N: the kernels take n <= 2048
_EPS64 = 2.0 ** -52
_DBL_MIN = 2.0 ** -1022
_PAIRS_TOL2 = 2.0 ** -48    # off(A)^2 <= 2^-48 ||A||_F^2 ends the sweeps


def strided_sum(x, T):
    """Sum over the last axis as T threads (a power of two) take it: thread
    t adds the terms t, t + T, ... in order from +0, then the halving tree
    of the partials, p[t] + p[t + T/2] for t < T/2 and so on down to one
    (T = 32: one warp's lane sum; the kernels' block and lane trees)."""
    m = x.shape[-1]
    R = -(-m // T)
    if R * T != m:
        x = torch.nn.functional.pad(x, (0, R * T - m))
    x = x.reshape(*x.shape[:-1], R, T)
    acc = torch.zeros(x.shape[:-2] + (T,), dtype=x.dtype, device=x.device)
    for r in range(R):
        acc = acc + x[..., r, :]
    while T > 1:
        T //= 2
        acc = acc[..., :T] + acc[..., T:2 * T]
    return acc[..., 0]


@_counted_plain
def eig_lowest_plain(A):
    """Lowest eigenvalue of each member of a float64 batch A [B, n, n]
    (finite, symmetric): csrc/eig.cu's eig_lowest op for op. An exact
    power-of-two scaling by max |a_ij|, Householder tridiagonalization
    (dsytd2's, warp-sum order), then multisection of the Sturm counts
    over EIG_LO_THREADS shifts a round; see the source's header."""
    B, n = A.shape[0], A.shape[-1]
    if n == 1 or B == 0:
        return A[:, 0, 0].clone() if n else A.new_zeros((B,))
    f64, dev = torch.float64, A.device
    amax = A.abs().amax(dim=(1, 2))
    zero = amax == 0
    ex = torch.frexp(amax)[1].clamp(-1000, 1000)
    S = A * _pow2(-ex)[:, None, None]
    e = []
    for k in range(n - 1):
        m = n - 1 - k
        x = S[:, k, k + 1:]
        alpha = x[:, 0]
        xt = x[:, 1:]
        sigma = strided_sum(xt * xt, 32)
        skip = sigma == 0
        mu = sqrt_rn(alpha * alpha + sigma)
        beta = torch.where(alpha >= 0, -mu, mu)
        tau = (beta - alpha) / beta
        den = alpha - beta
        e.append(torch.where(skip, alpha, beta))
        if bool(skip.all()):
            continue
        v = torch.cat([torch.ones_like(alpha)[:, None], xt / den[:, None]],
                      dim=1)
        S22 = S[:, k + 1:, k + 1:]
        p = tau[:, None] * strided_sum(S22 * v[:, None, :], 32)
        kk = (0.5 * tau) * strided_sum(p * v, 32)
        w = p - kk[:, None] * v
        upd = S22 - (v[:, :, None] * w[:, None, :] + w[:, :, None] * v[:, None, :])
        S = S.clone()
        S[:, k + 1:, k + 1:] = torch.where(skip[:, None, None], S22, upd)
    d = torch.diagonal(S, dim1=1, dim2=2)
    e = torch.stack(e, dim=1)
    ea = e.abs()
    z = torch.zeros((B, 1), dtype=f64, device=dev)
    r = torch.cat([z, ea], dim=1) + torch.cat([ea, z], dim=1)
    gl = (d - r).amin(dim=1)
    gu = (d + r).amax(dim=1)
    e2 = e * e
    tnorm = torch.maximum(gl.abs(), gu.abs())
    pivmin = _DBL_MIN * torch.clamp(e2.amax(dim=1), min=1.0)
    wid = ((2.0 * _EPS64) * tnorm) * float(n)
    lo = (gl - wid) - 2.0 * pivmin
    hi = (gu + wid) + 2.0 * pivmin
    tol = _EPS64 * tnorm
    T = EIG_LO_THREADS
    shifts = torch.arange(1, T + 1, dtype=f64, device=dev)
    idx = torch.arange(T, device=dev)
    active = ~zero
    piv = pivmin[:, None]
    for _ in range(EIG_LO_MAX_ROUNDS):
        active = active & ~(hi - lo <= tol)
        if not bool(active.any()):
            break
        # a tensor divisor: PyTorch multiplies a CUDA tensor by the
        # reciprocal of a host scalar, two roundings
        h = (hi - lo) / torch.full_like(hi, float(T + 1))
        xs = lo[:, None] + shifts[None, :] * h[:, None]
        q = d[:, :1] - xs
        q = torch.where(q.abs() < piv, -piv, q)
        c = (q <= 0).to(torch.int32)
        for j in range(1, n):
            q = (d[:, j:j + 1] - e2[:, j - 1:j] / q) - xs
            q = torch.where(q.abs() < piv, -piv, q)
            c = c + (q <= 0).to(torch.int32)
        t = torch.where(c >= 1, idx, T).amin(dim=1)
        nhi = torch.where(t < T, lo + (t + 1).to(f64) * h, hi)
        nlo = torch.where(t > 0, lo + t.to(f64) * h, lo)
        lo = torch.where(active, nlo, lo)
        hi = torch.where(active, nhi, hi)
    lam = ((lo + hi) * 0.5) * _pow2(ex)
    return torch.where(zero, 0.0, lam)


def jacobi_pairs(N):
    """The round-robin pairs of csrc/eig.cu's eig_pairs for even N: for
    each of the N - 1 rounds, (p [N/2], q [N/2]) with p < q."""
    rounds = []
    for r in range(N - 1):
        pos = [0] + [(i - 1 + r) % (N - 1) + 1 for i in range(1, N)]
        pr = [(min(pos[k], pos[N - 1 - k]), max(pos[k], pos[N - 1 - k]))
              for k in range(N // 2)]
        rounds.append(tuple(torch.tensor(c) for c in zip(*pr)))
    return rounds


def jacobi_next_block(P, k):
    """The block (ia, ib), ia >= ib, of round r that holds round r + 1's
    a_pq of pair k, for P pairs (csrc/eig.cu next_block): round r + 1's
    pair k is (the x of pair k + 1, the y of pair k - 1) of round r; pair
    0 keeps position 0 and takes the x of pair 1, pair P - 1 takes the y
    of pairs P - 1 and P - 2; with P = 1 it is the diagonal block, whose
    a_pq the round set to zero."""
    if P == 1:
        return 0, 0
    if k == 0:
        return 1, 0
    if k == P - 1:
        return P - 1, P - 2
    return k + 1, k - 1


def eig_pairs_log_layout(n):
    """(G rounds, P pairs, offset of the sweep count) of a member's
    rotation log in doubles (csrc/eig.cu log_layout): (c, s) of round g's
    pair k at 2 (g P + k), g < EIG_PAIRS_MAX_SWEEPS (N - 1); then the
    sweep count and the n ranks."""
    N = n + (n & 1)
    P = N // 2
    G = EIG_PAIRS_MAX_SWEEPS * (N - 1)
    return G, P, 2 * G * P


def _rotation(app, aqq, apq):
    """(c, s, t) in float64 of the Jacobi rotation that zeroes a_pq, as
    csrc/eig.cu forms it from the float32 entries; the identity where
    a_pq = 0."""
    one = torch.ones_like(apq)
    theta = (aqq - app) / (2.0 * apq)
    at = theta.abs()
    t = one / (at + sqrt_rn(at * at + 1.0))
    t = torch.where(theta < 0, -t, t)
    c = one / sqrt_rn(t * t + 1.0)
    s = t * c
    rot = apq != 0
    return (torch.where(rot, c, one), torch.where(rot, s, 0.0),
            torch.where(rot, t, 0.0))


@_counted_plain
def eig_pairs_plain(A):
    """float32 eigenpairs of each member of A [B, n, n] (finite,
    symmetric): ascending eigenvalues [B, n] and eigenvectors as columns
    [B, n, n], csrc/eig.cu's eig_pairs op for op: cyclic Jacobi in
    round-robin order on float32 entries, rotations formed and applied in
    float64 (each 2 x 2 block by rows, then columns, rounded once and
    mirrored), V accumulated in float64 and rounded at the end; the sweeps
    end on a float64 off-norm test; a stable sort by eigenvalue. See the
    source's header."""
    B, n = A.shape[0], A.shape[-1]
    f64, dev = torch.float64, A.device
    N = n + (n & 1)
    P = N // 2
    As = torch.zeros((B, N, N), dtype=A.dtype, device=dev)
    As[:, :n, :n] = A
    V = torch.eye(N, dtype=f64, device=dev).expand(B, N, N).clone()
    T = EIG_PAIRS_THREADS

    def sq(x):
        x = x.to(f64)
        return x * x

    fro2 = strided_sum(sq(As).reshape(B, -1), T)
    offdiag = ~torch.eye(N, dtype=torch.bool, device=dev)
    lower = torch.arange(P, device=dev)[:, None] > torch.arange(P, device=dev)
    kk = torch.arange(P, device=dev)
    rounds = [(p.to(dev), q.to(dev)) for p, q in jacobi_pairs(N)]
    active = torch.ones(B, dtype=torch.bool, device=dev)
    for _ in range(EIG_PAIRS_MAX_SWEEPS if B else 0):
        off2 = strided_sum(torch.where(offdiag, sq(As), 0.0).reshape(B, -1), T)
        active = active & ~(off2 <= _PAIRS_TOL2 * fro2)
        if not bool(active.any()):
            break
        for p, q in rounds:
            Ad = As.to(f64)
            app, aqq, apq = Ad[:, p, p], Ad[:, q, q], Ad[:, p, q]
            c, s, t = _rotation(app, aqq, apq)
            pc, pr = p[:, None], p[None, :]
            qc, qr = q[:, None], q[None, :]
            X11, X12 = Ad[:, pc, pr], Ad[:, pc, qr]
            X21, X22 = Ad[:, qc, pr], Ad[:, qc, qr]
            ca, sa = c[:, :, None], s[:, :, None]
            cb, sb = c[:, None, :], s[:, None, :]
            Y11, Y12 = ca * X11 - sa * X21, ca * X12 - sa * X22
            Y21, Y22 = sa * X11 + ca * X21, sa * X12 + ca * X22
            Z11, Z12 = cb * Y11 - sb * Y12, sb * Y11 + cb * Y12
            Z21, Z22 = cb * Y21 - sb * Y22, sb * Y21 + cb * Y22
            N11 = torch.where(lower, Z11, Z11.mT)
            N12 = torch.where(lower, Z12, Z21.mT)
            N21 = torch.where(lower, Z21, Z12.mT)
            N22 = torch.where(lower, Z22, Z22.mT)
            N11[:, kk, kk] = app - t * apq
            N22[:, kk, kk] = aqq + t * apq
            N12[:, kk, kk] = 0.0
            N21[:, kk, kk] = 0.0
            new = As.clone()
            new[:, pc, pr], new[:, pc, qr] = N11.to(A.dtype), N12.to(A.dtype)
            new[:, qc, pr], new[:, qc, qr] = N21.to(A.dtype), N22.to(A.dtype)
            V1, V2 = V[:, :, p], V[:, :, q]
            nV = V.clone()
            nV[:, :, p] = cb * V1 - sb * V2
            nV[:, :, q] = sb * V1 + cb * V2
            As = torch.where(active[:, None, None], new, As)
            V = torch.where(active[:, None, None], nV, V)
    lam = torch.diagonal(As, dim1=1, dim2=2)[:, :n]
    order = torch.sort(lam, dim=1, stable=True).indices
    vec = torch.gather(V[:, :n, :n], 2, order[:, None, :].expand(B, n, n))
    return (torch.gather(lam, 1, order).contiguous(),
            vec.to(A.dtype).contiguous())

@_counted_plain
def eig_pairs_vec_plain(log, n):
    """The eigenvectors [B, n, n] (float32, columns in the eigenvalues'
    order) from the rotation logs [B, >= meta + 1 + n] (float64) that
    csrc/eig.cu's eig_pairs leaves: csrc/eig.cu's eig_pairs_vec op for
    op, each member's logged rotations, identities included, replayed on
    V = I in float64 in round order (the V update of
    :func:`eig_pairs_plain`), rounded once and placed by rank."""
    B = log.shape[0]
    N = n + (n & 1)
    G, P, meta = eig_pairs_log_layout(n)
    f64, dev = torch.float64, log.device
    rot = log[:, :meta].reshape(B, G, P, 2)
    rounds = log[:, meta].to(torch.int64) * (N - 1)
    ranks = log[:, meta + 1:meta + 1 + n].to(torch.int64)
    V = torch.eye(N, dtype=f64, device=dev).expand(B, N, N).clone()
    pairs = [(p.to(dev), q.to(dev)) for p, q in jacobi_pairs(N)]
    for g in range(int(rounds.max()) if B else 0):
        p, q = pairs[g % (N - 1)]
        cb, sb = rot[:, g, None, :, 0], rot[:, g, None, :, 1]
        V1, V2 = V[:, :, p], V[:, :, q]
        nV = V.clone()
        nV[:, :, p] = cb * V1 - sb * V2
        nV[:, :, q] = sb * V1 + cb * V2
        V = torch.where((g < rounds)[:, None, None], nV, V)
    vec = torch.empty((B, n, n), dtype=torch.float32, device=dev)
    return vec.scatter_(2, ranks[:, None, :].expand(B, n, n),
                        V[:, :n, :n].to(torch.float32))


_PLAIN = (limb_extract_plain, limb_gemm_plain, int8_gemm_plain,
          cascade_from_c_plain, cascade_from_diags_plain, chol_plain,
          tri_solve_plain, plmap_add_plain, plmap_axpy_plain,
          plmap_residual_plain, ew_add_plain, ew_sub_plain, ew_mul_plain,
          ew_div_plain, ew_neg_plain, ew_symmetrize_plain, tree_sum_plain,
          tree_sum_fused_plain, ew_fma_plain, ew_fms_plain, ew_msub_plain,
          ew_mms_plain, ew_sub2_plain, ew_select_plain, eig_lowest_plain,
          eig_pairs_plain, eig_pairs_vec_plain, expf64_sum_plain,
          expf64_max_abs_plain, expf64_split_plain)


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


def _check_nw(nw, name, built=KERNEL_NW):
    if nw not in built:
        raise ValueError(f"{name}: CUDA kernels are built for nw in "
                         f"{built}, got {nw}")


def _check_words(words, name, built=KERNEL_NW):
    _check_nw(len(words), name, built)
    for c in words:
        if c.dtype != torch.float32 or not c.is_cuda:
            raise ValueError(f"{name}: words must be float32 CUDA tensors")
        if c.shape != words[0].shape or c.device != words[0].device:
            raise ValueError(f"{name}: words differ in shape or device")


def _refuse_f64(name, *ops):
    """Raise for f64 words on either route: the kernels and their plain
    versions compute on f32 words, and nothing casts f64 words to f32
    (the f64 substrate has its own forms, :mod:`.f64ops`)."""
    for op in ops:
        for c in op:
            if c.dtype == torch.float64:
                raise ValueError(f"{name}: f64 words are not an f32 "
                                 "kernel's input (use the f64 substrate's "
                                 "forms)")


def _check_int(name, *pairs):
    """Each (tensor, dtype, shape) must be a CUDA tensor of that dtype and
    shape."""
    for t, dtype, shape in pairs:
        if t.dtype != dtype or not t.is_cuda or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected a {dtype} CUDA tensor of "
                             f"shape {tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


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


def limb_extract(words, L, side, layout="limb"):
    """Scaled L-limb int8 form of nw f32 words [B, d0, d1]; see
    :func:`limb_extract_plain` for the contract and the layouts. L is the
    limb count of the product the operand goes into, apart from its own
    word count (nw 1..8, L 1..48), as ``pl_extract(a, L, ...)`` takes it."""
    if side not in ("a", "b"):
        raise ValueError(side)
    if layout not in ("limb", "gemm"):
        raise ValueError(f"layout must be 'limb' or 'gemm', got {layout!r}")
    _refuse_f64("limb_extract", words)
    if not _route(words[0]):
        return limb_extract_plain(words, L, side, layout)
    from .build import library

    _check_words(words, "limb_extract", OPERAND_NW)
    nw = len(words)
    Bt, d0, d1 = words[0].shape
    if not 1 <= L <= MAX_LIMBS:
        raise ValueError(f"limb_extract: L={L} outside 1..{MAX_LIMBS}")
    b_gemm = side == "b" and layout == "gemm"
    dev = words[0].device
    lshape = (Bt, d0, L * d1) if b_gemm else (Bt, L, d0, d1)
    limbs = torch.empty(lshape, dtype=torch.int8, device=dev)
    eshape = (Bt, d0, 1) if side == "a" else (Bt, 1, d1)
    e = torch.empty(eshape, dtype=torch.int32, device=dev)
    # each word read where it lies, through its strides: no stacked copy
    ptrs = (ctypes.c_void_p * nw)(*(c.data_ptr() for c in words))
    strides = (ctypes.c_longlong * (3 * nw))(*(s for c in words
                                               for s in c.stride()))
    rc = library().clrs_limb_extract(ptrs, strides, _ptr(limbs), _ptr(e), Bt,
                                     nw, L, d0, d1, int(side == "a"),
                                     int(b_gemm), _stream())
    _launched(rc, "limb_extract")
    limb_extract.launches += 1
    if side == "a" and layout == "gemm":
        limbs = limbs.view(Bt, L * d0, d1)
    return limbs, e


def _check_depth(k, name):
    if not 0 < k <= INT8_GEMM_MAX_K:
        raise ValueError(f"{name}: depth k={k} outside 1..{INT8_GEMM_MAX_K},"
                         " where the int32 sums of limb products stay exact")


def limb_gemm(a3, b3, eab, nw):
    """nw f32 words [B, m, n] of the limb product; see
    :func:`limb_gemm_plain` for the contract. Raises for a depth k beyond
    :data:`INT8_GEMM_MAX_K` on either device."""
    Bt, La, m, k = a3.shape
    _check_depth(k, "limb_gemm")
    if not _route(a3):
        return limb_gemm_plain(a3, b3, eab, nw)
    from .build import library

    _check_nw(nw, "limb_gemm", PRODUCT_NW)
    L, _ = limb_params(nw)
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


def int8_gemm(a, b):
    """Exact int32 product of int8 [B, M, K] and [B, K, N]; see
    :func:`int8_gemm_plain`."""
    if not _route(a):
        return int8_gemm_plain(a, b)
    from .build import library

    Bt, M, K = a.shape
    N = b.shape[2]
    _check_int("int8_gemm", (a, torch.int8, (Bt, M, K)),
               (b, torch.int8, (Bt, K, N)))
    _check_depth(K, "int8_gemm")
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((Bt, M, N), dtype=torch.int32, device=a.device)
    rc = library().clrs_int8_gemm(_ptr(a), _ptr(b), _ptr(c), Bt, M, K, N,
                                  _stream())
    _launched(rc, "int8_gemm")
    int8_gemm.launches += 1
    return c


# csrc/kernels.cu: output elements a cascade block owns
CASCADE_TILE_MIN, CASCADE_TILE_MAX = 8, 32


def cascade_tile(B, m, n, sms):
    """Output elements a cascade block owns: the largest power of two in
    CASCADE_TILE_MIN..CASCADE_TILE_MAX whose B ceil(m n / tile) blocks still
    cover the ``sms`` SMs (the smallest where none does)."""
    tile = CASCADE_TILE_MAX
    while tile > CASCADE_TILE_MIN and B * -(-(m * n) // tile) < sms:
        tile //= 2
    return tile


def cascade_slices(nw):
    """Threads an output element takes in cascade<FROM_C>'s first phase
    (csrc/kernels.cu cascade_slices): each sums two diagonals."""
    return (limb_params(nw)[1] + 1) // 2


def cascade_smem_bytes(nw, tile):
    """Dynamic shared memory of a cascade<FROM_C> block (csrc/kernels.cu
    cascade_smem_ints): the int32 diagonal sums [ndiag, tile] and the
    staged limb pairs [ndiag + 1, tile slices]."""
    nd = limb_params(nw)[1]
    return 4 * (nd * tile + (nd + 1) * tile * cascade_slices(nw))


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _cascade_launch(src, eab, nw, m, n, from_c, name):
    from .build import library

    Bt = src.shape[0]
    L, _ = limb_params(nw)
    if (L + 1) * L * m * n >= 1 << 31:
        raise ValueError(f"{name}: the kernel indexes a member of C in 32 "
                         f"bits; (L + 1) L m n = {(L + 1) * L * m * n}")
    src, eab = src.contiguous(), eab.contiguous()
    out = torch.empty((Bt, nw, m, n), dtype=torch.float32, device=src.device)
    tile = cascade_tile(Bt, m, n, _sm_count(src.device))
    rc = library().clrs_cascade(_ptr(src), _ptr(eab), _ptr(out), Bt, m, n,
                                nw, int(from_c), tile, _stream())
    _launched(rc, name)
    return _unstack(out)


def cascade_from_c(C, eab, nw):
    """nw f32 words [B, m, n] from the int8 product C [B, L m, L n]; see
    :func:`cascade_from_c_plain`."""
    if not _route(C):
        return cascade_from_c_plain(C, eab, nw)
    _check_nw(nw, "cascade_from_c", PRODUCT_NW)
    L, _ = limb_params(nw)
    Bt, LM, LN = C.shape
    if LM % L or LN % L:
        raise ValueError(f"cascade_from_c: C {tuple(C.shape)} is not in "
                         f"{L}-limb blocks")
    m, n = LM // L, LN // L
    _check_int("cascade_from_c", (C, torch.int32, (Bt, LM, LN)),
               (eab, torch.int32, (Bt, m, n)))
    out = _cascade_launch(C, eab, nw, m, n, True, "cascade_from_c")
    cascade_from_c.launches += 1
    return out


def cascade_from_diags(diags, eab, nw):
    """nw f32 words [B, m, n] from diagonal sums [B, ndiag, m, n]; see
    :func:`cascade_from_diags_plain`."""
    if not _route(diags):
        return cascade_from_diags_plain(diags, eab, nw)
    _check_nw(nw, "cascade_from_diags")
    _, ndiag = limb_params(nw)
    Bt, nd, m, n = diags.shape
    _check_int("cascade_from_diags", (diags, torch.int32, (Bt, ndiag, m, n)),
               (eab, torch.int32, (Bt, m, n)))
    out = _cascade_launch(diags, eab, nw, m, n, False, "cascade_from_diags")
    cascade_from_diags.launches += 1
    return out


_PLMAP_FN = {"add": 0, "axpy": 1, "residual": 2, "residual_corr": 3}
# how the chain kernels read an operand's words (csrc/kernels.cu OP_*)
OP_GENERAL, OP_PLANE, OP_SCALAR = 0, 1, 2


def plmap_block(D2):
    """Threads of a chain block along j (8, 16 or 32; the rest of its 64
    along i), one column a thread: the width whose column tiles leave the
    fewest idle columns at the ragged edge, the widest on a tie."""
    return min((32, 16, 8), key=lambda tx: (-(-D2 // tx) * tx - D2, -tx))


def plmap_operand(op, shape3):
    """(kind, [(data_ptr, (s0, s1, s2)) per word]) of one chain operand
    whose words broadcast to ``shape3`` [L, D1, D2]: element strides over
    that shape, 0 on an axis of size 1. OP_SCALAR where every word has the
    strides (s0, 0, 0) of word 0, OP_PLANE where every word has the strides
    (s0, s1, 1) of word 0, OP_GENERAL otherwise. Raises where an offset
    within a plane does not fit in 32 bits."""
    words = []
    for c in op:
        c3 = _as3(c).expand(shape3)
        st = tuple(0 if d == 1 else s for d, s in zip(shape3, c3.stride()))
        if (shape3[1] - 1) * st[1] + (shape3[2] - 1) * st[2] >= 1 << 31:
            raise ValueError(f"pl_map chains index a plane in 32 bits; "
                             f"strides {c3.stride()} over {shape3}")
        words.append((c3.data_ptr(), st))
    st0 = words[0][1]
    if any(st != st0 for _, st in words):
        return OP_GENERAL, words
    if st0[1] == 0 and st0[2] == 0:
        return OP_SCALAR, words
    return (OP_PLANE if st0[2] == 1 else OP_GENERAL), words


def _plmap_launch(fn, ops, nws, name):
    """Launch one chain kernel on operands ``ops`` (word tuples, word counts
    ``nws``); every word is passed where it lies, classified by
    :func:`plmap_operand`. Returns the output words [L, *dims]."""
    from .build import library

    nw = nws[0]
    _check_nw(nw, name)
    shape3, out_shape = _chain_shape(ops)
    dev = ops[0][0].device
    ptrs = (ctypes.c_void_p * (4 * _MAX_NW))()
    strides = (ctypes.c_longlong * (4 * _MAX_NW * 3))()
    kinds = (ctypes.c_int * 4)()
    for k, (op, nwk) in enumerate(zip(ops, nws)):
        if len(op) != nwk:
            raise ValueError(f"{name}: operand {k} has {len(op)} words, "
                             f"expected {nwk}")
        for c in op:
            if c.dtype != torch.float32 or c.device != dev:
                raise ValueError(f"{name}: words must be float32 tensors "
                                 f"on {dev}, got {c.dtype} on {c.device}")
        kinds[k], words = plmap_operand(op, shape3)
        for w, (p, st) in enumerate(words):
            ptrs[k * _MAX_NW + w] = p
            strides[(k * _MAX_NW + w) * 3:(k * _MAX_NW + w + 1) * 3] = st
    out = torch.empty((nw,) + shape3, dtype=torch.float32, device=dev)
    rc = library().clrs_plmap(_PLMAP_FN[fn], ptrs, strides, kinds, _ptr(out),
                              *shape3, nw, plmap_block(shape3[2]), _stream())
    _launched(rc, name)
    return tuple(out[k].view(out_shape) for k in range(nw))


def plmap_add(x, d):
    """X + dX as one kernel; see :func:`plmap_add_plain`."""
    _refuse_f64("plmap_add", x, d)
    if not _route(x[0]):
        return plmap_add_plain(x, d)
    out = _plmap_launch("add", [x, d], [len(x), len(x)], "plmap_add")
    plmap_add.launches += 1
    return out


def plmap_axpy(x, d, a):
    """X + alpha dX as one kernel; see :func:`plmap_axpy_plain`."""
    _refuse_f64("plmap_axpy", x, d, a)
    if not _route(x[0]):
        return plmap_axpy_plain(x, d, a)
    out = _plmap_launch("axpy", [x, d, a], [len(x), len(x), 3], "plmap_axpy")
    plmap_axpy.launches += 1
    return out


def plmap_residual(mu, mask, xy, dxdy=None):
    """mask (mu I - XY [- dX dY]) as one kernel; see
    :func:`plmap_residual_plain`."""
    _refuse_f64("plmap_residual", mu, (mask,), xy,
                () if dxdy is None else dxdy)
    if not _route(xy[0]):
        return plmap_residual_plain(mu, mask, xy, dxdy)
    nw = len(xy)
    ops = [mu, (mask,), xy]
    if dxdy is not None:
        ops.append(dxdy)
    shape3, _ = _chain_shape(ops)
    if shape3[1] != shape3[2]:
        raise ValueError(f"plmap_residual: square blocks only, got {shape3}")
    out = _plmap_launch("residual" if dxdy is None else "residual_corr", ops,
                        [nw, 1, nw, nw][:len(ops)], "plmap_residual")
    plmap_residual.launches += 1
    return out


def chol_batched(a):
    """Batched expansion Cholesky; see :func:`chol_plain`."""
    _refuse_f64("chol_batched", a)
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
    :func:`tri_solve_plain`. The transposed form's kernel reduces the
    halving tree by the schedule of :func:`tree_table`."""
    _refuse_f64("tri_solve_batched", l, b)
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
    trans = bool(trans)
    table, H = _tree_table_on(n, Lw.device) if trans else (None, 0)
    x = torch.empty_like(Bw)
    rc = library().clrs_tri_solve(_ptr(Lw), _ptr(Bw), _ptr(x),
                                  None if table is None else _ptr(table), H,
                                  Bt, n, m, nw, int(trans), _stream())
    _launched(rc, "tri_solve_batched")
    tri_solve_batched.launches += 1
    tri_solve_batched.launches_by_form[trans] += 1
    return _unstack(x)


# ---------------------------------------------------------------------------
# the step's expansion arithmetic: one launch an op (csrc/expmap.cu)
# ---------------------------------------------------------------------------

EW_OPS = {"add": 0, "sub": 1, "mul": 2, "div": 3, "neg": 4, "symmetrize": 5}
EW_MAX_DIMS = 6             # csrc/expmap.cu MAXD
TREE_THREADS = 256          # csrc/exptree.cu TREE_THREADS (block route)
TREE_SMEM = 227 * 1024      # csrc/common.cuh SMEM_MAX
TREE_CLUSTER = 8            # csrc/exptree.cu MAX_CLUSTER (portable size)
TREE_SPREAD = 4 * TREE_THREADS   # level-1 entries one block walks alone
TREE_SPREAD_COLS = 16       # ... where no more columns than this fill the card


def coalesce(shape, strides):
    """(dims, [strides of each word]) of ``shape`` and the element strides
    of several words over it: dims of size 1 dropped, and neighbouring
    dims merged where every word steps over the outer one as far as over
    the whole inner one (one index then walks both)."""
    dims, sts = [], [[] for _ in strides]
    for d, size in enumerate(shape):
        if size == 1:
            continue
        if dims and all(st[-1] == s[d] * size for st, s in zip(sts, strides)):
            dims[-1] *= size
            for st, s in zip(sts, strides):
                st[-1] = s[d]
        else:
            dims.append(size)
            for st, s in zip(sts, strides):
                st.append(s[d])
    return tuple(dims), [tuple(st) for st in sts]


def _place(strides, slot, st):
    """Write dims' strides ``st`` right-aligned into slot ``slot`` of a
    [*, EW_MAX_DIMS] ctypes array, as csrc/expmap.cu reads them."""
    base = (slot + 1) * EW_MAX_DIMS - len(st)
    strides[base:base + len(st)] = st


def _check_operands(ops, name):
    nw = len(ops[0])
    _check_nw(nw, name)
    dev = ops[0][0].device
    for op in ops:
        if len(op) != nw:
            raise ValueError(f"{name}: operands of {len(op)} and {nw} words")
        for c in op:
            if c.dtype != torch.float32 or c.device != dev:
                raise ValueError(f"{name}: words must be float32 tensors on "
                                 f"{dev}, got {c.dtype} on {c.device}")
    return nw, dev


def ew_pack(ops):
    """The host arguments of one expmap launch on word tuples ``ops``, as
    csrc/expmap.cu reads them: (output shape, numel, ctypes arrays of the
    word pointers [2][8], their element strides [2][8][6] over the
    coalesced dims, right-aligned, the operands' ``shared`` flags [2] and
    the dims [6], left-aligned, and their count). Every word is broadcast
    to the shape of all, as PyTorch broadcasts them (stride 0 on an axis
    of size 1); an operand is ``shared`` where all its words have the same
    strides. Raises where more than EW_MAX_DIMS dims remain."""
    shape = tuple(O.broadcast_shapes(*(c.shape for op in ops for c in op)))
    dims, sts = coalesce(shape, [
        tuple(0 if n == 1 else s for n, s in
              zip(shape, c.expand(shape).stride()))
        for op in ops for c in op])
    if len(dims) > EW_MAX_DIMS:
        raise ValueError(f"expmap: {len(dims)} dims after coalescing "
                         f"{shape}, at most {EW_MAX_DIMS}")
    ptrs = (ctypes.c_void_p * (2 * _MAX_NW))()
    strides = (ctypes.c_longlong * (2 * _MAX_NW * EW_MAX_DIMS))()
    shared = (ctypes.c_int * 2)()
    k = 0
    for j, op in enumerate(ops):
        st = sts[k:k + len(op)]
        shared[j] = int(all(v == st[0] for v in st))
        for w, (c, v) in enumerate(zip(op, st)):
            ptrs[j * _MAX_NW + w] = c.data_ptr()
            _place(strides, j * _MAX_NW + w, v)
        k += len(op)
    return (shape, math.prod(shape), ptrs, strides, shared,
            (ctypes.c_int * EW_MAX_DIMS)(*dims), len(dims))


def _ew_launch(op, ops, name):
    """One expmap<NW, OP> launch on word tuples ``ops``: (the output words,
    each [shape] of one [nw, shape] buffer; whether it launched: an empty
    output launches nothing)."""
    from .build import library

    nw, dev = _check_operands(ops, name)
    shape, numel, ptrs, strides, shared, dims, nd = ew_pack(ops)
    out = torch.empty((nw,) + shape, dtype=torch.float32, device=dev)
    words = tuple(out[k] for k in range(nw))
    if numel == 0:
        return words, False
    if numel >= 1 << 31:
        raise ValueError(f"{name}: {numel} elements, the kernel indexes "
                         "them in 32 bits")
    rc = library().clrs_expmap(EW_OPS[op], ptrs, strides, shared, dims, nd,
                               _ptr(out), numel, nw, _stream())
    _launched(rc, name)
    return words, True


def _ew(op, wrapper, plain, *ops):
    name = wrapper.__name__
    _refuse_f64(name, *ops)
    if not _route(ops[0][0]):
        return plain(*ops)
    out, launched = _ew_launch(op, list(ops), name)
    wrapper.launches += launched
    return out


def ew_add(x, y):
    """x + y as one expmap launch; see :func:`ew_add_plain`."""
    return _ew("add", ew_add, ew_add_plain, x, y)


def ew_sub(x, y):
    """x - y as one expmap launch; see :func:`ew_sub_plain`."""
    return _ew("sub", ew_sub, ew_sub_plain, x, y)


def ew_mul(x, y):
    """x * y as one expmap launch; see :func:`ew_mul_plain`."""
    return _ew("mul", ew_mul, ew_mul_plain, x, y)


def ew_div(x, y):
    """x / y as one expmap launch; see :func:`ew_div_plain`."""
    return _ew("div", ew_div, ew_div_plain, x, y)


def ew_neg(x):
    """-x as one expmap launch; see :func:`ew_neg_plain`."""
    return _ew("neg", ew_neg, ew_neg_plain, x)


def ew_symmetrize(x):
    """(x + x^T) / 2 as one expmap launch, x^T read through swapped
    strides; see :func:`ew_symmetrize_plain`."""
    _refuse_f64("ew_symmetrize", x)
    if not _route(x[0]):
        return ew_symmetrize_plain(x)
    out, launched = _ew_launch("symmetrize", [
        x, tuple(c.transpose(-1, -2) for c in x)], "ew_symmetrize")
    ew_symmetrize.launches += launched
    return out


def tree_sum_plan(n, nw, M, smem=TREE_SMEM, cluster=TREE_CLUSTER):
    """How tree_sum<NW, PRO> (csrc/exptree.cu) sums M columns of n entries.
    The first level is computed on load, so a column keeps h = ceil(n / 2)
    entries of nw 4 bytes in shared memory:

    - ("shared", C): C columns a block (as many as the block's threads take
      one level-1 entry each, at least one, as many as fit ``smem``);
    - ("cluster", G): one column over a cluster of G = 2..``cluster``
      blocks, where h exceeds one block's ``smem`` (G the fewest that hold
      it), or where a column of more than TREE_SPREAD entries would leave
      one block's threads walking it alone (at most TREE_SPREAD_COLS
      columns: G = ceil(h / TREE_SPREAD), up to ``cluster``);
    - ("levels", (n, ceil(n / 2), ..., 2)): one launch a level, only where
      h exceeds a full cluster's shared memory (about 186 k entries at nw
      5); chosen by size, not on failure."""
    h = (n + 1) // 2
    cap = smem // (4 * nw)                 # level-1 entries a block holds
    if h > cap * cluster and n > 1:
        levels, m = [], n
        while m > 1:
            levels.append(m)
            m = (m + 1) // 2
        return "levels", tuple(levels)
    if cluster > 1:
        G = -(-h // cap) if h > cap else 1
        if h > TREE_SPREAD and M <= TREE_SPREAD_COLS:
            G = max(G, min(cluster, -(-h // TREE_SPREAD)))
        if G > 1:
            return "cluster", G
    C = TREE_THREADS // max(1, h)
    if h:
        C = min(C, cap // h)
    return "shared", max(1, min(C, M))


TreeLaunch = collections.namedtuple("TreeLaunch", (
    "ptrs", "strides", "shared", "scale", "scale_st", "scale_c", "scale_on",
    "dims", "nd", "ne", "dst", "ws", "cs", "es", "M", "n", "C", "G", "S",
    "level", "pro", "epi"))
TreeLaunch.__doc__ = """One clrs_tree_sum launch (csrc/exptree.cu), its C
arguments in order: ctypes arrays of the word pointers [3][8] and strides
[3][8][6] of x, y and acc over the dims (right-aligned), their shared flags
[3]; the scale tensor (or None: the constant scale_c) with its strides [6]
and where it applies (TREE_SCALE); the dims [6] (left-aligned), their count
nd and the ne entry dims at their end; the destination tensor and its word,
column and entry strides; M columns, n entries, C columns a block, G
blocks a cluster, S level-1 entries a cluster block; level 0 (block or
cluster route) or 1 (one level); pro (TREE_PRO) and epi (TREE_EPI)."""

TREE_PRO = {None: 0, "mul": 1}
TREE_EPI = {None: 0, "add": 1, "sub": 2}
TREE_SCALE = {None: 0, "x": 1, "product": 2}


def sum_axes(axis, ndim):
    """(a0, a1): the summed axes a0..a1-1 of an ``ndim``-dim shape, from an
    int, a tuple of consecutive axes, or None (all)."""
    if axis is None:
        return 0, ndim
    axes = sorted(a % ndim for a in ((axis,) if isinstance(axis, int)
                                     else axis))
    if not axes or axes != list(range(axes[0], axes[0] + len(axes))):
        raise ValueError(f"summed axes must be consecutive, got {axis}")
    return axes[0], axes[-1] + 1


def _expanded(c, shape):
    return tuple(0 if n == 1 else s for n, s in
                 zip(shape, c.expand(shape).stride()))


def _pack_views(groups, dims_sts):
    """ctypes word pointers [len(groups)][8], strides [..][8][6]
    (right-aligned) and shared flags of word groups (a group may be None:
    null pointers), each word's strides over the coalesced dims taken in
    order from ``dims_sts``."""
    G = len(groups)
    ptrs = (ctypes.c_void_p * (G * _MAX_NW))()
    strides = (ctypes.c_longlong * (G * _MAX_NW * EW_MAX_DIMS))()
    shared = (ctypes.c_int * G)()
    k = 0
    for j, words in enumerate(groups):
        if words is None:
            continue
        st = dims_sts[k:k + len(words)]
        shared[j] = int(all(v == st[0] for v in st))
        for w, (c, v) in enumerate(zip(words, st)):
            ptrs[j * _MAX_NW + w] = c.data_ptr()
            _place(strides, j * _MAX_NW + w, v)
        k += len(words)
    return ptrs, strides, shared


def _word1_strides(st):
    arr = (ctypes.c_longlong * EW_MAX_DIMS)()
    _place(arr, 0, st)
    return arr


def _check_scale(scale, dev, name):
    if isinstance(scale, torch.Tensor):
        if scale.dtype != torch.float32 or scale.device != dev:
            raise ValueError(f"{name}: a scale or mask must be a float32 "
                             f"tensor on {dev}")
        return (scale,)
    return ()


def tree_sum_launches(x, axis, y=None, acc=None, sub=False, scale=None,
                      scale_on=None, smem=TREE_SMEM, cluster=TREE_CLUSTER):
    """(output words, the :class:`TreeLaunch` es) of acc +- the tree sum of
    x (x s, or x y, x s y, (x y) s) over ``axis`` (:func:`sum_axes`), as
    :func:`tree_sum_fused` launches them. x, y and the scale broadcast
    together; acc broadcasts to the column shape (the shape without the
    summed axes), which is the output's. The block and cluster routes are
    one launch; the level route runs in a scratch buffer [nw, M, ceil(n /
    2)], PRO on the first level, the epilogue on the last. Nothing is
    launched where the output is empty."""
    ops = [x] + ([y] if y is not None else []) + ([acc] if acc is not None
                                                   else [])
    nw, dev = _check_operands(ops, "tree_sum")
    sc = _check_scale(scale, dev, "tree_sum")
    if (scale is None) != (scale_on is None) or (
            scale_on == "product" and y is None):
        raise ValueError(f"tree_sum: scale {type(scale)} on {scale_on!r}")
    xy = [x] + ([y] if y is not None else [])
    shape = tuple(O.broadcast_shapes(*(c.shape for op in xy for c in op),
                                     *(s.shape for s in sc)))
    a0, a1 = sum_axes(axis, len(shape)) if shape else (0, 0)
    cshape, eshape = shape[:a0] + shape[a1:], shape[a0:a1]
    n, M = math.prod(eshape), math.prod(cshape)
    if acc is not None:
        ashape = tuple(O.broadcast_shapes(cshape, *(c.shape for c in acc)))
        if ashape != cshape:
            raise ValueError(f"tree_sum: acc {tuple(acc[0].shape)} does not "
                             f"broadcast to the sum's shape {cshape}")
    out = torch.empty((nw,) + cshape, dtype=torch.float32, device=dev)
    words = tuple(out[k] for k in range(nw))
    if M == 0:
        return words, []
    perm = list(range(a0)) + list(range(a1, len(shape))) + list(range(a0, a1))
    nc = len(cshape)
    full = [tuple(_expanded(c, shape)[p] for p in perm)
            for op in xy for c in op] + [
        tuple(_expanded(s, shape)[p] for p in perm) for s in sc]
    accs = [_expanded(c, cshape) + (0,) * len(eshape) for c in acc] \
        if acc is not None else []
    sts = full + accs
    cdims, csts = coalesce(cshape, [st[:nc] for st in sts])
    edims, ests = coalesce(eshape, [st[nc:] for st in sts]) if n else ((), [
        () for _ in sts])
    if len(cdims) + max(len(edims), 1) > EW_MAX_DIMS:
        raise ValueError(f"tree_sum: {len(cdims)} column and {len(edims)} "
                         f"entry dims after coalescing {shape}, at most "
                         f"{EW_MAX_DIMS} in all")
    if M >= 1 << 31 or M * ((n + 1) // 2) >= 1 << 31:
        raise ValueError(f"tree_sum: {M} columns of {n}, the kernel indexes "
                         "them in 32 bits")
    dsts = [c + e for c, e in zip(csts, ests)]
    nsrc = sum(len(op) for op in xy)
    groups = [x, y, acc]
    src_sts = dsts[:nsrc] + dsts[nsrc + len(sc):]
    ptrs, strides, shared = _pack_views(groups, src_sts)
    sc_t = sc[0] if sc else None
    sc_st = _word1_strides(dsts[nsrc] if sc else ())
    sc_c = float(scale) if scale is not None and not sc else 1.0
    dims = cdims + edims
    route, plan = tree_sum_plan(n, nw, M, smem, cluster)
    pro = TREE_PRO["mul" if y is not None else None]
    epi = TREE_EPI[None if acc is None else "sub" if sub else "add"]
    son = TREE_SCALE[scale_on]
    to_out = (out, M, 1, 0)

    def launch(p, st, sh, dm, ne, dst, m, C, G, S, level, pro_, son_, epi_):
        return TreeLaunch(p, st, sh, sc_t if son_ else None,
                          sc_st, sc_c, son_,
                          (ctypes.c_int * EW_MAX_DIMS)(*dm), len(dm), ne,
                          *dst, M, m, C, G, S, level, pro_, epi_)

    if route == "shared":
        return words, [launch(ptrs, strides, shared, dims, len(edims),
                              to_out, n, plan, 1, 0, 0, pro, son, epi)]
    if route == "cluster":
        G = plan
        return words, [launch(ptrs, strides, shared, dims, len(edims),
                              to_out, n, 1, G, -(-((n + 1) // 2) // G), 0,
                              pro, son, epi)]
    half0 = (n + 1) // 2
    scratch = torch.empty((nw, M, half0), dtype=torch.float32, device=dev)
    # the scratch over the same column dims (row-major, as c unravels) and
    # one entry dim; acc's strides over the column dims, 0 on the entry dim
    cst, run = [], half0
    for d in reversed(cdims):
        cst.insert(0, run)
        run *= d
    sview = [tuple(cst) + (1,)] * nw
    aview = [csts[nsrc + len(sc) + k] + (0,) for k in range(nw)] \
        if acc is not None else []
    s_ptrs, s_strides, s_shared = _pack_views(
        [tuple(scratch[k] for k in range(nw)), None, acc], sview + aview)
    launches = []
    for i, m in enumerate(plan):
        last = m == 2
        dst = to_out if last else (scratch, M * half0, half0, 1)
        if i == 0:
            launches.append(launch(ptrs, strides, shared, dims, len(edims),
                                   dst, m, 1, 1, 0, 1, pro, son,
                                   epi if last else 0))
        else:
            launches.append(launch(s_ptrs, s_strides, s_shared,
                                   cdims + (m,), 1, dst, m, 1, 1, 0, 1, 0, 0,
                                   epi if last else 0))
    return words, launches


def _tree_run(launches, nw):
    from .build import library

    lib = library()
    for ln in launches:
        rc = lib.clrs_tree_sum(
            ln.ptrs, ln.strides, ln.shared,
            None if ln.scale is None else _ptr(ln.scale), ln.scale_st,
            ln.scale_c, ln.scale_on, ln.dims, ln.nd, ln.ne, _ptr(ln.dst),
            ln.ws, ln.cs, ln.es, ln.M, ln.n, ln.C, ln.G, ln.S, ln.level,
            ln.pro, ln.epi, nw, _stream())
        _launched(rc, "tree_sum")


def tree_sum(x, axis):
    """Tree sum along ``axis`` as tree_sum<NW, PRO_NONE> launches (one, or
    one a level past a full cluster's shared memory); see
    :func:`tree_sum_plain`."""
    _refuse_f64("tree_sum", x)
    if not _route(x[0]):
        return tree_sum_plain(x, axis)
    out, launches = tree_sum_launches(x, axis)
    _tree_run(launches, len(x))
    tree_sum.launches += len(launches)
    return out


def tree_sum_fused(x, y, axis, acc=None, sub=False, scale=None,
                   scale_on=None):
    """acc +- sum over ``axis`` of x y (``y`` None: of x), x's words or the
    product's times the exact word ``scale`` where ``scale_on`` is "x" or
    "product", as one tree_sum<NW, PRO> launch (one a level only past a
    full cluster's shared memory); see :func:`tree_sum_fused_plain`. The
    summed axes are consecutive (:func:`sum_axes`) and their entries are
    taken in row-major order, as a reshape of them to one axis orders
    them."""
    _refuse_f64("tree_sum_fused", x, () if y is None else y,
                () if acc is None else acc)
    if not _route(x[0]):
        return tree_sum_fused_plain(x, y, axis, acc, sub, scale, scale_on)
    out, launches = tree_sum_launches(x, axis, y, acc, sub, scale, scale_on)
    _tree_run(launches, len(x))
    tree_sum_fused.launches += len(launches)
    return out


# ---------------------------------------------------------------------------
# the step's fused forms and the commit's select (csrc/expfuse.cu)
# ---------------------------------------------------------------------------

EW_FORMS = {"fma": 0, "fms": 1, "msub": 2, "mms": 3, "sub2": 4}
SELECT_MAX_SEGS = 24        # csrc/expfuse.cu MAXSEG


def ew_fuse_pack(ops, scale=None, sc_op=-1, mask=None):
    """The host arguments of one expfuse launch on word tuples ``ops`` (3
    or 4 operands), the exact ``scale`` of operand ``sc_op`` (a float32
    tensor, a float, or None) and the result's ``mask`` (a float32 tensor
    or None), as csrc/expfuse.cu reads them: (output shape, numel, the
    output words, ctypes arrays of the word pointers [4][8], strides
    [4][8][6], shared flags [4], the scale's strides [6], the mask's
    strides [6], the output's word pointers [8] and strides [6], the dims
    [6] and their count). Everything broadcasts together, as PyTorch
    broadcasts the composition; the output is a fresh [nw, shape] buffer."""
    nw, dev = _check_operands(ops, "expfuse")
    sc = _check_scale(scale, dev, "expfuse")
    mk = _check_scale(mask, dev, "expfuse")
    shape = tuple(O.broadcast_shapes(*(c.shape for op in ops for c in op),
                                     *(t.shape for t in sc + mk)))
    out = torch.empty((nw,) + shape, dtype=torch.float32, device=dev)
    words = tuple(out[k] for k in range(nw))
    sts = [_expanded(c, shape) for op in ops for c in op] + \
        [_expanded(t, shape) for t in sc + mk] + [words[0].stride()]
    dims, csts = coalesce(shape, sts)
    if len(dims) > EW_MAX_DIMS:
        raise ValueError(f"expfuse: {len(dims)} dims after coalescing "
                         f"{shape}, at most {EW_MAX_DIMS}")
    nsrc = sum(len(op) for op in ops)
    groups = list(ops) + [None] * (4 - len(ops))
    ptrs, strides, shared = _pack_views(groups, csts[:nsrc])
    rest = csts[nsrc:]
    sc_st = _word1_strides(rest[0] if sc else ())
    mk_st = _word1_strides(rest[len(sc)] if mk else ())
    outp = (ctypes.c_void_p * _MAX_NW)(*(w.data_ptr() for w in words))
    return (shape, math.prod(shape), words, ptrs, strides, shared, sc_st,
            mk_st, outp, _word1_strides(rest[-1]),
            (ctypes.c_int * EW_MAX_DIMS)(*dims), len(dims))


def _fuse(form, wrapper, ops, scale=None, sc_op=-1, mask=None):
    from .build import library

    name = wrapper.__name__
    (shape, numel, words, ptrs, strides, shared, sc_st, mk_st, outp, out_st,
     dims, nd) = ew_fuse_pack(ops, scale, sc_op, mask)
    if numel == 0:
        return words
    if numel >= 1 << 31:
        raise ValueError(f"{name}: {numel} elements, the kernel indexes "
                         "them in 32 bits")
    sc_t = scale if isinstance(scale, torch.Tensor) else None
    rc = library().clrs_expfuse(
        EW_FORMS[form], ptrs, strides, shared,
        None if sc_t is None else _ptr(sc_t), sc_st,
        1.0 if scale is None or sc_t is not None else float(scale),
        sc_op if scale is not None else -1,
        None if mask is None else _ptr(mask), mk_st, outp, out_st, dims, nd,
        numel, len(ops[0]), _stream())
    _launched(rc, name)
    wrapper.launches += 1
    return words


def _fuse_route(name, ops, *words1):
    _refuse_f64(name, *ops)
    for t in words1:
        if isinstance(t, torch.Tensor) and t.dtype == torch.float64:
            raise ValueError(f"{name}: f64 words are not an f32 kernel's "
                             "input (use the f64 substrate's forms)")
    return _route(ops[0][0])


def ew_fma(a, b, c, mask=None):
    """(a + b c) [mask] as one expfuse launch; see :func:`ew_fma_plain`."""
    if not _fuse_route("ew_fma", (a, b, c), mask):
        return ew_fma_plain(a, b, c, mask)
    return _fuse("fma", ew_fma, (a, b, c), mask=mask)


def ew_fms(a, b, c, mask=None):
    """(a - b c) [mask] as one expfuse launch; see :func:`ew_fms_plain`."""
    if not _fuse_route("ew_fms", (a, b, c), mask):
        return ew_fms_plain(a, b, c, mask)
    return _fuse("fms", ew_fms, (a, b, c), mask=mask)


def ew_msub(a, b, c, mask=None):
    """(a b - c) [mask] as one expfuse launch; see :func:`ew_msub_plain`."""
    if not _fuse_route("ew_msub", (a, b, c), mask):
        return ew_msub_plain(a, b, c, mask)
    return _fuse("msub", ew_msub, (a, b, c), mask=mask)


def ew_mms(a, b, c, d, mask=None):
    """(a b - c d) [mask] as one expfuse launch; see :func:`ew_mms_plain`."""
    if not _fuse_route("ew_mms", (a, b, c, d), mask):
        return ew_mms_plain(a, b, c, d, mask)
    return _fuse("mms", ew_mms, (a, b, c, d), mask=mask)


def ew_sub2(a, b, c, c_scale=None, mask=None):
    """((a - b) - c s) [mask], s an exact word or float on each of c's
    words, as one expfuse launch; see :func:`ew_sub2_plain`."""
    if not _fuse_route("ew_sub2", (a, b, c), c_scale, mask):
        return ew_sub2_plain(a, b, c, c_scale, mask)
    return _fuse("sub2", ew_sub2, (a, b, c), c_scale, 2, mask)


def select_segments(cond, pairs):
    """The expselect launches of ``pairs`` [(src words, dst words)]: lists
    of at most SELECT_MAX_SEGS (src, dst) pairs, empty ones left out.
    Every word must be a contiguous float32 tensor on cond's device, each
    pair's words of one shape; cond a bool tensor of one element."""
    if cond.dtype != torch.bool or cond.numel() != 1:
        raise ValueError(f"ew_select: cond must be one bool, got "
                         f"{cond.dtype} {tuple(cond.shape)}")
    segs = []
    for src, dst in pairs:
        nw, dev = _check_operands([src, dst], "ew_select")
        if dev != cond.device:
            raise ValueError(f"ew_select: cond on {cond.device}, words on "
                             f"{dev}")
        for c in src + dst:
            if c.shape != src[0].shape or not c.is_contiguous():
                raise ValueError("ew_select: every word of a pair must be "
                                 f"contiguous and of shape {tuple(src[0].shape)}")
        if src[0].numel():
            segs.append((src, dst))
    return [segs[i:i + SELECT_MAX_SEGS]
            for i in range(0, len(segs), SELECT_MAX_SEGS)]


def ew_select(cond, pairs):
    """dst = cond ? src : dst for every word of each (src, dst) pair of
    word tuples, in place, cond a device bool that no host reads: one
    expselect launch for up to SELECT_MAX_SEGS pairs; see
    :func:`ew_select_plain`. Returns the dst tuples."""
    pairs = list(pairs)
    if not pairs:
        return []
    for src, dst in pairs:
        _refuse_f64("ew_select", src, dst)
    if not _route(pairs[0][0][0]):
        return ew_select_plain(cond, pairs)
    from .build import library

    lib = library()
    for chunk in select_segments(cond, pairs):
        nw = len(chunk[0][0])
        dptr = (ctypes.c_void_p * (len(chunk) * _MAX_NW))()
        sptr = (ctypes.c_void_p * (len(chunk) * _MAX_NW))()
        numel = (ctypes.c_longlong * len(chunk))()
        for j, (src, dst) in enumerate(chunk):
            if len(src) != nw:
                raise ValueError("ew_select: pairs of several word counts")
            for k in range(nw):
                sptr[j * _MAX_NW + k] = src[k].data_ptr()
                dptr[j * _MAX_NW + k] = dst[k].data_ptr()
            numel[j] = src[0].numel()
        rc = lib.clrs_expselect(_ptr(cond), dptr, sptr, numel, len(chunk),
                                nw, _stream())
        _launched(rc, "ew_select")
        ew_select.launches += 1
    return [dst for _, dst in pairs]


# ---------------------------------------------------------------------------
# the f64 boundary of the expansion arithmetic (csrc/expf64.cu)
# ---------------------------------------------------------------------------

EXPF64_FORMS = {"sum": 0, "max_abs": 1, "split": 2}
EXPF64_THREADS = 512        # csrc/expf64.cu MAXABS_THREADS
EXPF64_MAX_CLUSTER = 8      # csrc/expf64.cu MAX_CLUSTER
EXPF64_PER_THREAD = 4       # entries a thread of a full max_abs cluster walks


def expf64_cluster(numel):
    """The blocks of one expf64_max_abs launch over ``numel`` entries (one
    cluster, 1..EXPF64_MAX_CLUSTER): a block for each EXPF64_PER_THREAD x
    EXPF64_THREADS entries. It depends on numel alone, and the reduction
    is exact in any order, so the result does not depend on it."""
    per_block = EXPF64_PER_THREAD * EXPF64_THREADS
    return max(1, min(EXPF64_MAX_CLUSTER, -(-numel // per_block)))


def _expf64_route(name, x):
    """True for float32 CUDA words (checked: 1..8 words of one shape and
    device), which take the kernel; False for f64 words (the f64
    substrate's) and CPU words, which take the plain version."""
    if x[0].dtype == torch.float64 or not _route(x[0]):
        return False
    _check_nw(len(x), name, OPERAND_NW)
    for c in x:
        if c.dtype != torch.float32 or c.device != x[0].device:
            raise ValueError(f"{name}: words must be float32 tensors on "
                             f"{x[0].device}, got {c.dtype} on {c.device}")
    return True


def expf64_pack(x=None, src=None):
    """The host arguments of one expf64 launch, as csrc/expf64.cu reads
    them: (numel, ctypes arrays of the word pointers and their element
    strides over the coalesced dims, right-aligned, as :func:`ew_pack`
    packs its first operand (the kernel reads slots [8] and [8][6]), the
    ``shared`` flag, src's strides [6] or None, the dims [6], left-aligned,
    and their count) for the words ``x`` (SUM, MAXABS; broadcast together,
    as PyTorch broadcasts them) or the float64 tensor ``src`` (SPLIT). An
    empty shape gives no dims (MAXABS then reads nothing)."""
    if x is not None:
        _, numel, ptrs, strides, shared, dims, nd = ew_pack([x])
        src_st, shared = None, shared[0]
    else:
        numel = src.numel()
        sd, (st,) = coalesce(tuple(src.shape), [src.stride()])
        ptrs = strides = None
        shared = 0
        src_st = (ctypes.c_longlong * EW_MAX_DIMS)()
        _place(src_st, 0, st)
        dims, nd = (ctypes.c_int * EW_MAX_DIMS)(*sd), len(sd)
    if numel == 0:
        nd = 0
    if numel >= 1 << 31:
        raise ValueError(f"expf64: {numel} elements, the kernel indexes "
                         "them in 32 bits")
    return numel, ptrs, strides, shared, src_st, dims, nd


def _expf64_launch(form, name, nw, out, x=None, acc=None, src=None):
    from .build import library

    numel, ptrs, strides, shared, src_st, dims, nd = expf64_pack(x, src)
    rc = library().clrs_expf64(
        EXPF64_FORMS[form], ptrs, strides, shared,
        None if src is None else _ptr(src), src_st,
        None if acc is None else _ptr(acc), dims, nd, _ptr(out), numel, nw,
        expf64_cluster(numel), _stream())
    _launched(rc, name)


def expf64_sum(x):
    """The f64 value of the expansion x, elementwise, as one expf64<NW,
    SUM> launch for float32 CUDA words; see :func:`expf64_sum_plain`."""
    if not _expf64_route("expf64_sum", x):
        return expf64_sum_plain(x)
    shape = tuple(O.broadcast_shapes(*(c.shape for c in x)))
    out = torch.empty(shape, dtype=torch.float64, device=x[0].device)
    if out.numel():
        _expf64_launch("sum", "expf64_sum", len(x), out, x=x)
        expf64_sum.launches += 1
    return out


def expf64_max_abs(x, acc=None):
    """max |x| [, torch.maximum(acc, .)] as one expf64<NW, MAXABS> launch
    for float32 CUDA words, acc a float64 CUDA scalar or None; see
    :func:`expf64_max_abs_plain`."""
    if not _expf64_route("expf64_max_abs", x):
        return expf64_max_abs_plain(x, acc)
    dev = x[0].device
    if acc is not None and (acc.dtype != torch.float64 or acc.device != dev
                            or acc.dim() != 0):
        raise ValueError(f"expf64_max_abs: acc must be a float64 scalar on "
                         f"{dev}, got {acc.dtype} {tuple(acc.shape)} on "
                         f"{acc.device}")
    out = torch.empty((), dtype=torch.float64, device=dev)
    _expf64_launch("max_abs", "expf64_max_abs", len(x), out, x=x, acc=acc)
    expf64_max_abs.launches += 1
    return out


def expf64_split(v, nw):
    """The nw-word f32 expansion of the float64 tensor v (words 0..2 by
    successive rounding, the rest +0), the words views of one [nw, ...]
    buffer, as one expf64<NW, SPLIT> launch for a CUDA v; see
    :func:`expf64_split_plain`."""
    if v.dtype != torch.float64:
        raise ValueError(f"expf64_split: expected a float64 tensor, got "
                         f"{v.dtype}")
    if not _route(v):
        return expf64_split_plain(v, nw)
    _check_nw(nw, "expf64_split", OPERAND_NW)
    out = torch.empty((nw,) + tuple(v.shape), dtype=torch.float32,
                      device=v.device)
    if v.numel():
        _expf64_launch("split", "expf64_split", nw, out, src=v)
        expf64_split.launches += 1
    return tuple(out[k] for k in range(nw))


# ---------------------------------------------------------------------------
# the step-length eigensolver (csrc/eig.cu)
# ---------------------------------------------------------------------------

def _eig_operand(A, dtype, name):
    if A.dtype != dtype or not A.is_cuda or A.dim() != 3 \
            or A.shape[1] != A.shape[2] or A.shape[1] == 0:
        raise ValueError(f"{name}: expected a {dtype} CUDA batch [B, n, n] "
                         f"with n >= 1, got {A.dtype} {tuple(A.shape)} on "
                         f"{A.device}")
    return A.contiguous()


def _eig_scratch(lib, A):
    """eig_lowest's global scratch (float64) of the route past shared
    memory (None while shared memory holds a member), sized by the library
    itself."""
    per = lib.clrs_eig_scratch(0, A.shape[-1])
    if not per:
        return None
    return torch.empty((A.shape[0] * per,), dtype=torch.float64,
                       device=A.device)


def eig_lowest(A):
    """Lowest eigenvalue [B] of each member of a float64 batch A [B, n, n]
    (finite, symmetric), one eig_lowest launch; see
    :func:`eig_lowest_plain`. The step's default step-length route on the
    card."""
    if not _route(A):
        return eig_lowest_plain(A)
    from .build import library

    A = _eig_operand(A, torch.float64, "eig_lowest")
    lam = torch.empty((A.shape[0],), dtype=A.dtype, device=A.device)
    if not A.shape[0]:
        return lam
    lib = library()
    scratch = _eig_scratch(lib, A)
    rc = lib.clrs_eig_lowest(_ptr(A), _ptr(lam),
                             None if scratch is None else _ptr(scratch),
                             A.shape[0], A.shape[-1], _stream())
    _launched(rc, "eig_lowest")
    eig_lowest.launches += 1
    return lam


def eig_pairs(A):
    """float32 eigenpairs of each member of A [B, n, n] (finite,
    symmetric, n <= EIG_PAIRS_MAX_N): ascending eigenvalues [B, n] and
    eigenvectors as columns [B, n, n], an eig_pairs launch (the sweeps on
    A, which log their rotations) and an :func:`eig_pairs_vec` launch (the
    rotations replayed on V); see :func:`eig_pairs_plain`. The certified
    step-length route's candidate decompositions on the card."""
    if not _route(A):
        return eig_pairs_plain(A)
    lam, log = eig_pairs_sweeps(A)
    return lam, eig_pairs_vec(log, A.shape[-1])


def eig_pairs_sweeps(A):
    """The first of :func:`eig_pairs`' launches on a CUDA batch A: the
    sorted eigenvalues [B, n] and the members' rotation logs [B, per]
    (float64; :func:`eig_pairs_log_layout`), which :func:`eig_pairs_vec`
    replays; counted as ``eig_pairs.launches``."""
    from .build import library

    A = _eig_operand(A, torch.float32, "eig_pairs")
    B, n = A.shape[0], A.shape[-1]
    if n > EIG_PAIRS_MAX_N:
        raise ValueError(f"eig_pairs: n {n} > {EIG_PAIRS_MAX_N}")
    lib = library()
    lam = torch.empty((B, n), dtype=A.dtype, device=A.device)
    log = torch.empty((B, lib.clrs_eig_scratch(1, n)), dtype=torch.float64,
                      device=A.device)
    if B:
        rc = lib.clrs_eig_pairs(_ptr(A), _ptr(lam), _ptr(log), B, n,
                                _stream())
        _launched(rc, "eig_pairs")
        eig_pairs.launches += 1
    return lam, log


def eig_pairs_vec(log, n):
    """The eigenvectors [B, n, n] (float32, columns in the eigenvalues'
    order) from the rotation logs [B, per] of :func:`eig_pairs_sweeps`, one
    eig_pairs_vec launch; see :func:`eig_pairs_vec_plain`."""
    if not _route(log):
        return eig_pairs_vec_plain(log, n)
    from .build import library

    B = log.shape[0]
    vec = torch.empty((B, n, n), dtype=torch.float32, device=log.device)
    if not B:
        return vec
    lib = library()
    per = lib.clrs_eig_scratch(1, n)
    if log.dtype != torch.float64 or log.dim() != 2 or per <= 0 \
            or log.shape[1] != per or not log.is_contiguous():
        raise ValueError(f"eig_pairs_vec: expected the float64 rotation logs "
                         f"[B, {per}] of eig_pairs at n {n}, got {log.dtype} "
                         f"{tuple(log.shape)}")
    rc = lib.clrs_eig_pairs_vec(_ptr(log), _ptr(vec), B, n, _stream())
    _launched(rc, "eig_pairs_vec")
    eig_pairs_vec.launches += 1
    return vec


_COUNTED = (limb_extract, limb_gemm, int8_gemm, cascade_from_c,
            cascade_from_diags, chol_batched, tri_solve_batched, plmap_add,
            plmap_axpy, plmap_residual, ew_add, ew_sub, ew_mul, ew_div,
            ew_neg, ew_symmetrize, tree_sum, tree_sum_fused, ew_fma, ew_fms,
            ew_msub, ew_mms, ew_sub2, ew_select, eig_lowest, eig_pairs,
            eig_pairs_vec, expf64_sum, expf64_max_abs, expf64_split)
_COUNTED_NAMES = frozenset(f.__name__ for f in _COUNTED)
reset_counts()
