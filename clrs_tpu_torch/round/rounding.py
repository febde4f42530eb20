"""Rounding heuristic: numerical solution -> exact optimal solution.

Port of `ClusteredLowRankSolver.jl/src/rounding.jl`:
 1. kernel detection per PSD block from the dual solution (RREF with column
    pivoting in double-word arithmetic; rounding.jl:575-642),
 2. kernel-vector reduction (RREF -> nullspace -> HNF with normal multiplier
    -> LLL; rounding.jl:860-1104) giving a unimodular basis transform,
 3. transform of problem and solution (rounding.jl:1182-1253),
 4. projection onto the affine constraint space with exact rational linear
    algebra (column selection, pivots via RREF mod p, Dixon/pseudoinverse
    solves; rounding.jl:95-364),
 5. validity check: exact slacks + positive-definiteness of the transformed
    blocks (exact LDL^T over Q, embedded sign checks over number fields;
    rounding.jl:367-472).

Exact arithmetic is pure Python Fraction / :mod:`clrs_tpu.exact` (the
reference uses FLINT/Antic via Nemo).
"""

from __future__ import annotations

import functools
import random
import warnings
from decimal import localcontext
from fractions import Fraction
from math import isqrt, lcm
from typing import Dict, List

import numpy as np

from ..exact.dixon import solve_dixon
from ..exact.field import NFElem, NumberField, QQ, generic_embedding
from ..exact.hnf import hnf_normalmultiplier_with_transform
from ..exact.lll import clindep, lll_reduce
from ..exact.modp import find_pivots_modular
from ..exact.rational import (integerize_rows, mat_inv, mat_mul, mat_vec,
                              nullspace_from_rref, rref, transpose)
from ..model.linearsystem import partial_linearsystem
from ..model.problem import Constraint, LowRankMatPol, Objective, Problem, sortkey
from ..solver.status import (PrimalSolution, DualSolution, as_primal_solution,
                             slacks, vectorize)
from ..utils.hp import DDScalar, to_fraction

__all__ = ["RoundingSettings", "exact_solution"]


class RoundingSettings:
    """Settings for the rounding procedure (rounding.jl:1-81)."""

    def __init__(self, *, kernel_lll=False, kernel_bits=1000,
                 kernel_errbound=1e-10, kernel_round_errbound=1e-15,
                 kernel_use_dual=True, reduce_kernelvectors=True,
                 reduce_kernelvectors_cutoff=400,
                 reduce_kernelvectors_stepsize=200,
                 unimodular_transform=True, approximation_decimals=40,
                 regularization=1e-20, normalize_transformation=True,
                 redundancyfactor=10, pseudo=True, pseudo_columnfactor=1.05,
                 extracolumns_linindep=False):
        self.kernel_lll = kernel_lll
        self.kernel_bits = kernel_bits
        self.kernel_errbound = kernel_errbound
        self.kernel_round_errbound = kernel_round_errbound
        self.kernel_use_dual = kernel_use_dual
        self.reduce_kernelvectors = reduce_kernelvectors
        self.reduce_kernelvectors_cutoff = reduce_kernelvectors_cutoff
        self.reduce_kernelvectors_stepsize = reduce_kernelvectors_stepsize
        self.unimodular_transform = unimodular_transform
        self.approximation_decimals = approximation_decimals
        self.regularization = regularization
        self.normalize_transformation = normalize_transformation
        self.redundancyfactor = redundancyfactor
        self.pseudo = pseudo
        self.pseudo_columnfactor = max(1.0, pseudo_columnfactor)
        self.extracolumns_linindep = extracolumns_linindep


# ---------------------------------------------------------------------------
# numeric helpers on DDScalar matrices
# ---------------------------------------------------------------------------

def _to_f64(m):
    return np.array([[float(x) for x in row] for row in np.asarray(m)],
                    dtype=np.float64)


def _dd_rref_colpivot(mat_rows: List[List[DDScalar]], tol: float):
    """Thresholded RREF with column pivoting in double-word host arithmetic.

    Returns the nonzero reduced rows (in original column order), like the
    QR-based RREF of rounding.jl:595-605.
    """
    rows = [[DDScalar(x) for x in r] for r in mat_rows]
    m = len(rows)
    n = len(rows[0]) if m else 0
    used_rows = []
    used_cols = set()
    r = 0
    while r < m:
        # pick the largest remaining entry (full pivoting on columns)
        best = (None, None, tol)
        for i in range(m):
            if i in used_rows:
                continue
            for j in range(n):
                if j in used_cols:
                    continue
                v = abs(float(rows[i][j]))
                if v > best[2]:
                    best = (i, j, v)
        if best[0] is None:
            break
        pi, pj, _ = best
        piv = rows[pi][pj]
        rows[pi] = [x / piv for x in rows[pi]]
        for i in range(m):
            if i != pi and float(abs(rows[i][pj])) != 0.0:
                f = rows[i][pj]
                rows[i] = [x - f * y for x, y in zip(rows[i], rows[pi])]
        used_rows.append(pi)
        used_cols.add(pj)
        r += 1
    return [rows[i] for i in used_rows]


def _rationalize(x: DDScalar, errbound: float) -> Fraction:
    """Best rational approximation within errbound (continued fractions)."""
    fx = x.as_fraction() if isinstance(x, DDScalar) else to_fraction(x)
    den = 1
    while den <= 10 ** 20:
        cand = Fraction(fx).limit_denominator(den)
        if abs(cand - fx) < Fraction(errbound).limit_denominator(10 ** 30):
            return cand
        den *= 10
    return fx


def _round_entry(x: DDScalar, FF, g, settings) -> object:
    """Round a numerical value into QQ or the number field FF
    (roundx, rounding.jl:515-534)."""
    if FF is QQ or FF is None:
        return _rationalize(x, settings.kernel_round_errbound)
    deg = FF.degree
    vec = [x.as_fraction() if isinstance(x, DDScalar) else to_fraction(x)]
    gfr = to_fraction(g if g is not None else FF.approx_root)
    for dd in range(deg):
        vec.append(gfr ** dd)
    a = clindep([[v] for v in vec], settings.kernel_bits,
                settings.kernel_round_errbound)
    z = FF.gen()
    out = FF(0)
    for dd in range(deg):
        out = out + FF(-Fraction(a[dd + 1], a[0])) * z ** dd
    return out


def _embed_f64(x, g):
    if isinstance(x, NFElem):
        return float(x.embed(g))
    return float(x)


# ---------------------------------------------------------------------------
# kernel detection (rounding.jl:575-642)
# ---------------------------------------------------------------------------

def detecteigenvectors(dualblock, primalblock, FF, g, settings, verbose=True):
    dm64 = _to_f64(dualblock)
    pm64 = _to_f64(primalblock)
    n = pm64.shape[0]
    if (not settings.kernel_use_dual
            or np.abs(dm64).max() > 1.0 / np.sqrt(settings.kernel_round_errbound)):
        u, s, vt = np.linalg.svd(pm64)
        num = int(np.sum(np.abs(s) < settings.kernel_errbound))
        if num == 0:
            return []
        mat = [[DDScalar(u[i, n - num + k]) for i in range(n)]
               for k in range(num)]
    else:
        mat = [[DDScalar(x) for x in row] for row in np.asarray(dualblock)]
    vecs = _dd_rref_colpivot(mat, settings.kernel_errbound)
    kernel_vecs = []
    for v in vecs:
        kv = [_round_entry(x, FF, g, settings) for x in v]
        # verify: primalblock @ kv ~ 0
        kvf = np.array([_embed_f64(x, g) for x in kv])
        res = pm64 @ kvf
        if np.abs(res).max() > settings.kernel_errbound:
            raise ValueError(
                f"wrong kernel vector detected (error {np.abs(res).max():.2e})")
        kernel_vecs.append(kv)
    return kernel_vecs


def detecteigenvectors_lll(m_block, bits, errbound, FF, g):
    """Kernel detection via LLL integer relations (rounding.jl:645-740).

    Finds integer relations among the rows of the (field-power-stacked)
    approximate-kernel singular vectors; the nullspace of the accumulated
    relation matrix spans the exact kernel. Returns vectors over FF."""
    pm64 = _to_f64(m_block)
    n = pm64.shape[0]
    deg = 1 if (FF is QQ or FF is None) else FF.degree
    gfr = to_fraction(g) if deg > 1 else Fraction(1)
    gex = FF.gen() if deg > 1 else Fraction(1)

    u, s, _ = np.linalg.svd(pm64)
    ker = [i for i in range(n) if abs(s[i]) < errbound]
    if n == 1 and abs(pm64[0, 0]) <= 1e-6:
        int_vecs = [[1] * deg]
    elif not ker:
        return []
    else:
        num = len(ker)
        # rows of m: entry index stacked over field powers; columns: the
        # approximate kernel basis vectors (rounding.jl:654-656)
        m = [[Fraction(float(gfr ** k * u[i, j])).limit_denominator(10 ** 17)
              for j in ker] for k in range(deg) for i in range(n)]
        nrows_m = deg * n
        A_rows = []
        s_idx = list(range(nrows_m))
        int_vecs = []
        while s_idx:
            l = clindep([m[i] for i in s_idx], bits, errbound)
            if deg == 1:
                row = [0] * nrows_m
                for idx, val in zip(s_idx, l):
                    row[idx] = val
                A_rows.append(row)
            else:
                # one FF equation -> deg rational equations, matched per
                # power of the generator (rounding.jl:679-695)
                cur = [FF(0)] * n
                for idx, val in zip(s_idx, l):
                    k, i = divmod(idx, n)
                    cur[i] = cur[i] + FF(Fraction(val)) * gex ** k
                AQQ, _ = convert_system(FF, [cur], [FF(0)])
                for r in AQQ:
                    den = 1
                    for x in r:
                        den = lcm(den, Fraction(x).denominator)
                    A_rows.append([int(x * den) for x in r])
            rank, _ = rref([[Fraction(x) for x in row] for row in A_rows])
            if nrows_m - rank - deg * num <= 0:
                _, X = nullspace_from_rref(
                    [[Fraction(x) for x in row] for row in A_rows])
                cols = transpose(X)
                cols = integerize_rows(cols)
                int_vecs = [[int(x) for x in c] for c in cols]
                break
            if all(x == 0 for x in l):
                break
            first_nz = next(j for j, x in enumerate(l) if x != 0)
            s_idx.pop(first_nz)

    out = []
    for v in int_vecs:
        # v has length deg*n over ZZ; fold back into FF and verify
        vf = np.zeros(n)
        vff = [FF(0) if deg > 1 else Fraction(0)] * n
        for k in range(deg):
            for i in range(n):
                c = v[k * n + i]
                if c:
                    vf[i] += float(gfr ** k) * c
                    vff[i] = vff[i] + (FF(Fraction(c)) * gex ** k
                                       if deg > 1 else Fraction(c))
        res = np.abs(pm64 @ vf).max()
        if res > 1e-8:
            raise ValueError(
                f"wrong kernel vector detected via LLL (error {res:.2e})")
        out.append(vff)
    return out


# ---------------------------------------------------------------------------
# kernel vector simplification (rounding.jl:860-1104)
# ---------------------------------------------------------------------------

def _reduction_step(kernelvecs):
    ambient = len(kernelvecs[0])
    nullity, X = nullspace_from_rref(kernelvecs)
    ns = transpose(X)  # rows are nullspace vectors
    ns = integerize_rows(ns)
    ns_int = [[int(x) for x in row] for row in ns]
    if not ns_int:
        # kernel vectors span everything (rounding.jl:1086)
        return ambient, [[1 if i == j else 0 for j in range(ambient)]
                         for i in range(ambient)]
    # [H; 0] = T ns^T -> the last columns of T^T span the nullspace of ns
    H, T = hnf_normalmultiplier_with_transform(transpose(ns_int))
    kernel_dim = 0
    nrowsH = len(H)
    for i in range(nrowsH - 1, -1, -1):
        if any(H[i][j] != 0 for j in range(len(H[i]))):
            kernel_dim = nrowsH - 1 - i
            break
    else:
        kernel_dim = nrowsH
    return kernel_dim, transpose(T)


def simplify_kernelvectors(m_block, finalvectors, FF, g, settings, verbose=True):
    N = len(finalvectors[0])
    FF_kerneldim = len(finalvectors)
    deg = 1 if (FF is QQ or FF is None) else FF.degree
    if deg > 1:
        z = FF.gen()

        def _c(v, k):
            return v.coeffs[k] if isinstance(v, NFElem) else (
                to_fraction(v) if k == 0 else Fraction(0))

        lst = []
        for v in finalvectors:
            for i in range(deg):
                vi = [x * z ** i if isinstance(x, NFElem) else FF(x) * z ** i
                      for x in v]
                # QQ-structure row: concat over powers k of the coefficient
                # vectors (rounding.jl:868)
                lst.append([_c(c, k) for k in range(deg) for c in vi])
        # deduplicate rows
        seen = set()
        lst = [r for r in lst if not (tuple(r) in seen or seen.add(tuple(r)))]
    else:
        lst = [[to_fraction(x) for x in v] for v in finalvectors]

    pm64 = _to_f64(m_block)

    if not settings.reduce_kernelvectors:
        kernel_dim = len(lst)
        B = transpose(lst)
        B = _complete_basis(B, N)
        return _finish_B(B, kernel_dim, FF, g, settings, pm64,
                         front=True), FF_kerneldim

    if settings.kernel_lll:
        # the LLL route already went through a nullspace, so only the last
        # step remains: clear denominators and LLL-reduce (rounding.jl:873-881)
        rows_int = []
        for r in lst:
            den = 1
            for x in r:
                den = lcm(den, Fraction(x).denominator)
            rows_int.append([int(x * den) for x in r])
        kv_red = lll_reduce(rows_int)
        kernel_dim = len(kv_red)
        B = _complete_basis(
            transpose([[Fraction(x) for x in r] for r in kv_red]), len(lst[0]))
        return _finish_B(B, kernel_dim, FF, g, settings, pm64,
                         front=True), FF_kerneldim

    # rows of `kernelvecs` are the kernel vectors; permute columns so the
    # one-hot (RREF pivot) columns come first
    kernelvecs = [list(r) for r in lst]
    ncols = N if deg == 1 else N * deg
    nrows = len(kernelvecs)
    onehots = [0] * nrows
    for col in range(ncols):
        nz = [i for i in range(nrows) if kernelvecs[i][col] != 0]
        if len(nz) == 1 and kernelvecs[nz[0]][col] == 1:
            if onehots[nz[0]] == 0:
                onehots[nz[0]] = col + 1
    if any(o == 0 for o in onehots):
        # fall back: no reduction
        kernel_dim = len(lst)
        B = _complete_basis(transpose(lst), ncols)
        return _finish_B(B, kernel_dim, FF, g, settings, pm64,
                         front=True), FF_kerneldim
    indices = []
    for o in onehots:
        indices.append(o - 1)
    for c in range(ncols):
        if c not in indices:
            indices.append(c)
    indices_rev = [indices.index(k) for k in range(ncols)]
    kernelvecs = [[row[c] for c in indices] for row in kernelvecs]

    if ncols > settings.reduce_kernelvectors_cutoff:
        # windowed submatrix iteration (rounding.jl:897-947): reduce using
        # the identity block plus a growing window of leading/trailing
        # columns; accept once the transformed matrix is integral (or at
        # least no larger than the input), else widen the window.
        initial_max = max(
            max((abs(Fraction(x).numerator) for r in lst for x in r),
                default=1),
            max((Fraction(x).denominator for r in lst for x in r), default=1))
        s_step = max(1, settings.reduce_kernelvectors_stepsize)
        kiter = 1
        while True:
            lead = min(nrows + s_step * kiter, ncols)
            cols = list(range(lead))
            cols += [c for c in range(max(lead, ncols - s_step * kiter), ncols)]
            part = [[row[c] for c in cols] for row in kernelvecs]
            kernel_dim, B_part = _reduction_step(part)
            w = len(B_part[0])
            # coefficient vectors: the identity block occupies the first
            # `nrows` window columns, so a kernel column's leading entries
            # are its coefficients over the original kernel vectors
            C = [[Fraction(B_part[i][w - kernel_dim + c])
                  for i in range(nrows)] for c in range(kernel_dim)]
            reduced = mat_mul(C, kernelvecs)
            if all(Fraction(x).denominator == 1 for r in reduced for x in r):
                kv_red = lll_reduce([[int(x) for x in r] for r in reduced])
                break
            rows_int = []
            for r in reduced:
                den = 1
                for x in r:
                    den = lcm(den, Fraction(x).denominator)
                rows_int.append([int(x * den) for x in r])
            kv_red = lll_reduce(rows_int)
            maxnum = max(abs(x) for r in kv_red for x in r)
            if maxnum <= initial_max:
                if verbose:
                    print(f"    window {kiter}: non-integer transform, "
                          f"max {maxnum} <= initial {initial_max}; accepting")
                break
            kiter += 1
        kernel_dim = len(kv_red)
        B = transpose([[Fraction(x) for x in r] for r in kv_red])
        B = [B[indices_rev[i]] for i in range(ncols)]
        B = _complete_basis(B, ncols)
        return _finish_B(B, kernel_dim, FF, g, settings, pm64,
                         front=True), FF_kerneldim

    kernel_dim, B = _reduction_step(kernelvecs)
    # columns of B: last kernel_dim are the kernel vectors (integers)
    B = [[Fraction(x) for x in row] for row in B]
    ncolsB = len(B[0])
    kv_cols = [[int(B[i][ncolsB - kernel_dim + k]) for i in range(len(B))]
               for k in range(kernel_dim)]
    kv_red = lll_reduce(kv_cols)
    if settings.unimodular_transform:
        for k in range(kernel_dim):
            for i in range(len(B)):
                B[i][ncolsB - kernel_dim + k] = Fraction(kv_red[k][i])
        # reorder: kernel columns first
        B = [[row[ncolsB - kernel_dim + k] for k in range(kernel_dim)]
             + [row[k] for k in range(ncolsB - kernel_dim)] for row in B]
    else:
        B = transpose(kv_red)
        B = _complete_basis(B, ncolsB)
        B = [[Fraction(x) for x in row] for row in B]
    # undo the column permutation (rows of B correspond to entries)
    B = [B[indices_rev[i]] for i in range(len(B))]
    return _finish_B(B, kernel_dim, FF, g, settings, pm64,
                     front=True), FF_kerneldim


def _complete_basis(B_cols, N):
    """Complete the columns of B to a basis of R^N by adding unit vectors."""
    cols = transpose(B_cols) if B_cols else []
    have = [list(map(Fraction, c)) for c in cols]
    # Gram-Schmidt in float for independence testing
    acc = [np.array([float(x) for x in c]) for c in have]
    ortho = []
    for v in acc:
        w = v.copy()
        for u in ortho:
            w = w - (u @ w) / (u @ u) * u
        ortho.append(w)
    out = list(have)
    for i in range(N):
        cand = np.zeros(N)
        cand[i] = 1.0
        w = cand.copy()
        for u in ortho:
            w = w - (u @ w) / (u @ u) * u
        if w @ w > 1e-20:
            e = [Fraction(0)] * N
            e[i] = Fraction(1)
            out.append(e)
            ortho.append(w)
        if len(out) == N:
            break
    return transpose(out)


def _finish_B(B, kernel_dim, FF, g, settings, pm64, front=True):
    """verify kernel columns + convert back to FF for deg>1."""
    deg = 1 if (FF is QQ or FF is None) else FF.degree
    if deg > 1:
        N = len(B) // deg
        ncols = len(B[0])
        z = FF.gen()
        cols = []
        for c in range(ncols):
            col = [FF(0)] * N
            for j in range(deg):
                for i in range(N):
                    if B[j * N + i][c] != 0:
                        col[i] = col[i] + FF(B[j * N + i][c]) * z ** j
            cols.append(col)
        # linear independence selection over the embedding
        floats = [np.array([_embed_f64(x, g) for x in col]) for col in cols]
        # also add unit vectors to complete
        for i in range(N):
            e = [FF(0)] * N
            e[i] = FF(1)
            cols.append(e)
            v = np.zeros(N)
            v[i] = 1.0
            floats.append(v)
        chosen = []
        ortho = []
        for i, v in enumerate(floats):
            w = v.copy()
            for u in ortho:
                w = w - (u @ w) / (u @ u) * u
            if w @ w > 1e-20:
                chosen.append(i)
                ortho.append(w)
            if len(chosen) == N:
                break
        cols = [cols[i] for i in chosen]
        Bff = [[cols[c][i] for c in range(N)] for i in range(N)]
        return Bff
    return B


# ---------------------------------------------------------------------------
# basis transformations (rounding.jl:750-858)
# ---------------------------------------------------------------------------

def basis_transformations(dualsol: DualSolution, sol: PrimalSolution, FF, g,
                          settings: RoundingSettings, verbose=True):
    Bs = {}
    keys = sorted(sol.matrixvars.keys(),
                  key=lambda k: (np.asarray(sol.matrixvars[k]).shape[0], sortkey(k)))
    for k in keys:
        m = np.asarray(sol.matrixvars[k])
        dm = np.asarray(dualsol.matrixvars[k])
        N = m.shape[0]
        if verbose:
            print(f"  Block {k!r} of size {N} x {N}")
        if settings.kernel_lll:
            one = Fraction(1) if (FF is QQ or FF is None) else FF(1)
            zero = Fraction(0) if (FF is QQ or FF is None) else FF(0)
            # near-zero diagonal entries give unit kernel vectors for free;
            # restrict the LLL search to the complement (rounding.jl:758-775)
            zerolist = [i for i in range(N)
                        if abs(float(m[i, i])) < settings.kernel_errbound]
            nonzero = [i for i in range(N) if i not in zerolist]
            kernel_vecs = []
            for i in zerolist:
                v = [zero] * N
                v[i] = one
                kernel_vecs.append(v)
            if nonzero:
                sub = m[np.ix_(nonzero, nonzero)]
                for vec in detecteigenvectors_lll(
                        sub, settings.kernel_bits, settings.kernel_errbound,
                        FF, g):
                    v = [zero] * N
                    for ii, val in zip(nonzero, vec):
                        v[ii] = val
                    kernel_vecs.append(v)
        else:
            kernel_vecs = detecteigenvectors(dm, m, FF, g, settings, verbose)
        if kernel_vecs:
            B, num_kernelvecs = simplify_kernelvectors(
                m, kernel_vecs, FF, g, settings, verbose)
        else:
            num_kernelvecs = 0
            one = Fraction(1) if (FF is QQ or FF is None) else FF(1)
            zero = Fraction(0) if (FF is QQ or FF is None) else FF(0)
            B = [[one if i == j else zero for j in range(N)] for i in range(N)]
        Binv = mat_inv(B)
        deg = 1 if (FF is QQ or FF is None) else FF.degree
        if deg == 1 and settings.normalize_transformation:
            lcms = []
            for i in range(len(Binv)):
                l = 1
                for x in Binv[i]:
                    l = lcm(l, Fraction(x).denominator)
                lcms.append(l)
                Binv[i] = [x * l for x in Binv[i]]
            for i in range(len(B)):
                B[i] = [x / lcms[j] for j, x in enumerate(B[i])]
        Bs[k] = (transpose(B), Binv, num_kernelvecs)
    return Bs


# ---------------------------------------------------------------------------
# transforms (rounding.jl:1182-1253)
# ---------------------------------------------------------------------------

def _transform_exact(m, Binv, s):
    if isinstance(m, LowRankMatPol):
        vs = [mat_vec(Binv, v)[s:] for v in m.vs]
        ws = [mat_vec(Binv, w)[s:] for w in m.ws]
        return LowRankMatPol(m.lam, vs, ws)
    md = m if isinstance(m, np.ndarray) else np.array(m, dtype=object)
    rows = [[md[i, j] for j in range(md.shape[1])] for i in range(md.shape[0])]
    C = [row for row in Binv[s:]]
    t1 = mat_mul(C, rows)
    return np.array(mat_mul(t1, transpose(C)), dtype=object)


def transform_problem(problem: Problem, Bs):
    matrixcoeff = {}
    for k, m in problem.objective.matrixcoeff.items():
        if Bs[k][2] < _blocksize(m):
            matrixcoeff[k] = _transform_exact(m, Bs[k][1], Bs[k][2])
    objective = Objective(problem.objective.constant, matrixcoeff,
                          problem.objective.freecoeff)
    cons = []
    for con in problem.constraints:
        mc = {}
        for k, m in con.matrixcoeff.items():
            if Bs[k][2] < _blocksize(m):
                mc[k] = _transform_exact(m, Bs[k][1], Bs[k][2])
        cons.append(Constraint(con.constant, mc, con.freecoeff, con.samples,
                               con.scalings))
    return Problem(problem.maximize, objective, cons)


def _blocksize(m):
    return m.shape[0] if hasattr(m, "shape") else len(m)


def _num_dd(x, g):
    if isinstance(x, NFElem):
        return DDScalar(x.embed(g))
    return DDScalar(to_fraction(x))


def transform_solution(sol: PrimalSolution, Bs, g):
    mv = {}
    for k, m in sol.matrixvars.items():
        Bt, Binv, s = Bs[k]
        if s < np.asarray(m).shape[0]:
            Btf = [[_num_dd(x, g) for x in row] for row in Bt]
            md = np.asarray(m)
            rows = [[md[i, j] for j in range(md.shape[1])]
                    for i in range(md.shape[0])]
            C = Btf[s:]
            t1 = mat_mul(C, rows)
            out = mat_mul(t1, transpose(C))
            mv[k] = np.array(out, dtype=object)
    return PrimalSolution(mv, sol.freevars)


def undo_transform(sol: PrimalSolution, Bs, FF):
    mv = {}
    zero = Fraction(0) if (FF is QQ or FF is None) else FF(0)
    for k, (Bt, Binv, s) in Bs.items():
        N = len(Bt)
        M = [[zero for _ in range(N)] for _ in range(N)]
        if k in sol.matrixvars:
            sub = sol.matrixvars[k]
            for i in range(N - s):
                for j in range(N - s):
                    M[s + i][s + j] = sub[i, j]
            C = transpose(Binv)  # rows of C = columns of Binv
            out = mat_mul(mat_mul(C, M), transpose(C))
            mv[k] = np.array(out, dtype=object)
        else:
            mv[k] = np.array(M, dtype=object)
    return PrimalSolution(mv, sol.freevars)


# ---------------------------------------------------------------------------
# projection onto the affine space (rounding.jl:95-364)
# ---------------------------------------------------------------------------

def select_columns(problem, sol, redundancyfactor, verbose=True, rng=None):
    rng = rng or random.Random(1234)
    nconstraints = sum(len(c.samples) for c in problem.constraints)
    x = vectorize(sol)
    nvars = len(x)
    if redundancyfactor < 0:
        return list(range(nvars))
    v = as_primal_solution(sol, [0] * nvars)
    for k, m in v.matrixvars.items():
        n = m.shape[0]
        mm = np.zeros((n, n), dtype=object)
        for i in range(n):
            mm[i, i] = 1
            if i + 1 < n:
                mm[i, i + 1] = mm[i + 1, i] = 1
        v.matrixvars[k] = mm
    for k, m in problem.objective.matrixcoeff.items():
        if k in v.matrixvars:
            md = m.to_dense() if isinstance(m, LowRankMatPol) else np.asarray(m)
            for i in range(md.shape[0]):
                for j in range(md.shape[1]):
                    if not _iszero(md[i, j]):
                        v.matrixvars[k][i, j] += 2
    for k, m in problem.objective.freecoeff.items():
        if k in v.freevars and not _iszero(m):
            v.freevars[k] = 2
    vvec = vectorize(v)
    obj_cols = [i for i, val in enumerate(vvec) if _asint(val) >= 2]
    chosen = [i for i, val in enumerate(vvec) if _asint(val) == 1]
    if len(obj_cols) + len(chosen) > redundancyfactor * nconstraints:
        pool = obj_cols + chosen
        rng.shuffle(pool)
        pivot_cols = pool[: redundancyfactor * nconstraints]
        pivot_cols = list(dict.fromkeys(
            [i for i in pivot_cols if i in set(obj_cols)] + pivot_cols))
    else:
        pivot_cols = obj_cols + chosen
    nneeded = redundancyfactor * nconstraints - len(pivot_cols)
    nneeded = max((redundancyfactor - 2) * nconstraints, nneeded)
    notchosen = [i for i, val in enumerate(vvec) if _asint(val) == 0]
    rng.shuffle(notchosen)
    pivot_cols.extend(notchosen[: max(0, min(nneeded, len(notchosen)))])
    if verbose:
        print(f"  Reducing the system from {nvars} to {len(pivot_cols)} columns")
    return pivot_cols


def _asint(v):
    try:
        return int(v)
    except Exception:
        return 0


def _iszero(x):
    try:
        return x == 0
    except Exception:
        return False


def _roundx_vec(x, power):
    """Entrywise decimal truncation to `power` digits (rounding.jl:515-517)."""
    scale = Fraction(10) ** power
    out = []
    for v in x:
        fv = v.as_fraction() if isinstance(v, DDScalar) else to_fraction(v)
        sc = fv * scale
        out.append(Fraction(sc.numerator // sc.denominator, 1) / scale)
    return out


def project_affine(problem, sol, FF, g, settings, monomial_bases, verbose=True):
    extra_redundancy = 0
    rng = random.Random(42)
    is_field = FF is not QQ and FF is not None
    while True:
        columns = select_columns(problem, sol,
                                 settings.redundancyfactor + extra_redundancy,
                                 verbose=verbose, rng=rng)
        if not is_field:
            x = vectorize(sol)
            x = _roundx_vec(x, settings.approximation_decimals)
            xsol = as_primal_solution(sol, x)
            A, b = partial_linearsystem(problem, xsol, columns,
                                        monomial_bases=monomial_bases)
        else:
            A, b, x, columns = _field_rational_system(
                problem, sol, FF, g, columns, monomial_bases, settings,
                verbose=verbose)
        x_extra, correct_slacks, finished = _project_affine_system(
            A, b, settings, verbose=verbose)
        if not finished and len(x) > len(columns):
            extra_redundancy += 2
            continue
        if not finished:
            raise ValueError("The system is inconsistent but all columns used")
        for jj, i in enumerate(columns):
            x[i] = x[i] + x_extra[jj]
        if is_field:
            x = _x_to_field(x, FF)
        return as_primal_solution(sol, x), correct_slacks


def convert_system(FF, A, b):
    """Field system over FF -> block system over QQ (rounding.jl:1256-1282):
    sum_i A_i g^i acting on sum_j x_j g^j, matched per power g^k."""
    deg = FF.degree
    z = FF.gen()

    def _c(v, k):
        if isinstance(v, NFElem):
            return v.coeffs[k]
        return to_fraction(v) if k == 0 else Fraction(0)

    n = len(A)
    m = len(A[0]) if n else 0
    Ai = [[[_c(A[r][c], k) for c in range(m)] for r in range(n)]
          for k in range(deg)]
    btot = [_c(b[r], k) for k in range(deg) for r in range(n)]
    Atot = [[Fraction(0)] * (m * deg) for _ in range(n * deg)]
    for i in range(deg):
        for j in range(deg):
            cur = z ** (i + j)
            for k in range(deg):
                ck = cur.coeffs[k] if isinstance(cur, NFElem) else (
                    to_fraction(cur) if k == 0 else Fraction(0))
                if ck != 0:
                    for r in range(n):
                        Arow = Ai[i][r]
                        out = Atot[n * k + r]
                        for c in range(m):
                            if Arow[c] != 0:
                                out[m * j + c] += ck * Arow[c]
    return Atot, btot


def _field_rational_system(problem, sol, FF, g, columns, monomial_bases,
                           settings, verbose=True):
    """get_rational_system for number fields (rounding.jl:1299-1330)."""
    from ..model.linearsystem import (linearsystem,
                                      linearsystem_coefficientmatching)

    deg = FF.degree
    if monomial_bases is None:
        A, b = linearsystem(problem)
    else:
        A, b = linearsystem_coefficientmatching(problem, monomial_bases)
    nvars = len(A[0])
    A, b = convert_system(FF, A, b)
    x = vectorize(sol)

    # approximate the higher-power components by regularized least squares
    # (rounding.jl:537-568), in extended (longdouble) precision
    Af = np.array([[float(v) for v in row] for row in A], dtype=np.longdouble)
    bf = np.array([float(v) for v in b], dtype=np.longdouble)
    xf = np.array([float(v) for v in x], dtype=np.longdouble)
    gf = np.longdouble(float(g))
    m = len(x)
    Acols = Af[:, :m]
    rhs = bf - Acols @ xf
    for j in range(1, deg):
        Af[:, m * j: m * (j + 1)] -= gf ** j * Acols
    B = Af[:, m:]
    reg = np.longdouble(settings.regularization)
    lhs = B.T @ B + reg * np.eye(B.shape[1], dtype=np.longdouble)
    y = np.linalg.solve(lhs.astype(np.float64), (B.T @ rhs).astype(np.float64))
    y = y.astype(np.longdouble)

    power = settings.approximation_decimals
    x_dd = [v.as_fraction() if isinstance(v, DDScalar) else to_fraction(v)
            for v in x]
    gfr = to_fraction(g)
    x0 = list(x_dd)
    for i in range(1, deg):
        for t in range(m):
            x0[t] = x0[t] - gfr ** i * Fraction(float(y[m * (i - 1) + t]))
    x0 = _roundx_vec(x0, power)
    xfinal = x0 + _roundx_vec([Fraction(float(v)) for v in y], power)

    # error system: b <- b - A x_rounded, restricted to expanded columns
    bnew = []
    for r in range(len(A)):
        acc = b[r]
        row = A[r]
        for c in range(len(row)):
            if row[c] != 0 and xfinal[c] != 0:
                acc = acc - row[c] * xfinal[c]
        bnew.append(acc)
    exp_columns = [i + nvars * k for i in columns for k in range(deg)]
    Asub = [[row[c] for c in exp_columns] for row in A]
    return Asub, bnew, xfinal, exp_columns


def _x_to_field(x, FF):
    """x = concat of x_j with value sum_j x_j g^j (rounding.jl:1332-1341)."""
    deg = FF.degree
    z = FF.gen()
    n = len(x) // deg
    out = []
    for i in range(n):
        v = FF(0)
        for k in range(deg):
            if x[n * k + i] != 0:
                v = v + FF(x[n * k + i]) * z ** k
        out.append(v)
    return out


def _project_affine_system(A, b, settings, verbose=True):
    A, b = integerize_rows(A, b)
    A2, b2 = integerize_rows([list(r) for r in A], list(b), include_b=True)
    Ab = [row + [bb] for row, bb in zip(A2, b2)]
    pivots = find_pivots_modular([[int(x) for x in row] for row in Ab])
    ncolsA = len(A[0])
    if pivots and pivots[-1] == ncolsA:
        if verbose:
            print("  The system is inconsistent; taking more columns")
        return [Fraction(0)] * ncolsA, False, False
    rows = list(range(len(A)))
    if len(pivots) < len(A):
        if verbose:
            print(f"  Not enough pivots ({len(pivots)} of {len(A)} rows)")
        sub = [[int(A[i][j]) for i in range(len(A))] for j in pivots]
        rows = find_pivots_modular(sub)

    if settings.pseudo:
        try:
            rng = random.Random(7)
            if settings.extracolumns_linindep:
                # grow the extra-column set in rounds, keeping only columns
                # linearly independent over the selected rows
                # (rounding.jl:216-227)
                extracolumns = []
                chosen = set(pivots)
                target = settings.pseudo_columnfactor * len(rows)
                while len(chosen) < target:
                    nonpivots = [i for i in range(ncolsA) if i not in chosen]
                    if not nonpivots:
                        break
                    rng.shuffle(nonpivots)
                    sub = [[int(A[i][j]) for j in nonpivots] for i in rows]
                    extra = find_pivots_modular(sub)
                    if not extra:
                        break
                    newcols = [nonpivots[j] for j in extra]
                    extracolumns.extend(newcols)
                    chosen.update(newcols)
                nonpivots = extracolumns
            else:
                nonpivots = [i for i in range(ncolsA) if i not in set(pivots)]
                rng.shuffle(nonpivots)
            column_subset = list(dict.fromkeys(list(pivots) + nonpivots))
            column_subset = column_subset[
                : min(len(column_subset),
                      round(settings.pseudo_columnfactor * len(rows)))]
            As = [[A[i][j] for j in column_subset] for i in rows]
            bs = [b[i] for i in rows]
            newx = _solve_pseudoinverse(As, bs)
            xfull = [Fraction(0)] * ncolsA
            for jj, c in enumerate(column_subset):
                xfull[c] = newx[jj]
            correct = all(
                sum(A[i][j] * xfull[j] for j in range(ncolsA) if xfull[j] != 0)
                == b[i] for i in range(len(A)))
            return xfull, correct, True
        except Exception as e:
            if verbose:
                print(f"  pseudoinverse route failed ({e}); trying pivots")
    Apiv = [[A[i][j] for j in pivots] for i in range(len(A))]
    if len(Apiv) != len(pivots):
        At = transpose(Apiv)
        AtA = mat_mul(At, Apiv)
        Atb = mat_vec(At, b)
        newx = solve_dixon(AtA, Atb)
        correct = all(sum(AtA[i][j] * newx[j] for j in range(len(newx)))
                      == Atb[i] for i in range(len(Atb)))
    else:
        newx = solve_dixon(Apiv, b)
        correct = True
    xfull = [Fraction(0)] * ncolsA
    for jj, c in enumerate(pivots):
        xfull[c] = newx[jj]
    return xfull, correct, True


def _solve_pseudoinverse(A, b):
    """Minimum-norm solution via AA^T (rounding.jl:336-364)."""
    At = transpose(A)
    if len(A[0]) > len(A):
        AAt = mat_mul(A, At)
        y = solve_dixon(AAt, b)
        return mat_vec(At, y)
    AtA = mat_mul(At, A)
    Atb = mat_vec(At, b)
    y = solve_dixon(AtA, Atb)
    return y


# ---------------------------------------------------------------------------
# validity (rounding.jl:367-472)
# ---------------------------------------------------------------------------

def _sqrt_ub(q: Fraction) -> Fraction:
    """Exact rational UPPER bound on sqrt(q): sqrt(p/r) <= (isqrt(p*r)+1)/r."""
    if q <= 0:
        return Fraction(0)
    p, r = q.numerator, q.denominator
    return Fraction(isqrt(p * r) + 1, r)


def _psd_float_certificate(a, n, g, strict=True) -> bool:
    """Rigorous PSD certificate from a FLOAT Cholesky (the analogue of the
    reference's Arb-ball Cholesky screen with precision escalation,
    rounding.jl:367-472): compute L = chol(A) in float64, then certify
    EXACTLY that A = L L^T + E with sigma_min(L)^2 > ||E||_F.

    L's entries are dyadic rationals (floats), so L L^T and E = A - L L^T
    are exact small-denominator arithmetic regardless of how large the
    entries' exact denominators are — this is what makes the screen cheap
    where plain exact LDL^T suffers coefficient blowup. Returns True only
    on a sound certificate; False means inconclusive (caller escalates to
    the exact factorization). Number-field entries are embedded at 80
    digits with a 1e-50 evaluation-slack margin."""
    if not strict or n == 0:
        return False

    def to_float(x):
        if isinstance(x, NFElem):
            return float(x.embed(g, digits=80))
        return float(x)

    try:
        Af = np.array([[to_float(a[i][j]) for j in range(n)]
                       for i in range(n)], dtype=np.float64)
        L = np.linalg.cholesky(Af)
    except (np.linalg.LinAlgError, OverflowError, ValueError):
        return False
    smin = float(np.linalg.svd(L, compute_uv=False)[-1])
    if not np.isfinite(smin) or smin <= 0:
        return False
    # exact E = A - L L^T; its Frobenius norm bounded through the embedding
    Lf = [[Fraction(L[i, j]) for j in range(n)] for i in range(n)]
    fro2 = Fraction(0)
    slack = Fraction(1, 10 ** 50)
    for i in range(n):
        for j in range(n):
            ll = sum(Lf[i][t] * Lf[j][t] for t in range(min(i, j) + 1))
            e = a[i][j] - ll
            if isinstance(e, NFElem):
                mag = abs(Fraction(e.embed(g, digits=80))) + slack
            else:
                mag = abs(Fraction(e))
            fro2 += mag * mag
    # Sound certificate: lambda_min(A) >= sigma_min(L)^2 - ||E||_2 and
    # ||E||_2 <= ||E||_F.  The LAPACK smin carries absolute error up to
    # ~p(n)*eps*sigma_max (not just a factor), so lower-bound the true
    # sigma_min exactly: smin_lo = smin - 10*n*eps*sigma_max_ub with
    # sigma_max <= ||L||_F bounded by exact rational arithmetic.
    eps = Fraction(1, 2 ** 52)
    froL2 = Fraction(0)
    for i in range(n):
        for j in range(i + 1):
            froL2 += Lf[i][j] * Lf[i][j]
    smin_lo = Fraction(smin) - Fraction(10 * n) * eps * _sqrt_ub(froL2)
    if smin_lo <= 0:
        return False
    return smin_lo * smin_lo > _sqrt_ub(fro2)


def _is_psd_exact(m, FF, g, strict=True) -> bool:
    """Exact LDL^T positive-(semi)definiteness over Q or a number field.

    Field-element signs are decided by the real embedding at the approximate
    root (rounding.jl:417-445 uses Arb root balls; we use high-precision
    Decimal evaluation)."""
    n = m.shape[0] if hasattr(m, "shape") else len(m)
    a = [[m[i, j] if hasattr(m, "shape") else m[i][j] for j in range(n)]
         for i in range(n)]

    # cheap sound screen first: a float Cholesky certified exactly (the
    # reference's ball-Cholesky-with-escalation role, rounding.jl:367-472)
    if _psd_float_certificate(a, n, g, strict=strict):
        return True

    def sign(x):
        if isinstance(x, NFElem):
            d = x.embed(g, digits=80)
            if d == 0 and x.is_zero():
                return 0
            return 1 if d > 0 else (-1 if d < 0 else 0)
        return 1 if x > 0 else (-1 if x < 0 else 0)

    for k in range(n):
        s = sign(a[k][k])
        if s < 0:
            return False
        if s == 0:
            # zero pivot: the whole row/col must vanish for PSD
            if any(not _iszero(a[k][j]) for j in range(k, n)):
                return False
            if strict:
                return False
            continue
        piv = a[k][k]
        for i in range(k + 1, n):
            if not _iszero(a[i][k]):
                f = a[i][k] / piv
                for j in range(k + 1, n):
                    a[i][j] = a[i][j] - f * a[k][j]
                a[i][k] = 0 * a[i][k]
    return True


def is_valid_solution(problem, sol, FF, g, check_slacks=True, verbose=True):
    success = True
    if check_slacks:
        s = slacks(problem, sol)
        for i, si in enumerate(s):
            if not _iszero(si) and not (hasattr(si, "is_zero") and si.is_zero()):
                success = False
                warnings.warn(f"Constraint {i} is not satisfied")
    for k in sorted(sol.matrixvars.keys(),
                    key=lambda k: (np.asarray(sol.matrixvars[k]).shape[0],
                                   sortkey(k))):
        if not _is_psd_exact(sol.matrixvars[k], FF, g, strict=True):
            warnings.warn(f"Block {k!r} is not positive definite")
            success = False
    return success


# ---------------------------------------------------------------------------
# top level (rounding.jl:1366-1409)
# ---------------------------------------------------------------------------

def keeps_decimal_context(fn):
    """Run ``fn`` in a copy of the caller's Decimal context, so that the
    precision the rounding sets (find_field.py::_refine_root) does not
    outlast the call and change every later host compile."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with localcontext():
            return fn(*args, **kwargs)

    return wrapper


@keeps_decimal_context
def exact_solution(problem: Problem, dualsol: DualSolution,
                   primalsol: PrimalSolution, *, transformed=False, FF=QQ,
                   g=1, settings: RoundingSettings = None, monomial_bases=None,
                   verbose=True):
    """Round a numerical solution to an exact optimal one.

    Returns (success, exact PrimalSolution) — or
    (success, transformed solution, transformations) if `transformed`."""
    settings = settings or RoundingSettings()
    if verbose:
        print("** Starting computation of basis transformations **")
    Bs = basis_transformations(dualsol, primalsol, FF, g, settings, verbose)
    if verbose:
        print("** Transforming the problem and the solution **")
    transformed_primalsol = transform_solution(primalsol, Bs, g)
    transformed_problem = transform_problem(problem, Bs)
    if verbose:
        print("** Projecting the solution onto the affine space **")
    exact_sol, correct_slacks = project_affine(
        transformed_problem, transformed_primalsol, FF, g, settings,
        monomial_bases, verbose=verbose)
    if verbose:
        print("** Checking feasibility **")
    success = is_valid_solution(transformed_problem, exact_sol, FF, g,
                                check_slacks=not correct_slacks,
                                verbose=verbose)
    success = success and correct_slacks
    if transformed:
        final_transform = {k: [row[s:] for row in transpose(Binv)]
                           for k, (Bt, Binv, s) in Bs.items()}
        return success, exact_sol, final_transform
    return success, undo_transform(exact_sol, Bs, FF)
