"""SDP preprocessing: linear dependency detection and removal.

Equivalent of `ClusteredLowRankSolver.jl/src/pre_postprocessing.jl`:
- detect constraints that are linearly dependent in their PSD parts
  (float64 column-pivoted screen like pre_postprocessing.jl:287, then an
  exact-rational elimination replacing the reference's BigFloat confirm),
- derive the induced linear relations among free variables; raise on an
  infeasible 0 = b (pre_postprocessing.jl:87-95),
- rewrite B/c/b/constant by substitution (pre_postprocessing.jl:215-235),
- postprocess: re-insert zeros for removed constraint duals and recompute
  dependent free variables (pre_postprocessing.jl:237-276).

Operates on the compiled SDP's double-word data; the transformation is done
in exact rational arithmetic (hi+lo pairs are exact rationals), so no
precision is lost rewriting the SDP.
"""

from __future__ import annotations

import warnings
from fractions import Fraction

import numpy as np

__all__ = ["preprocess_sdp", "PreprocessError"]


class PreprocessError(ValueError):
    pass


def _frac(hi, lo):
    return Fraction(float(hi)) + Fraction(float(lo))


def _dd_pair(fr: Fraction):
    hi = float(fr)
    lo = float(fr - Fraction(hi))
    return hi, lo


def _vectorize_rows_f64(sdp):
    """f64 matrix whose rows vectorize each constraint's PSD parts."""
    rows = []
    for j, cl in enumerate(sdp.clusters):
        P = cl.nrows
        cols = []
        for bd in cl.blocks:
            n = bd.n
            A = np.zeros((P, n, n))
            if bd.kind == "dense":
                A = bd.A[0] + bd.A[1]
            else:
                V = bd.V[0] + bd.V[1]
                lam = (bd.lam[0] + bd.lam[1]) * bd.tmask
                for p in range(P):
                    for t in range(lam.shape[1]):
                        if bd.tmask[p, t]:
                            A[p] += lam[p, t] * np.outer(V[:, bd.ri[p, t]],
                                                         V[:, bd.li[p, t]])
            iu = np.triu_indices(n)
            sym = A + np.swapaxes(A, 1, 2)
            diag = np.arange(n)
            sym[:, diag, diag] = A[:, diag, diag]
            cols.append(sym[:, iu[0], iu[1]])
        if cl.scalars is not None:
            cols.append((cl.scalars.a[0] + cl.scalars.a[1]).T)
        rows.append(np.concatenate(cols, axis=1) if cols else np.zeros((P, 0)))
    L = max((r.shape[1] for r in rows), default=0)
    # different clusters touch disjoint PSD variables: block-diagonal layout
    total = sum(r.shape[1] for r in rows)
    out = np.zeros((sum(r.shape[0] for r in rows), total))
    r0 = 0
    c0 = 0
    for r in rows:
        out[r0:r0 + r.shape[0], c0:c0 + r.shape[1]] = r
        r0 += r.shape[0]
        c0 += r.shape[1]
    return out


def _vectorize_rows_exact(sdp):
    """Exact Fraction version of :func:`_vectorize_rows_f64`."""
    f64 = None  # build directly
    rows = []
    for j, cl in enumerate(sdp.clusters):
        P = cl.nrows
        per_row = [[] for _ in range(P)]
        for bd in cl.blocks:
            n = bd.n
            mats = [[[Fraction(0)] * n for _ in range(n)] for _ in range(P)]
            if bd.kind == "dense":
                for p in range(P):
                    for a in range(n):
                        for b in range(n):
                            mats[p][a][b] = _frac(bd.A[0][p, a, b], bd.A[1][p, a, b])
            else:
                Vf = [[_frac(bd.V[0][i, c], bd.V[1][i, c])
                       for c in range(bd.V[0].shape[1])] for i in range(n)]
                for p in range(P):
                    for t in range(bd.lam[0].shape[1]):
                        if bd.tmask[p, t]:
                            lam = _frac(bd.lam[0][p, t], bd.lam[1][p, t])
                            u = int(bd.ri[p, t])
                            w = int(bd.li[p, t])
                            for a in range(n):
                                if Vf[a][u] == 0:
                                    continue
                                la = lam * Vf[a][u]
                                for b in range(n):
                                    if Vf[b][w] != 0:
                                        mats[p][a][b] += la * Vf[b][w]
            for p in range(P):
                for a in range(n):
                    for b in range(a, n):
                        v = mats[p][a][b] if a == b else mats[p][a][b] + mats[p][b][a]
                        per_row[p].append(v)
        if cl.scalars is not None:
            sa = cl.scalars.a
            for p in range(P):
                for bidx in range(sa[0].shape[0]):
                    per_row[p].append(_frac(sa[0][bidx, p], sa[1][bidx, p]))
        rows.append(per_row)
    # block-diagonal concatenation
    widths = [len(r[0]) if r else 0 for r in rows]
    total = sum(widths)
    out = []
    c0 = 0
    for r, w in zip(rows, widths):
        for row in r:
            out.append([Fraction(0)] * c0 + row + [Fraction(0)] * (total - c0 - w))
        c0 += w
    return out


def _exact_dependencies(M):
    """Gaussian elimination over Q tracking each row's expression in the
    original rows. Returns (deps, dep_in_orig): dependent row indices and,
    for each, {independent_orig_row: coeff} with
    row_dep = sum coeff * row_orig."""
    if not M:
        return [], []
    ncols = len(M[0])
    basis = []        # reduced rows
    pivots = []       # pivot column per basis row
    basis_expr = []   # expression of each basis row in original rows
    deps = []
    dep_in_orig = []
    for i, row in enumerate(M):
        r = list(row)
        expr = {i: Fraction(1)}
        for (brow, bexp, pc) in zip(basis, basis_expr, pivots):
            if r[pc] != 0:
                f = r[pc] / brow[pc]
                for c in range(ncols):
                    if brow[c] != 0:
                        r[c] -= f * brow[c]
                for o, cc in bexp.items():
                    expr[o] = expr.get(o, Fraction(0)) - f * cc
        pc = next((c for c in range(ncols) if r[c] != 0), None)
        if pc is None:
            # sum expr * orig = 0 with expr[i] == 1
            deps.append(i)
            dep_in_orig.append({o: -cc for o, cc in expr.items()
                                if o != i and cc != 0})
        else:
            basis.append(r)
            pivots.append(pc)
            basis_expr.append(expr)
    return deps, dep_in_orig


def preprocess_sdp(sdp, verbose=False, tol=1e-10):
    """Returns (sdp, postprocess_fn); may modify `sdp` in place.

    postprocess_fn(x, y) re-inserts removed constraints/free variables into a
    solution of the reduced SDP (pre_postprocessing.jl:312-325).
    """
    # ---- fast float64 screen (pre_postprocessing.jl:287) -----------------
    M64 = _vectorize_rows_f64(sdp)
    if M64.shape[0] == 0:
        return sdp, lambda x, y: (x, y)
    rank = np.linalg.matrix_rank(M64, tol=tol * max(1.0, np.abs(M64).max()))
    if rank == M64.shape[0]:
        return sdp, lambda x, y: (x, y)

    # ---- exact elimination ------------------------------------------------
    M = _vectorize_rows_exact(sdp)
    deps, dep_in_orig = _exact_dependencies(M)
    if not deps:
        return sdp, lambda x, y: (x, y)

    # global row indexing -> (cluster, row)
    row_of = []
    for j, cl in enumerate(sdp.clusters):
        for p in range(cl.nrows):
            row_of.append((j, p))

    # exact B and c rows
    N = sdp.nfree
    Bex = {}
    cex = {}

    def _B_row(g):
        j, p = row_of[g]
        cl = sdp.clusters[j]
        return [_frac(cl.B[0][p, k], cl.B[1][p, k]) for k in range(N)], \
            _frac(cl.c[0][p], cl.c[1][p])

    # induced relations among free variables: for each dependent row d,
    # (B_d - sum alpha B_k) y = c_d - sum alpha c_k
    relations = []
    rel_rhs = []
    for d, expansion in zip(deps, dep_in_orig):
        Bd, cd = _B_row(d)
        for o, alpha in expansion.items():
            Bo, co = _B_row(o)
            for k in range(N):
                Bd[k] -= alpha * Bo[k]
            cd -= alpha * co
        relations.append(Bd)
        rel_rhs.append(cd)

    # RREF of the relations to express pivot variables in terms of the rest
    pivot_var = {}
    red_rows = []
    for row, rhs in zip(relations, rel_rhs):
        r = list(row)
        rr = rhs
        for pc, (prow, prhs) in pivot_var.items():
            if r[pc] != 0:
                f = r[pc]
                for k in range(N):
                    r[k] -= f * prow[k]
                rr -= f * prhs
        pc = next((k for k in range(N) if r[k] != 0), None)
        if pc is None:
            if rr != 0:
                raise PreprocessError(
                    "Linear dependent constraint(s) resulting in a constraint "
                    "0 = b_i with b_i nonzero.")
            continue
        inv = 1 / r[pc]
        r = [v * inv for v in r]
        rr = rr * inv
        # eliminate pc from existing pivots
        for pc2 in list(pivot_var):
            prow, prhs = pivot_var[pc2]
            if prow[pc] != 0:
                f = prow[pc]
                prow = [a - f * b for a, b in zip(prow, r)]
                prhs = prhs - f * rr
                pivot_var[pc2] = (prow, prhs)
        pivot_var[pc] = (r, rr)
        red_rows.append(pc)

    nf_vars = sorted(pivot_var.keys())      # dependent (removed) variables
    ff_vars = [k for k in range(N) if k not in pivot_var]

    n_removed_rows = len(deps)
    if verbose or True:
        warnings.warn(f"{n_removed_rows} constraint(s) removed due to linear "
                      "dependencies."
                      + (f" {len(nf_vars)} free variable(s) removed due to "
                         f"linear relations." if nf_vars else ""))

    # ---- rewrite the SDP ---------------------------------------------------
    # y_pc = rhs_pc - sum_{k in ff} coeff_k y_k  for pc in nf_vars
    # substitution matrix: y = subst @ y_ff + shift
    subst = [[Fraction(0)] * len(ff_vars) for _ in range(N)]
    shift = [Fraction(0)] * N
    for col, k in enumerate(ff_vars):
        subst[k][col] = Fraction(1)
    for pc, (prow, prhs) in pivot_var.items():
        shift[pc] = prhs
        for col, k in enumerate(ff_vars):
            subst[pc][col] = -prow[k]

    dep_set = set(deps)

    g = 0
    removed_rows_per_cluster = []
    exact_B_rows = []   # per cluster: list of (kept_row_exact_B, exact_c)
    for j, cl in enumerate(sdp.clusters):
        keep = [p for p in range(cl.nrows) if (g + p) not in dep_set]
        removed = [p for p in range(cl.nrows) if (g + p) in dep_set]
        removed_rows_per_cluster.append(removed)
        g += cl.nrows
        rows = []
        for p in keep:
            Brow = [_frac(cl.B[0][p, k], cl.B[1][p, k]) for k in range(N)]
            crow = _frac(cl.c[0][p], cl.c[1][p])
            crow -= sum(Brow[k] * shift[k] for k in range(N) if shift[k] != 0)
            newrow = []
            for col in range(len(ff_vars)):
                newrow.append(sum(Brow[k] * subst[k][col] for k in range(N)
                                  if subst[k][col] != 0))
            rows.append((newrow, crow))
        exact_B_rows.append((keep, rows))

    # second stage: free variables whose substituted columns are linearly
    # dependent can be set to 0 wlog (pre_postprocessing.jl:117-134)
    all_rows = [r for _, rows in exact_B_rows for (r, _) in rows]
    if all_rows and ff_vars:
        cols = [[all_rows[r][c] for r in range(len(all_rows))]
                for c in range(len(ff_vars))]
        col_deps, _ = _exact_dependencies(cols)
    else:
        col_deps = list(range(len(ff_vars))) if not all_rows else []
    fv_zero_set = set(col_deps)
    keep_cols = [c for c in range(len(ff_vars)) if c not in fv_zero_set]
    if fv_zero_set:
        warnings.warn(f"{len(fv_zero_set)} additional free variable(s) set "
                      "to zero (duplicate columns after substitution).")

    for j, cl in enumerate(sdp.clusters):
        keep, rows = exact_B_rows[j]
        newP = len(keep)
        Bh = np.zeros((newP, len(keep_cols)))
        Bl = np.zeros((newP, len(keep_cols)))
        ch = np.zeros(newP)
        clo = np.zeros(newP)
        for pi, (newrow, crow) in enumerate(rows):
            for ci, col in enumerate(keep_cols):
                Bh[pi, ci], Bl[pi, ci] = _dd_pair(newrow[col])
            ch[pi], clo[pi] = _dd_pair(crow)
        cl.B = (Bh, Bl)
        cl.c = (ch, clo)
        cl.nrows = newP
        removed = removed_rows_per_cluster[j]
        if removed:
            for bd in cl.blocks:
                if bd.kind == "dense":
                    bd.A = tuple(a[keep] for a in bd.A)
                else:
                    bd.lam = tuple(a[keep] for a in bd.lam)
                    bd.li = bd.li[keep]
                    bd.ri = bd.ri[keep]
                    bd.tmask = bd.tmask[keep]
            if cl.scalars is not None:
                cl.scalars.a = tuple(a[:, keep] for a in cl.scalars.a)

    # new b and constant: b_new = subst^T b ; constant += b . shift
    from ..utils.hp import DDScalar

    bfr = [_frac(sdp.b[0][k], sdp.b[1][k]) for k in range(N)]
    const_shift = sum(bfr[k] * shift[k] for k in range(N) if shift[k] != 0)
    if const_shift:
        sdp.constant = sdp.constant + DDScalar(Fraction(const_shift))
    bh = np.zeros(len(keep_cols))
    bl = np.zeros(len(keep_cols))
    for ci, col in enumerate(keep_cols):
        v = sum(bfr[k] * subst[k][col] for k in range(N) if subst[k][col] != 0)
        bh[ci], bl[ci] = _dd_pair(v)
    sdp.b = (bh, bl)
    old_free_names = sdp.free_names
    # solver-facing reduced names; extraction keeps the original free_names
    sdp.free_names_reduced = [old_free_names[ff_vars[c]] for c in keep_cols]

    # order_c rewrite: (ci,si) -> new (j, row); removed rows map to None
    new_order = {}
    for (ci, si), (j, p) in sdp.order_c.items():
        removed = removed_rows_per_cluster[j]
        if p in removed:
            new_order[(ci, si)] = (j, None)
        else:
            new_order[(ci, si)] = (j, p - sum(1 for q in removed if q < p))
    old_order = dict(sdp.order_c)
    sdp.order_c = {k: v for k, v in new_order.items() if v[1] is not None}

    subst_np = subst
    shift_np = shift
    nf_info = (ff_vars, nf_vars, pivot_var, N, old_free_names)

    def post(x, y):
        """x: list per cluster of (hi, lo); y: (hi, lo) for ff vars."""
        # re-insert zeros for removed constraint rows
        x_out = []
        for j, removed in enumerate(removed_rows_per_cluster):
            hi, lo = x[j]
            oldP = len(hi) + len(removed)
            nh = np.zeros(oldP)
            nl = np.zeros(oldP)
            ki = 0
            rs = set(removed)
            for p in range(oldP):
                if p in rs:
                    continue
                nh[p] = hi[ki]
                nl[p] = lo[ki]
                ki += 1
            x_out.append((nh, nl))
        # recompute dependent free variables
        yh, yl = y
        yfr = [Fraction(float(yh[c])) + Fraction(float(yl[c]))
               for c in range(len(keep_cols))]
        full = [Fraction(0)] * N
        for ci, col in enumerate(keep_cols):
            full[ff_vars[col]] = yfr[ci]
        for pc, (prow, prhs) in pivot_var.items():
            full[pc] = prhs - sum(prow[k] * full[k] for k in ff_vars
                                  if prow[k] != 0)
        nh = np.zeros(N)
        nl = np.zeros(N)
        for k in range(N):
            nh[k], nl[k] = _dd_pair(full[k])
        return x_out, (nh, nl)

    # restore order_c after extraction needs original mapping
    sdp._original_order_c = old_order
    return sdp, post
