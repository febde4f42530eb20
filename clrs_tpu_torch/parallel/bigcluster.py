"""Distributed Schur complement + Cholesky for ONE large cluster (port of
``clrs_tpu/parallel/bigcluster.py``).

The reference's scale story for a big cluster is threaded Arb GEMM /
Cholesky over the whole S^j (ClusteredLowRankSolver.jl src/solver.jl:
1244-1252, src/tools.jl:175-266). Here the same work distributes over the
ranks of a mesh by ROW PANELS, SPMD, one process per rank:

- Schur assembly: each rank builds its row panel S_loc [Pl, P] from the
  row slices of the (lam-weighted) term tables: the pair formulation
  G = U_left M U_right^T needs only LOCAL LEFT rows; the right operands
  (U^T, M) are replicated;
- chol(S): blocked right-looking; per block column the [P, nb] column
  strip is all-gathered, the nb x nb diagonal factor and the panel solve
  run replicated, and the O(P^3) trailing update runs on each rank's own
  rows, so the GEMM work and the S / chol(S) memory divide by the mesh;
- L X = B / L^T X = B: by block column over the same all-gathered strips,
  replicated (m, the KKT right-hand-side count, is small); L stays
  distributed.

Everything operates on nw-word tuples of either substrate (the ops of
:mod:`clrs_tpu_torch.dd.arith` dispatch on the word dtype), so on f32
words the factorizations and GEMMs are the hand-written kernels'
(``chol_batched``, ``tri_solve_batched``, the limb GEMM). Movement
between ranks is the all-gather of raw words (exact, :mod:`.comm`), and
the word arithmetic stays on each rank: the results equal the
one-process blocked factorization's up to its per-GEMM roundings.
"""

from __future__ import annotations

import torch

from ..dd import linalg as dl
from ..dd.arith import dd_mul, dd_sub

__all__ = ["dist_pairs_schur", "dist_scalar_schur_rows", "dist_cholesky",
           "dist_solve_tril", "dist_solve_tril_t", "row_shard_ok", "row_nb"]


def row_shard_ok(P, n_devices, nb=64):
    """The row-panel path needs P divisible by the mesh with at least 8 rows
    a rank (clrs_tpu/parallel/bigcluster.py:57-63)."""
    if P % n_devices:
        return False
    return P // n_devices >= 8


def row_nb(P, n_devices, nb=64):
    """The block column width: min(64, P / D) (clrs_tpu/solver/step.py:
    806-810)."""
    return min(nb, P // n_devices)


def _cols(x, k0, k1):
    return tuple(c[:, k0:k1].contiguous() for c in x)


def _cat2(a, b):
    return tuple(torch.cat([x, y], 0) for x, y in zip(a, b))


def dist_pairs_schur(k, Ulw_loc, Ur_loc, Xinv, Y, comm):
    """Local Schur row panel of one low-rank class (the pair formulation
    of the step's ``_schur_cluster``, rows only).

    Ulw_loc/Ur_loc: the rank's row slices [Lc, PTl, n] of the lam-weighted
    and plain term tables; Xinv/Y replicated [Lc, n, n]. Returns
    (S_loc [Pl, P], diag(GY) at the rank's rows [Lc, PTl]); the latter
    feeds trace_A(Y)."""
    Lc, PTl = Ulw_loc[0].shape[:2]
    _, P, T = k.li.shape
    Pl = PTl // T
    # GXw_loc = (lam Ul)_loc X^-1 (lam Ur)^T ; GYT_loc = Ur_loc Y Ul^T
    M2 = _cat2(Xinv, Y)
    L2 = _cat2(Ulw_loc, Ur_loc)
    R2 = _cat2(dl.dd_transpose(k.Urw), dl.dd_transpose(k.Ul))
    G2 = dl.bmm(dl.bmm(L2, M2), R2)                 # [2Lc, PTl, PT]
    gx5 = tuple(c[:Lc].reshape(Lc, Pl, T, P, T) for c in G2)
    gy5 = tuple(c[Lc:].reshape(Lc, Pl, T, P, T) for c in G2)
    inner = dl.dd_sum_prod(tuple(c.movedim(2, 3) for c in gx5),
                           tuple(c.movedim(2, 3) for c in gy5), (3, 4))
    S_loc = dl.dd_sum(inner, axis=0)                      # [Pl, P]
    idx = torch.arange(PTl, device=G2[0].device)
    col0 = comm.rank * PTl
    dgy = tuple(c[Lc:][:, idx, col0 + idx] for c in G2)   # [Lc, PTl]
    return S_loc, dgy


def dist_scalar_schur_rows(sa, w, comm, Pl):
    """Scalar-pack Schur rows: S_loc += (sa^T)[rows] diag(w) sa.
    sa replicated [Bs, P]; w [Bs]."""
    sa_cols = tuple(c.narrow(1, comm.rank * Pl, Pl) for c in sa)   # [Bs, Pl]
    t = dd_mul(sa, tuple(c[:, None] for c in w))                  # [Bs, P]
    return dl.dd_matmul(tuple(c.t().contiguous() for c in sa_cols), t)


def dist_cholesky(S_loc, P, comm, nb):
    """Distributed blocked right-looking Cholesky of a row-sharded SPD
    matrix. S_loc: nw-word [Pl, P]. Returns (L_loc [Pl, P], ok)."""
    Pl = S_loc[0].shape[0]
    dt, dev = S_loc[0].dtype, S_loc[0].device
    grow = comm.rank * Pl + torch.arange(Pl, device=dev)  # global rows
    A = [c.clone() for c in S_loc]
    L_loc = [torch.zeros((Pl, P), dtype=dt, device=dev) for _ in S_loc]
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for k0 in range(0, P, nb):
        k1 = min(k0 + nb, P)
        nbk = k1 - k0
        strip = comm.all_gather(_cols(A, k0, k1), 0)           # [P, nbk]
        # mirror the upper triangle of the diagonal block onto its lower
        # one (the one-process step mirrors all of S the same way); the
        # factorization reads only the lower panel and the diagonal blocks
        iu = torch.triu(torch.ones((nbk, nbk), dtype=torch.bool,
                                   device=dev))
        diag = tuple(torch.where(iu, c[k0:k1], c[k0:k1].t()) for c in strip)
        Lkk, okb = dl.s_cholesky(diag)
        ok = ok & okb
        zeros = torch.zeros((k0, nbk), dtype=dt, device=dev)
        if k1 < P:
            below = tuple(c[k1:] for c in strip)               # [P-k1, nbk]
            Pt = dl.s_solve_tril(Lkk, dl.dd_transpose(below))
            panel = tuple(c.t().contiguous() for c in Pt)      # [P-k1, nbk]
            fullcol = tuple(torch.cat([zeros, lk, pc], 0)
                            for lk, pc in zip(Lkk, panel))     # [P, nbk]
        else:
            fullcol = tuple(torch.cat([zeros, lk], 0) for lk in Lkk)
        loccol = comm.local_rows(fullcol, 0)                   # [Pl, nbk]
        for c, lc in zip(L_loc, loccol):
            c[:, k0:k1] = lc
        if k1 < P:
            # trailing update of the rank's rows >= k1
            mask = (grow >= k1).to(dt)[:, None]
            ploc = tuple((c * mask).contiguous() for c in loccol)
            upd = dl.dd_matmul(ploc, Pt)                       # [Pl, P-k1]
            A22 = dd_sub(tuple(c[:, k1:] for c in A), upd)
            for c, uc in zip(A, A22):
                c[:, k1:] = uc
    return tuple(L_loc), ok


def dist_solve_tril(L_loc, B, P, comm, nb):
    """L X = B with L row-sharded [Pl, P] and B replicated [P, m]; returns
    X replicated (right-looking over all-gathered column strips)."""
    X = [torch.zeros_like(c) for c in B]
    B = [c.clone() for c in B]
    for k0 in range(0, P, nb):
        k1 = min(k0 + nb, P)
        strip = comm.all_gather(_cols(L_loc, k0, k1), 0)       # [P, nbk]
        xk = dl.s_solve_tril(tuple(c[k0:k1] for c in strip),
                             tuple(c[k0:k1] for c in B))
        for c, xc in zip(X, xk):
            c[k0:k1] = xc
        if k1 < P:
            upd = dl.dd_matmul(tuple(c[k1:] for c in strip), xk)  # [P-k1, m]
            Bt = dd_sub(tuple(c[k1:] for c in B), upd)
            for c, bc in zip(B, Bt):
                c[k1:] = bc
    return tuple(X)


def dist_solve_tril_t(L_loc, B, P, comm, nb):
    """L^T X = B with L row-sharded and B replicated [P, m]; returns X
    replicated (left-looking, descending block columns)."""
    X = [torch.zeros_like(c) for c in B]
    blocks = [(k0, min(k0 + nb, P)) for k0 in range(0, P, nb)]
    for k0, k1 in reversed(blocks):
        strip = comm.all_gather(_cols(L_loc, k0, k1), 0)       # [P, nbk]
        rhs = tuple(c[k0:k1] for c in B)
        if k1 < P:
            below_t = tuple(c[k1:].t().contiguous() for c in strip)
            upd = dl.dd_matmul(below_t, tuple(c[k1:] for c in X))  # [nbk, m]
            rhs = dd_sub(rhs, upd)
        xk = dl.s_solve_tril_t(tuple(c[k0:k1] for c in strip), rhs)
        for c, xc in zip(X, xk):
            c[k0:k1] = xc
    return tuple(X)
