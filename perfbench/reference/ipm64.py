"""The control: a plain primal-dual interior-point solver in float64
(NumPy), put in the port's place. The configurations state about 106
bits (five f32 words); float64, the nearest precision below, cannot meet
their gap thresholds, so the checks have to find its answers not correct.

Dense data: rows p = 1..m, each with a constant c_p, a free-variable row
B_p and a matrix A_jp for each block j; the objective C_j, b, constant and
sign (+1 maximize, -1 minimize), the upstream solver's conventions
(``perfbench/reference/common.py``). Internally it minimizes
<-sign C, Y> - sign b y with dual multipliers z = -x and slack S = X, and
takes HKM directions with Mehrotra's predictor-corrector from Y = omega_p
I, S = omega_d I.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction

import numpy as np


@dataclass
class Dense:
    keys: list            # block names
    A: list               # per block: [m, n, n] float64
    B: np.ndarray         # [m, f]
    c: np.ndarray         # [m]
    C: list               # per block: [n, n]
    b: np.ndarray         # [f]
    free: list            # free-variable names
    sign: float
    rows: list            # rows per constraint, in order


def _chol(M):
    try:
        return np.linalg.cholesky(M)
    except np.linalg.LinAlgError:
        return None


def _max_step(L, D):
    """The largest alpha with L L^T + alpha D PSD (inf if any)."""
    Li = np.linalg.inv(L)
    lam = np.linalg.eigvalsh(Li @ D @ Li.T)
    return np.inf if lam[0] >= 0 else -1.0 / lam[0]


def solve(data: Dense, omega_p=1e2, omega_d=1e2, maxiter=200, tau=0.9,
          gap_threshold=0.0, error_threshold=0.0):
    """Iterate until the relative gap falls below ``gap_threshold`` with
    every residual below ``error_threshold`` (the solve settings'
    termination), or no step can be taken, or ``maxiter``; returns the
    last iterate as an answer (:func:`answer`)."""
    A, Cm = data.A, [-data.sign * C for C in data.C]
    bm = -data.sign * data.b
    m, f = data.B.shape
    N = sum(a.shape[1] for a in A)
    Y = [omega_p * np.eye(a.shape[1]) for a in A]
    S = [omega_d * np.eye(a.shape[1]) for a in A]
    y, z = np.zeros(f), np.zeros(m)
    for _ in range(maxiter):
        rp = data.c - sum(np.einsum("pab,ab->p", a, Yj)
                          for a, Yj in zip(A, Y)) - data.B @ y
        Rd = [Cj - np.einsum("p,pab->ab", z, a) - Sj
              for Cj, a, Sj in zip(Cm, A, S)]
        rf = bm - data.B.T @ z
        mu = sum(np.vdot(Yj, Sj) for Yj, Sj in zip(Y, S)) / N
        p_obj = sum(np.vdot(Cj, Yj) for Cj, Yj in zip(Cm, Y)) + bm @ y
        d_obj = data.c @ z
        err = max([np.abs(rp).max(initial=0), np.abs(rf).max(initial=0)]
                  + [np.abs(R).max() for R in Rd])
        if (abs(p_obj - d_obj) / max(1.0, abs(p_obj + d_obj))
                < gap_threshold and err < error_threshold):
            break
        Sinv = [np.linalg.inv(Sj) for Sj in S]
        T = [Yj @ a @ Si for Yj, a, Si in zip(Y, A, Sinv)]
        M = sum(np.einsum("pab,qba->pq", a, t) for a, t in zip(A, T))
        K = np.block([[M, data.B], [data.B.T, np.zeros((f, f))]])

        def direction(sigma, corr):
            G = [sigma * mu * Si - Yj - Yj @ R @ Si - cj
                 for Si, Yj, R, cj in zip(Sinv, Y, Rd, corr)]
            rhs = rp - sum(np.einsum("pab,ab->p", a, g)
                           for a, g in zip(A, G))
            try:
                sol = np.linalg.solve(K, np.concatenate([rhs, rf]))
            except np.linalg.LinAlgError:
                return None
            dz, dy = sol[:m], sol[m:]
            dS = [R - np.einsum("p,pab->ab", dz, a) for R, a in zip(Rd, A)]
            dY = [g + Yj @ (R - ds) @ Si
                  for g, Yj, R, ds, Si in zip(G, Y, Rd, dS, Sinv)]
            dY = [(d + d.T) / 2 for d in dY]
            return dY, dy, dz, dS

        def steps(dY, dS):
            LY = [_chol(Yj) for Yj in Y]
            LS = [_chol(Sj) for Sj in S]
            if any(L is None for L in LY + LS):
                return None
            ap = min([1.0] + [tau * _max_step(L, d) for L, d in zip(LY, dY)])
            ad = min([1.0] + [tau * _max_step(L, d) for L, d in zip(LS, dS)])
            return ap, ad

        zero = [np.zeros_like(Yj) for Yj in Y]
        aff = direction(0.0, zero)
        if aff is None or steps(aff[0], aff[3]) is None:
            break
        ap, ad = steps(aff[0], aff[3])
        mu_aff = sum(np.vdot(Yj + ap * dY, Sj + ad * dS)
                     for Yj, dY, Sj, dS in zip(Y, aff[0], S, aff[3])) / N
        sigma = min(1.0, (mu_aff / mu) ** 3)
        corr = [dY @ dS @ Si for dY, dS, Si in zip(aff[0], aff[3], Sinv)]
        full = direction(sigma, corr)
        if full is None:
            break
        st = steps(full[0], full[3])
        if st is None or min(st) < 1e-12:
            break
        ap, ad = st
        dY, dy, dz, dS = full
        Y = [Yj + ap * d for Yj, d in zip(Y, dY)]
        S = [Sj + ad * d for Sj, d in zip(S, dS)]
        y, z = y + ap * dy, z + ad * dz
    return answer(data, Y, y, -z, S)


def _rows(a):
    return [[Fraction(float(v)) for v in r] for r in a]


def answer(data, Y, y, x, X):
    """An answer in the form the checks read (exact rationals of the
    float64 values)."""
    xs, at = [], 0
    for k in data.rows:
        xs.append([Fraction(float(v)) for v in x[at:at + k]])
        at += k
    return {"x": xs,
            "X": {k: _rows(v) for k, v in zip(data.keys, X)},
            "Y": {k: _rows(v) for k, v in zip(data.keys, Y)},
            "y": {k: Fraction(float(v)) for k, v in zip(data.free, y)}}
