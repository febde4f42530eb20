"""The two launches of csrc/eig.cu's eigenpairs on the CPU: the sweeps on
A, which form each round's rotations one round ahead and log them, then
the replay of the log on V = I (``eig_pairs_vec_plain``, op for op the
kernel ``eig_pairs_vec``).

- The table of round r + 1's pairs in round r's blocks
  (``jacobi_next_block``, the kernel's ``next_block``) against the
  round-robin pairs (``jacobi_pairs``) at every even N from 2 to 200.
- How the sweep kernel's threads share a round: every rotation formed and
  logged once, every block rotated once, for P on both sides of 256 and
  past 512.
- A plain emulation of the sweep kernel's order (a rotation formed from
  the entry of the block that the thread of pair k rotated in the round
  before and the diagonals stored beside that round's rotations; every
  rotation logged, identities included), then the replay: equal to
  ``eig_pairs_plain`` bit for bit, eigenvalues and eigenvectors, at n 1,
  2, 7, 11, 33 and 96 on random, diagonal, repeated-eigenvalue and zero
  members; the certified bound from its pairs within 1e-4 (1 + |lambda|)
  of the JAX package's ``_eig_lo_verified`` on the same words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clrs_tpu.solver import step as JS
from clrs_tpu_torch.dd import kernels as K
from clrs_tpu_torch.solver import step as TS
from test_torch_eig import KINDS, NS, _matrices
from torch_helpers import split_words


def _positions(N, r):
    """Slot i's position in round r of the round-robin order."""
    return [0] + [(i - 1 + r) % (N - 1) + 1 for i in range(1, N)]


@pytest.mark.parametrize("N", range(2, 201, 2))
def test_next_round_pairs_lie_in_one_block(N):
    """Round r + 1's pair k has one position in each pair of round r's
    block jacobi_next_block(P, k) (both in pair 0 when P = 1), in every
    round and across a sweep's end; the blocks are the kernel's: distinct
    for P >= 3, (1, 0) for both pairs at P = 2."""
    P = N // 2
    rounds = [list(zip(p.tolist(), q.tolist())) for p, q in K.jacobi_pairs(N)]
    blocks = [K.jacobi_next_block(P, k) for k in range(P)]
    for r in range(N - 1):
        rn = (r + 1) % (N - 1)
        pos = _positions(N, rn)
        for k, (ia, ib) in enumerate(blocks):
            x, y = pos[k], pos[N - 1 - k]
            assert (min(x, y), max(x, y)) == rounds[rn][k]
            rows, cols = set(rounds[r][ia]), set(rounds[r][ib])
            if P == 1:
                assert {x, y} == rows == cols
            else:
                assert ia > ib
                assert (x in rows and y in cols) or (y in rows and x in cols)
    if P >= 3:
        assert len(set(blocks)) == P
        assert set(blocks) == {(ia, ib) for ia in range(P) for ib in range(ia)
                               if ia - ib == 2 or (ia, ib) in ((1, 0),
                                                               (P - 1, P - 2))}
    elif P == 2:
        assert blocks == [(1, 0), (1, 0)]


def _sweep_thread_work(P, T=K.EIG_PAIRS_THREADS // 2):
    """What each of the sweep kernel's T threads takes in a round, as
    csrc/eig.cu assigns it: (the rotations it forms, the blocks it
    rotates, the rotations it logs), by thread. Thread k takes the block
    of the next rotation k, and of k + T; the other blocks go in triangle
    order to the threads from P up while P <= T / 2, else to every
    thread."""
    nblk = P * (P + 1) // 2
    wide = P > T // 2
    stride = T if wide else T - P
    nxt = {K.jacobi_next_block(P, k) for k in range(P)}
    tri = [(ia, ib) for ia in range(P) for ib in range(ia + 1)]
    work = []
    for t in range(T):
        forms = []
        if t < P and not (P == 2 and t == 1):
            forms.append(list(range(t, (1 if P == 2 else t) + 1)))
        if t + T < P:
            forms.append([t + T])
        blocks = [K.jacobi_next_block(P, f[0]) for f in forms]
        if wide or t >= P:
            blocks += [tri[u] for u in range(t if wide else t - P, nblk, stride)
                       if tri[u] not in nxt]
        logs = list(range(T - 1 - t, P, T)) if T - 1 - t >= 0 else []
        work.append(([k for f in forms for k in f], blocks, logs))
    return work


@pytest.mark.parametrize("P", [1, 2, 3, 48, 256, 257, 511, 512, 513, 515,
                               1024])
def test_sweep_threads_take_every_block_once(P):
    """Across the sweep kernel's threads every rotation of a round is
    formed once and logged once, and every block of the triangle is
    rotated once, on both sides of P = 256 (other blocks on the threads
    from P up, or on every thread) and past P = 512 (a thread forms two
    rotations)."""
    work = _sweep_thread_work(P)
    forms = sorted(k for f, _, _ in work for k in f)
    logs = sorted(k for _, _, g in work for k in g)
    blocks = [b for _, bl, _ in work for b in bl]
    assert forms == list(range(P)) and logs == list(range(P))
    assert len(blocks) == len(set(blocks)) == P * (P + 1) // 2


def _lookahead_tables(N):
    """Per round r: (ia, ib, which entry of the block (0..3 for z11, z12,
    z21, z22), p', q') of round r + 1's pairs, found as the kernel finds
    them: the row from pair ia, the column from pair ib."""
    P = N // 2
    rounds = [list(zip(p.tolist(), q.tolist())) for p, q in K.jacobi_pairs(N)]
    out = []
    for r in range(N - 1):
        pos = _positions(N, (r + 1) % (N - 1))
        rows = []
        for k in range(P):
            ia, ib = K.jacobi_next_block(P, k)
            (pa, qa), (pb, qb) = rounds[r][ia], rounds[r][ib]
            x, y = pos[k], pos[N - 1 - k]
            xa = x in (pa, qa)
            rw, cl = (x, y) if xa else (y, x)
            sel = 2 * (rw != pa) + (cl != pb)
            rows.append((ia, ib, sel, min(x, y), max(x, y)))
        out.append(tuple(torch.tensor(c) for c in zip(*rows)))
    return out


def _emulated_sweeps(A):
    """csrc/eig.cu's sweep kernel on float32 members A [B, n, n] in its
    order: (sorted eigenvalues, rotation logs [B, meta + 1 + n] laid out as
    eig_pairs_log_layout says)."""
    B, n = A.shape[0], A.shape[-1]
    N = n + (n & 1)
    P = N // 2
    f64, f32 = torch.float64, torch.float32
    As = torch.zeros((B, N, N), dtype=f32)
    As[:, :n, :n] = A

    def sq(x):
        x = x.to(f64)
        return x * x

    def form(app, aqq, apq):
        c, s, t = K._rotation(app, aqq, apq)
        return c, s, (app - t * apq).to(f32), (aqq + t * apq).to(f32)

    fro2 = K.strided_sum(sq(As).reshape(B, -1), K.EIG_PAIRS_THREADS)
    offdiag = ~torch.eye(N, dtype=torch.bool)
    lower = torch.arange(P)[:, None] > torch.arange(P)
    kk = torch.arange(P)
    rounds = K.jacobi_pairs(N)
    ahead = _lookahead_tables(N)
    G, _, meta = K.eig_pairs_log_layout(n)
    log = torch.zeros((B, meta + 1 + n), dtype=f64)
    rot = log[:, :meta].view(B, G, P, 2)

    p, q = rounds[0]
    Ad = As.to(f64)
    c, s, dp, dq = form(Ad[:, p, p], Ad[:, q, q], Ad[:, p, q])
    dn = torch.zeros((B, N), dtype=f32)
    dn[:, p], dn[:, q] = dp, dq
    sweeps = torch.zeros(B, dtype=torch.int64)
    active = torch.ones(B, dtype=torch.bool)
    g = 0
    for _ in range(K.EIG_PAIRS_MAX_SWEEPS):
        off2 = K.strided_sum(torch.where(offdiag, sq(As), 0.0).reshape(B, -1),
                             K.EIG_PAIRS_THREADS)
        active = active & ~(off2 <= 2.0 ** -48 * fro2)
        if not bool(active.any()):
            break
        sweeps += active.to(torch.int64)
        for r, (p, q) in enumerate(rounds):
            rot[:, g, :, 0], rot[:, g, :, 1] = c, s
            Ad = As.to(f64)
            pc, pr, qc, qr = p[:, None], p[None, :], q[:, None], q[None, :]
            X11, X12, X21, X22 = (Ad[:, pc, pr], Ad[:, pc, qr],
                                  Ad[:, qc, pr], Ad[:, qc, qr])
            ca, sa = c[:, :, None], s[:, :, None]
            cb, sb = c[:, None, :], s[:, None, :]
            Y11, Y12 = ca * X11 - sa * X21, ca * X12 - sa * X22
            Y21, Y22 = sa * X11 + ca * X21, sa * X12 + ca * X22
            Z = torch.stack([cb * Y11 - sb * Y12, sb * Y11 + cb * Y12,
                             cb * Y21 - sb * Y22, sb * Y21 + cb * Y22],
                            1).to(f32)
            N11 = torch.where(lower, Z[:, 0], Z[:, 0].mT)
            N12 = torch.where(lower, Z[:, 1], Z[:, 2].mT)
            N21 = torch.where(lower, Z[:, 2], Z[:, 1].mT)
            N22 = torch.where(lower, Z[:, 3], Z[:, 3].mT)
            N11[:, kk, kk] = dn[:, p]
            N22[:, kk, kk] = dn[:, q]
            N12[:, kk, kk] = 0.0
            N21[:, kk, kk] = 0.0
            new = As.clone()
            new[:, pc, pr], new[:, pc, qr] = N11, N12
            new[:, qc, pr], new[:, qc, qr] = N21, N22
            # round r + 1's rotations from this round's block entries
            ia, ib, sel, pn, qn = ahead[r]
            apq = Z[:, sel, ia, ib].to(f64)
            if P == 1:
                apq = torch.zeros_like(apq)
            c, s, dp, dq = form(dn[:, pn].to(f64), dn[:, qn].to(f64), apq)
            dn = torch.zeros_like(dn)
            dn[:, pn], dn[:, qn] = dp, dq
            As = torch.where(active[:, None, None], new, As)
            g += 1
    lam = torch.diagonal(As, dim1=1, dim2=2)[:, :n]
    order = torch.sort(lam, dim=1, stable=True).indices
    log[:, meta] = sweeps.to(f64)
    log[:, meta + 1:] = torch.argsort(order, dim=1).to(f64)
    return torch.gather(lam, 1, order), log


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", NS)
def test_two_launch_scheme_equals_plain(n, kind):
    a = torch.from_numpy(_matrices(n, kind).astype(np.float32))
    lam_ref, vec_ref = K.eig_pairs_plain(a)
    lam, log = _emulated_sweeps(a)
    K.reset_counts()
    vec = K.eig_pairs_vec(log, n)
    assert K.counts()["eig_pairs_vec_plain"] == 1
    assert torch.equal(_bits(lam), _bits(lam_ref))
    assert torch.equal(_bits(vec), _bits(vec_ref))
    G, P, meta = K.eig_pairs_log_layout(n)
    assert int(log[:, meta].max()) <= K.EIG_PAIRS_MAX_SWEEPS
    if kind in ("diagonal", "zero") or n == 1:
        assert bool((log[:, meta] == 0).all())


@pytest.mark.parametrize("n", NS)
def test_certified_bound_from_replayed_pairs(n, monkeypatch):
    """The certified route's bound from the two-launch pairs: a lower bound
    of the float64 lambda_min, within the JAX test's 1e-4 of the JAX
    package's certified bound on the same f32 words."""
    monkeypatch.setattr(JS, "_STEPLEN_VERIFIED", True)
    a = _matrices(n, "random", seed=2)
    ws = split_words(a, 5)
    W2 = tuple(torch.from_numpy(np.ascontiguousarray(w)) for w in ws)
    A32, _ = TS._eig_input_f32(W2)
    lam, log = _emulated_sweeps(A32)
    ours = TS._eig_lo_certified(W2, lam, K.eig_pairs_vec(log, n)).numpy()
    words64 = sum(w.astype(np.float64) for w in ws)
    true = np.linalg.eigvalsh(
        0.5 * (words64 + np.swapaxes(words64, 1, 2)))[:, 0]
    scale = 1.0 + np.abs(true)
    assert np.all(ours <= true + 1e-12 * scale), (ours - true)
    jax_lo = np.asarray(jax.jit(JS._eig_lo_verified)(
        tuple(jnp.asarray(w) for w in ws)))
    assert np.all(np.abs(ours - jax_lo) <= 1e-4 * scale), (ours - jax_lo)
