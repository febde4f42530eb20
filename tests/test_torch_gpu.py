"""Tests of the port that need a CUDA card; they skip without one.

This file imports nothing of JAX, so it also runs where JAX is not
installed. On a machine with a card, from the repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest`` skips tests/conftest.py, which sets JAX up for the other
test files.) ``chip_smoke.py`` runs the same kernel comparisons at the
solver's shapes.
"""

import numpy as np
import pytest
import torch

import clrs_tpu_torch as ct
from clrs_tpu_torch import device as D
from clrs_tpu_torch.dd import kernels as K
from clrs_tpu_torch.solver import graph as G
from clrs_tpu_torch.solver import step as TS
from torch_helpers import delsarte, poison_x, spd_words, split_words

STEP_KW = dict(gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
               dual_error_threshold=1e-12, primal_error_threshold=1e-12)


def _t(ws, dev):
    return tuple(torch.from_numpy(w).to(dev) for w in ws)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_cuda_request_without_card_raises(monkeypatch):
    """device="cuda" without a card raises; nothing drifts to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        D.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        ct.solvesdp(None, device="cuda", verbose=False)
    with pytest.raises(RuntimeError):
        ct.solvesdp(None, verbose=False)                # the default: cuda
    with pytest.raises(RuntimeError):
        TS.DeviceSDP(None)
    assert D.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("nw", [5, 6, 7, 8])
def test_kernels_match_plain_on_card(nw, cuda):
    """Every kernel equals its plain version bit for bit on the card, at
    each word count of the f32 ladder."""
    A = _t(spd_words(3, 9, nw, 7), cuda)
    Lk, okk = K.chol_batched(A)
    Lp, okp = K.chol_plain(A)
    assert torch.equal(okk, okp)
    assert all(torch.equal(a, b) for a, b in zip(Lk, Lp))
    Bm = _t(split_words(np.random.default_rng(8).standard_normal((3, 9, 4)),
                        nw), cuda)
    for trans in (False, True):
        xk = K.tri_solve_batched(Lp, Bm, trans)
        xp = K.tri_solve_plain(Lp, Bm, trans)
        assert all(torch.equal(a, b) for a, b in zip(xk, xp))
    L, _ = K.limb_params(nw)
    for side in ("a", "b"):
        lk, ek = K.limb_extract(Bm, L, side)
        lp, ep = K.limb_extract_plain(Bm, L, side)
        assert torch.equal(lk, lp) and torch.equal(ek, ep)
    A3, ea = K.limb_extract_plain(Bm, L, "a")
    B3, eb = K.limb_extract_plain(tuple(c.transpose(1, 2) for c in Bm), L,
                                  "b")
    eab = (ea + eb).expand(3, 9, 9).contiguous()
    gk = K.limb_gemm(A3, B3, eab, nw)
    gp = K.limb_gemm_plain(A3, B3, eab, nw)
    assert all(torch.equal(a, b) for a, b in zip(gk, gp))


def _same(xs, ys):
    return all(torch.equal(a, b) for a, b in zip(xs, ys))


@pytest.mark.gpu
@pytest.mark.parametrize("nw, B, n, m", [
    (5, 1, 64, 1),      # the KKT solves: one column, one block
    (5, 4, 22, 211),    # more columns than a tile holds, a ragged last tile
    (5, 3, 1, 5),       # n 1: no tree
    (8, 1, 95, 1),      # the largest unblocked size
    (8, 2, 95, 95),     # two-column tiles beside L at nw 8: ragged
    (8, 1, 120, 3),     # L's triangle exceeds shared memory: read globally
])
def test_tri_solve_shapes_match_plain_on_card(nw, B, n, m, cuda):
    """Both forms of the solve equal the plain version bit for bit at the
    column tilings and sizes the kernel treats apart, and each launch is
    counted under its form."""
    rng = np.random.default_rng(40 + n)
    L, _ = K.chol_plain(_t(spd_words(B, n, nw, 41), cuda))
    Bm = _t(split_words(rng.standard_normal((B, n, m)), nw), cuda)
    K.reset_counts()
    for trans in (False, True):
        assert _same(K.tri_solve_batched(L, Bm, trans),
                     K.tri_solve_plain(L, Bm, trans))
    c = K.counts()
    assert c["tri_solve_batched<false>"] == c["tri_solve_batched<true>"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("nw", [5, 6, 7, 8])
def test_split_route_kernels_match_plain_on_card(nw, cuda):
    """The split route's kernels (extraction in the GEMM layouts, the int8
    GEMM, the cascade from C and from diagonals) equal their plain versions
    bit for bit on the card, with ragged shapes; the split and fused routes
    of fx_matmul give the same words."""
    from clrs_tpu_torch.dd import limb_gemm as tg

    rng = np.random.default_rng(20 + nw)
    L, ndiag = K.limb_params(nw)
    B, m, k, n = 2, 13, 37, 70
    a = _t(split_words(rng.standard_normal((B, m, k))
                       * 10.0 ** rng.integers(-6, 6, (B, m, k)), nw), cuda)
    b = _t(split_words(rng.standard_normal((B, k, n)), nw), cuda)
    for side, w in (("a", a), ("b", b)):
        lk, ek = K.limb_extract(w, L, side, layout="gemm")
        lp, ep = K.limb_extract_plain(w, L, side, layout="gemm")
        assert torch.equal(lk, lp) and torch.equal(ek, ep)
    A2, ea = K.limb_extract_plain(a, L, "a", layout="gemm")
    B2, eb = K.limb_extract_plain(b, L, "b", layout="gemm")
    C = K.int8_gemm(A2, B2)
    assert torch.equal(C, K.int8_gemm_plain(A2, B2))
    eab = (ea + eb).expand(B, m, n).contiguous()
    assert _same(K.cascade_from_c(C, eab, nw),
                 K.cascade_from_c_plain(C, eab, nw))
    diags = torch.from_numpy(rng.integers(-2 ** 24, 2 ** 24, (B, ndiag, m, n))
                             .astype(np.int32)).to(cuda)
    assert _same(K.cascade_from_diags(diags, eab, nw),
                 K.cascade_from_diags_plain(diags, eab, nw))
    assert _same(tg.fx_matmul(a, b, route="split"),
                 tg.fx_matmul(a, b, route="fused"))


def _limbs(rng, shape, extreme):
    """int8 limbs in [-65, 65], or all +-65 (the largest |C| per term)."""
    v = (rng.integers(0, 2, shape) * 130 - 65 if extreme
         else rng.integers(-65, 66, shape))
    return torch.from_numpy(v.astype(np.int8))


@pytest.mark.gpu
@pytest.mark.parametrize("B, M, k, N, extreme, offset", [
    (1, 21, 1, 22, True, False),        # one k: a chunk of 31 zeros
    (1, 40, 31, 50, True, False),
    (1, 64, 32, 64, True, False),       # one whole chunk, 16-byte A rows
    (2, 70, 33, 45, True, False),       # a second chunk of one k
    (1, 40, 8192, 36, True, False),     # the deepest exact K: 256 chunks
    (4, 462, 11, 21, False, False),     # N = L n with n = 1: narrow tiles
    (1, 462, 11, 462, False, False),    # the Schur pairing of delsarte(3,10)
    (1, 97, 20, 130, False, False),     # ragged M and N, 4-byte A rows
    (3, 100, 48, 260, False, False),    # N % 4 == 0: 4-byte B, 16-byte C
    (2, 462, 11, 21, False, True),      # views at odd byte offsets
    (1, 21, 191, 4032, False, True),
])
def test_int8_gemm_shapes_match_plain_on_card(B, M, k, N, extreme, offset,
                                              cuda):
    """The tensor-core int8 GEMM equals the exact plain product at the
    depths, widths and alignments its staging and tiles treat apart (with
    ``offset``, on batch slices whose data start at an odd byte), and each
    call is one launch."""
    rng = np.random.default_rng(M + k + N)
    a = _limbs(rng, (B + offset, M, k), extreme).to(cuda)[offset:]
    b = _limbs(rng, (B + offset, k, N), extreme).to(cuda)[offset:]
    if offset:
        assert a.data_ptr() % 4 or b.data_ptr() % 4
    K.reset_counts()
    assert torch.equal(K.int8_gemm(a, b), K.int8_gemm_plain(a, b))
    assert K.counts()["int8_gemm"] == 1


def _edge_words(nw, B, d0, d1, kind, seed):
    """nw f32 words [B, d0, d1] for the extraction's edge cases: a NaN in
    word 0 of row 1 and of column 2 ("nan"), zero rows and columns
    ("zero"), a row and a column above 2^126 ("huge"), or plain values
    (any other kind)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((B, d0, d1)) * 10.0 ** rng.integers(-4, 4,
                                                                (B, d0, d1))
    if kind == "zero":
        v[:, 0] = 0.0
        v[:, :, -1] = 0.0
    elif kind == "huge":
        v[:, -1] *= 3e38 / np.abs(v[:, -1]).max()
        v[:, :, 0] *= 1e38 / np.abs(v[:, :, 0]).max()
    ws = split_words(v, nw)
    if kind == "nan":
        ws[0] = ws[0].copy()
        ws[0][:, 1 % d0, 0] = np.nan
        ws[0][:, -1, 2 % d1] = np.nan
    return ws


@pytest.mark.gpu
@pytest.mark.parametrize("nw, B, d0, d1, kind", [
    (5, 2, 6, 9, "nan"),        # NaN in a row (side a) and a column (side b)
    (8, 3, 5, 12, "nan"),
    (5, 3, 7, 5, "zero"),       # zero rows and columns: exponent of 1
    (6, 2, 5, 12, "huge"),      # above 2^126: two power-of-two steps
    (5, 3, 4, 1, "plain"),      # k = 1
    (7, 1, 3, 8192, "plain"),   # k = 2^13 along a row: tiles share rows
    (6, 1, 8192, 5, "plain"),   # and down a column
    (5, 4, 192, 64, "plain"),   # the Schur panel of delsarte(3,95)
    (6, 2, 40, 24, "transposed"),  # strided views, read where they lie
])
def test_limb_extract_edges_match_plain_on_card(nw, B, d0, d1, kind, cuda):
    """The one-launch extraction equals its plain version bit for bit,
    limbs and exponents, on both sides and in both layouts, at the edges
    its exponent reduction and its tiles treat apart, and on transposed
    views (each word read through its strides). A NaN in word 0 gives
    its row (side a) or column (side b) e = 130 as amax does; a maximum
    that drops NaNs would scale the rest of that row by another power of
    two."""
    L, _ = K.limb_params(nw)
    if kind == "transposed":
        w = tuple(c.transpose(1, 2) for c in
                  _t(_edge_words(nw, B, d1, d0, kind, 70 + nw + d0), cuda))
    else:
        w = _t(_edge_words(nw, B, d0, d1, kind, 70 + nw + d0), cuda)
    for side in ("a", "b"):
        for layout in ("limb", "gemm"):
            K.reset_counts()
            lk, ek = K.limb_extract(w, L, side, layout)
            assert K.counts()["limb_extract"] == 1
            lp, ep = K.limb_extract_plain(w, L, side, layout)
            assert torch.equal(ek, ep) and torch.equal(lk, lp)
            if kind == "nan":
                nan_group = 1 % d0 if side == "a" else 2 % d1
                assert (ek.flatten(1)[:, nan_group] == 130).all()


@pytest.mark.gpu
@pytest.mark.parametrize("nw, B, m, k, n, extreme", [
    (5, 1, 2, 1, 3, True),          # k = 1: a chunk of 31 zeros
    (5, 1, 17, 31, 9, True),        # ragged m, n and A rows (granules)
    (6, 2, 33, 32, 17, True),       # one whole chunk, 16-byte A rows
    (7, 1, 9, 33, 1, True),         # a second chunk of one k; n = 1
    (8, 1, 5, 8192, 3, True),       # the deepest exact k: 256 chunks
    (5, 4, 40, 20, 24, False),      # B 4, 4-byte A and B units
    (8, 2, 40, 64, 48, False),      # nw 8, 16-byte units
    (5, 2, 192, 64, 192, False),    # 16x16 tiles: two warps a 16x8 tile
    (6, 4, 160, 64, 160, False),    # 16x16 tiles at nw 6
    (8, 4, 192, 37, 192, False),    # 16x16 tiles, ragged A rows, nw 8
])
def test_limb_gemm_edges_match_plain_on_card(nw, B, m, k, n, extreme, cuda):
    """The tensor-core limb GEMM equals its plain version bit for bit at the
    depths, ragged edges, batch sizes and word counts (each its own number
    of diagonal fragments) its staging and tiles treat apart; with
    ``extreme`` every limb is +-65, the largest diagonal sums. One call is
    one launch."""
    rng = np.random.default_rng(m + k + n + nw)
    L, _ = K.limb_params(nw)
    a3 = _limbs(rng, (B, L, m, k), extreme).to(cuda)
    b3 = _limbs(rng, (B, L, k, n), extreme).to(cuda)
    eab = torch.from_numpy(rng.integers(-8, 9, (B, m, n)).astype(np.int32)
                           ).to(cuda)
    K.reset_counts()
    gk = K.limb_gemm(a3, b3, eab, nw)
    assert K.counts()["limb_gemm"] == 1
    gp = K.limb_gemm_plain(a3, b3, eab, nw)
    assert all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(gk, gp))


def _indefinite_at(B, n, nw, j, seed):
    """B SPD members, the last replaced by L D L^T whose pivot j is -1 (its
    diagonal entry there starts positive): its ok flag must clear at j."""
    a = np.random.default_rng(seed).standard_normal((B, n, n))
    v = a @ a.transpose(0, 2, 1) + n * np.eye(n)
    lu = np.tril(np.random.default_rng(seed + 1).standard_normal((n, n))
                 * 0.2, -1) + np.eye(n)
    lu[j, :j] = 1.0
    d = np.ones(n)
    d[j] = -1.0
    v[-1] = lu @ np.diag(d) @ lu.T
    return split_words(v, nw)


@pytest.mark.gpu
@pytest.mark.parametrize("nw, B, n, bad", [
    (5, 3, 1, False), (5, 2, 2, False), (5, 1, 63, False), (5, 2, 64, True),
    (5, 1, 65, False), (5, 2, 95, True),
    (8, 2, 1, True), (8, 1, 2, False), (8, 2, 63, True), (8, 1, 64, False),
    (8, 1, 65, False), (8, 2, 95, True),      # nw 8, n 95: W in global memory
])
def test_chol_shapes_match_plain_on_card(nw, B, n, bad, cuda):
    """The look-ahead Cholesky equals the plain version bit for bit, ok
    flags included, at the sizes where its chain, its shared layout (odd
    pitch) and its global-memory path differ; with ``bad`` the last member
    turns indefinite at a middle pivot (at n 1, its only pivot is -1);
    past it the words may grow to NaN, so bit patterns are compared."""
    if not bad:
        A = spd_words(B, n, nw, 60 + n)
    elif n == 1:
        A = split_words(np.array([2.0, -1.0]).reshape(B, 1, 1), nw)
    else:
        A = _indefinite_at(B, n, nw, n // 2, 60 + n)
    A = _t(A, cuda)
    K.reset_counts()
    Lk, okk = K.chol_batched(A)
    Lp, okp = K.chol_plain(A)
    # bit patterns: past a failed pivot the factor may hold NaNs
    assert torch.equal(okk, okp)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(Lk, Lp))
    assert okk.tolist() == [True] * (B - bad) + [False] * bad
    assert K.counts()["chol_batched"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["int8_deep_k", "int8_grid_rows",
                                  "chol_no_room", "limb_gemm_deep_k",
                                  "extract_batch"])
def test_refused_launch_raises_on_card(case, cuda):
    """A shape a kernel refuses raises in its wrapper; nothing is launched
    and no plain version runs in its place."""
    K.reset_counts()
    with pytest.raises((ValueError, RuntimeError)):
        if case == "int8_deep_k":          # beyond the exact depth 2^13
            K.int8_gemm(torch.zeros((1, 4, 8193), dtype=torch.int8,
                                    device=cuda),
                        torch.zeros((1, 8193, 4), dtype=torch.int8,
                                    device=cuda))
        elif case == "int8_grid_rows":     # 65,536 row tiles of 64
            K.int8_gemm(torch.zeros((1, 64 * 65535 + 1, 1), dtype=torch.int8,
                                    device=cuda),
                        torch.zeros((1, 1, 1), dtype=torch.int8, device=cuda))
        elif case == "chol_no_room":       # coll and rowl exceed 227 KB
            z = torch.zeros((1, 2000, 2000), device=cuda)
            K.chol_batched((z,) * 8)
        elif case == "limb_gemm_deep_k":   # beyond the exact depth 2^13
            L, _ = K.limb_params(5)
            K.limb_gemm(torch.zeros((1, L, 2, 8193), dtype=torch.int8,
                                    device=cuda),
                        torch.zeros((1, L, 8193, 2), dtype=torch.int8,
                                    device=cuda),
                        torch.zeros((1, 2, 2), dtype=torch.int32,
                                    device=cuda), 5)
        else:                              # 65,536 batch members: grid z
            z = torch.zeros((65536, 1, 1), device=cuda)
            K.limb_extract((z,) * 5, K.limb_params(5)[0], "a")
    torch.cuda.synchronize()
    assert all(v == 0 for v in K.counts().values())


@pytest.mark.gpu
@pytest.mark.parametrize("nw", [5, 6, 7, 8])
def test_chain_kernels_match_plain_on_card(nw, cuda):
    """plmap_add/axpy/residual equal their plain versions bit for bit on the
    card, with the [L, 1, 1] scalar first and a batch-broadcast mask."""
    rng = np.random.default_rng(30 + nw)
    L, n = 3, 11
    x = _t(split_words(rng.standard_normal((L, n, n)), nw), cuda)
    d = _t(split_words(rng.standard_normal((L, n, n)) * 1e-3, nw), cuda)
    mu = _t(split_words(rng.standard_normal((L, 1, 1)), nw), cuda)
    alpha = _t(split_words(rng.random((1, 1, 1)), 3), cuda)
    alpha = tuple(c.expand(L, 1, 1) for c in alpha)
    mask = torch.ones((n, n), device=cuda)
    mask[-2:, :] = 0.0
    mask = mask.expand(L, n, n)
    assert _same(K.plmap_add(x, d), K.plmap_add_plain(x, d))
    assert _same(K.plmap_axpy(x, d, alpha), K.plmap_axpy_plain(x, d, alpha))
    for corr in (None, d):
        assert _same(K.plmap_residual(mu, mask, x, corr),
                     K.plmap_residual_plain(mu, mask, x, corr))
    # scalar first: the output takes the broadcast shape
    out = K.plmap_add(mu, x)
    assert out[0].shape == (L, n, n) and _same(out, K.plmap_add_plain(mu, x))


def _bits(xs, ys):
    """Bit-identical word tuples (-0.0 and +0.0 differ, equal NaNs agree)."""
    return all(a.shape == b.shape and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))
               for a, b in zip(xs, ys))


@pytest.mark.gpu
@pytest.mark.parametrize("nw, B, m, n, k, extreme", [
    (5, 4, 22, 22, 11, False),     # the Schur pairing of delsarte(3,10)
    (5, 1, 100, 130, 37, False),   # above the route threshold
    (6, 1, 1, 1, 3, False),        # one element: one block, one thread
    (7, 3, 1, 17, 5, False),       # m 1
    (8, 2, 17, 1, 4, False),       # n 1
    (5, 300, 3, 5, 2, False),      # B a few hundred, tiny members
    (6, 2, 33, 65, 9, False),      # m, n multiples of no tile
    (5, 1, 33, 65, 8192, True),    # limbs +-65 at the deepest k: largest C
    (8, 1, 27, 40, 8192, True),
])
def test_cascade_shapes_match_plain_on_card(nw, B, m, n, k, extreme, cuda):
    """cascade_from_c and cascade_from_diags equal their plain versions bit
    for bit at the tilings and sizes the kernel treats apart, and with the
    largest diagonal sums an exact product can give."""
    rng = np.random.default_rng(50 + m + n)
    L, _ = K.limb_params(nw)
    A2 = _limbs(rng, (B, L * m, k), extreme).to(cuda)
    B2 = _limbs(rng, (B, k, L * n), extreme).to(cuda)
    C = K.int8_gemm_plain(A2, B2)
    eab = torch.from_numpy(rng.integers(-40, 41, (B, m, n))
                           .astype(np.int32)).to(cuda)
    K.reset_counts()
    assert _bits(K.cascade_from_c(C, eab, nw),
                 K.cascade_from_c_plain(C, eab, nw))
    diags = torch.stack(K._diags_from_c(C, L, m, n, K.limb_params(nw)[1]),
                        1).contiguous()
    assert _bits(K.cascade_from_diags(diags, eab, nw),
                 K.cascade_from_diags_plain(diags, eab, nw))
    c = K.counts()
    assert c["cascade_from_c"] == c["cascade_from_diags"] == 1


def _chain_operands(rng, nw, L, n, form, cuda):
    """x, d as [L, n, n] words laid out as ``form`` says: separate
    contiguous tensors, views of one word-major stack (as the step's words
    lie), transposed views, views sliced out of larger planes (pointers off
    alignment), or one matrix broadcast over L."""
    def draw(scale):
        return rng.standard_normal((L, n, n)) * scale

    def lay(v):
        if form == "stack":
            w = _t(split_words(v, nw), cuda)
            st = torch.stack(w, 1).contiguous()
            return tuple(st[:, i] for i in range(nw))
        if form == "transposed":
            return tuple(c.transpose(1, 2) for c in _t(split_words(
                v.transpose(0, 2, 1).copy(), nw), cuda))
        if form == "sliced":
            big = np.zeros((L, n + 1, n + 1))
            big[:, 1:, 1:] = v
            return tuple(c[:, 1:, 1:] for c in _t(split_words(big, nw), cuda))
        if form == "shared":
            return tuple(c.expand(L, n, n) for c in
                         _t(split_words(v[:1], nw), cuda))
        return _t(split_words(v, nw), cuda)

    return lay(draw(10.0)), lay(draw(1e-3))


@pytest.mark.gpu
@pytest.mark.parametrize("nw, L, n, form", [
    (5, 2, 96, "contiguous"), (5, 2, 96, "stack"), (6, 1, 96, "transposed"),
    (7, 4, 11, "sliced"), (8, 3, 96, "sliced"), (5, 4, 1, "contiguous"),
    (8, 2, 11, "shared"), (6, 3, 10, "stack"), (7, 1, 95, "transposed"),
    (8, 2, 96, "stack"),
])
def test_chain_operand_forms_match_plain_on_card(nw, L, n, form, cuda):
    """The three chains equal their plain versions bit for bit with
    operands broadcast, transposed and sliced, at L 1-4 and n 1-96."""
    rng = np.random.default_rng(60 + n + L)
    x, d = _chain_operands(rng, nw, L, n, form, cuda)
    mu = tuple(c.reshape(1, 1, 1).expand(L, 1, 1) for c in
               _t(split_words(rng.random(1) * 1e3, nw), cuda))
    alpha = tuple(c.expand(L, 1, 1) for c in
                  _t(split_words(rng.random((1, 1, 1)), 3), cuda))
    mask = torch.ones((L, n, n), device=cuda)
    mask[-1, -1, :] = 0.0
    if form == "transposed":
        mask = mask.transpose(1, 2)
    assert _bits(K.plmap_add(x, d), K.plmap_add_plain(x, d))
    assert _bits(K.plmap_axpy(x, d, alpha), K.plmap_axpy_plain(x, d, alpha))
    for corr in (None, d):
        assert _bits(K.plmap_residual(mu, mask, x, corr),
                     K.plmap_residual_plain(mu, mask, x, corr))


@pytest.mark.gpu
@pytest.mark.parametrize("nw, B, n", [(5, 2, 64), (8, 2, 64)])
def test_cpu_plain_cholesky_equals_card_kernel(nw, B, n, cuda):
    """The plain Cholesky on the CPU and chol_batched on the card give the
    same words bit for bit: the CPU's rsqrt seed is the IEEE one the
    kernel computes."""
    A = spd_words(B, n, nw, 0)
    Lc, okc = K.chol_plain(_t(A, "cpu"))
    Lk, okk = K.chol_batched(_t(A, cuda))
    assert torch.equal(okc, okk.cpu())
    assert _bits(Lc, tuple(c.cpu() for c in Lk))


@pytest.mark.gpu
def test_wrappers_raise_instead_of_falling_back(cuda):
    """A CUDA operand the kernels do not take raises; it never runs the
    plain version."""
    K.reset_counts()
    with pytest.raises(ValueError):
        K.chol_batched(_t(spd_words(1, 4, 3, 0), cuda))    # nw=3: not built
    with pytest.raises(ValueError):
        K.tri_solve_batched(_t(spd_words(1, 4, 5, 0), cuda),
                            _t(split_words(np.ones((1, 4, 2)), 5), "cpu"))
    x = _t(split_words(np.ones((2, 3, 3)), 3), cuda)
    with pytest.raises(ValueError):
        K.plmap_add(x, x)                                  # nw=3: not built
    with pytest.raises(ValueError):
        K.int8_gemm(torch.zeros((1, 2, 3), dtype=torch.int8, device=cuda),
                    torch.zeros((1, 3, 2), dtype=torch.int32, device=cuda))
    assert all(v == 0 for v in K.counts().values())


@pytest.mark.gpu
def test_step_on_card_matches_cpu(cuda, monkeypatch):
    """Two steps of delsarte(3,3) on the card (kernels) and on the CPU
    (plain versions): the expansion words agree bit for bit up to the
    first f64 eigensolver call (its input, L^-1 dM L^-T of the first
    step-length bound, is compared word by word), and the five info
    scalars of both steps agree at rel 1e-13, since the step lengths come
    from two f64 eigensolvers (the eig_lowest kernel on the card, LAPACK on
    the CPU, as the step takes them). Otherwise both take the same route: a
    kernel launches on the card where its plain version runs on the CPU,
    and the split route and the chain kernels are among them."""
    sdp = ct.ClusteredLowRankSDP(delsarte(ct, 3))
    rows, routes, first_eig = {}, {}, {}
    eig_input = TS._eig_input

    def recording(W2):
        first_eig.setdefault(W2[0].device.type,
                             tuple(c.cpu().clone() for c in W2))
        return eig_input(W2)

    monkeypatch.setattr(TS, "_eig_input", recording)
    for dev in ("cpu", cuda):
        ds = TS.DeviceSDP(sdp, nw=5, device=dev)
        step = TS.make_step_body(ds, **STEP_KW)
        state, feas, r = TS.initial_state(ds, 100.0, 100.0), False, []
        K.reset_counts()
        for _ in range(2):
            state, info = step(state, feas)
            feas = bool(info["pd_feas"])
            r.append([float(info[k]) for k in ("mu", "d_obj", "p_obj",
                                               "alpha_d", "alpha_p")])
        counts = K.counts()
        on_card = dev != "cpu"
        # kernel wrapper -> the route it names; its plain version likewise
        # (the eigensolver is LAPACK's on the CPU, not a plain version)
        pairs = [(f, p) for f, p in zip(K._COUNTED, K._PLAIN)
                 if f is not K.eig_lowest]
        ran = {f.__name__ for f, p in pairs
               if counts[(f if on_card else p).__name__] > 0}
        idle = K._PLAIN if on_card else K._COUNTED
        assert all(counts[f.__name__] == 0 for f in idle)
        assert (counts["eig_lowest"] > 0) == on_card
        routes[on_card] = ran
        rows[on_card] = r
    assert routes[True] == routes[False]
    assert {"int8_gemm", "cascade_from_c", "plmap_add", "plmap_axpy",
            "plmap_residual", "chol_batched", "tri_solve_batched",
            "limb_extract"} <= routes[True]
    assert set(first_eig) == {"cpu", "cuda"}
    assert _bits(first_eig["cpu"], first_eig["cuda"])
    for a, b in zip(rows[False], rows[True]):
        assert a == pytest.approx(b, rel=1e-13, abs=1e-18)


def _leaves(tree):
    out = []
    TS._tree_map(out.append, tree)
    return out


_AS_INT = {torch.float32: torch.int32, torch.float64: torch.int64}


def _same_tree(a, b):
    """Two states or infos of one structure hold the same bits."""
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.view(_AS_INT.get(x.dtype, x.dtype)),
                        y.view(_AS_INT.get(y.dtype, y.dtype)))
        for x, y in zip(la, lb))


@pytest.mark.gpu
@pytest.mark.parametrize("nw", [5, 8])
def test_graph_step_equals_eager_step_on_card(nw, cuda):
    """make_step (the head and tail replayed from CUDA graphs) gives the
    eager step's state and info word for word, two steps of
    delsarte(3,3), and counts the launches the eager step makes."""
    ds = TS.DeviceSDP(ct.ClusteredLowRankSDP(delsarte(ct, 3)), nw=nw,
                      device=cuda)
    body = TS.make_step_body(ds, **STEP_KW)
    graph = TS.make_step(ds, **STEP_KW)
    se, fe = TS.initial_state(ds, 100.0, 100.0), False
    sg, fg = se, False
    graph(se, False)                     # capture
    for _ in range(2):
        K.reset_counts()
        se, ie = body(se, fe)
        torch.cuda.synchronize()
        eager_counts = K.counts()
        K.reset_counts()
        sg, ig = graph(sg, fg)
        torch.cuda.synchronize()
        assert K.counts() == eager_counts
        assert _same_tree(se, sg) and _same_tree(ie, ig)
        fe, fg = ie["pd_feas"], ig["pd_feas"].clone()
        sg = TS._tree_map(torch.clone, sg)


@pytest.mark.gpu
def test_graph_chunk_equals_eager_chunk_on_card(cuda, monkeypatch):
    """make_run_chunk through the graphs against the same loop run eagerly
    on the card: chunks of 1 and 3, then a chunk that terminates in its
    middle (delsarte(3,3) with a loose duality-gap threshold)."""
    ds = TS.DeviceSDP(ct.ClusteredLowRankSDP(delsarte(ct, 3)), nw=5,
                      device=cuda)
    kw = dict(STEP_KW, duality_gap_threshold=1e-2)
    runs = {}
    for capture in (True, False):
        monkeypatch.setattr(TS, "_CAPTURE", capture)
        run = TS.make_run_chunk(ds, **kw)
        carry = (TS.initial_state(ds, 100.0, 100.0), False,
                 TS.zero_info(None, cuda))
        rows = []
        for n in (1, 3, 40):
            out = run(*carry, n)
            carry = out[:3]
            rows.append(TS._tree_map(torch.clone, out))
        runs[capture] = rows
        assert isinstance(run.loop["split"], G.GraphStep) == capture
    for a, b in zip(runs[True], runs[False]):
        assert _same_tree(a, b)
    it, code, done = (int(runs[True][-1][k]) for k in (3, 4, 5))
    assert code == 0 and done and 0 < it < 40


@pytest.mark.gpu
def test_graph_replays_need_no_host_sync(cuda):
    """The step's replay (head, the eigensolver kernel and tail in one
    graph) raises nothing under torch.cuda.set_sync_debug_mode("error"),
    on both step-length routes: no part of an iteration waits on the
    device."""
    ds = TS.DeviceSDP(ct.ClusteredLowRankSDP(delsarte(ct, 3)), nw=5,
                      device=cuda)
    for verified in (None, True):
        TS._STEPLEN_VERIFIED = verified
        try:
            step = TS.make_step(ds, **STEP_KW)
            step(TS.initial_state(ds, 100.0, 100.0), False)
        finally:
            TS._STEPLEN_VERIFIED = None
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step.buffers["graph"].run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("capture", [True, False])
def test_failing_cholesky_gives_code_1_on_card(capture, cuda, monkeypatch):
    """A NaN in X makes chol(X) fail and the step-length matrices NaN (the
    members the eigensolver then gets zeroed): the step and the chunk,
    through the graph and eagerly, end with ok False and code 1, not an
    exception; so does X = -I."""
    monkeypatch.setattr(TS, "_CAPTURE", capture)
    ds = TS.DeviceSDP(ct.ClusteredLowRankSDP(delsarte(ct, 3)), nw=5,
                      device=cuda)
    _, info = TS.make_step(ds, **STEP_KW)(
        poison_x(TS.initial_state(ds, 1.0, 1.0)), False)
    assert not bool(info["ok"]) and not bool(info["ok_X"])
    run = TS.make_run_chunk(ds, duality_gap_threshold=1e-15, **STEP_KW)
    for state in (poison_x(TS.initial_state(ds, 1.0, 1.0)),
                  TS.initial_state(ds, -1.0, 100.0)):
        out = run(state, False, TS.zero_info(None, cuda), 3)
        assert (int(out[3]), int(out[4]), bool(out[5])) == (0, 1, True)


# ---------------------------------------------------------------------------
# the f64 substrate: card against CPU, graphs against eager
# ---------------------------------------------------------------------------

def _wild_words(rng, shape, nw, positive=False):
    """nw f64 words: half the elements a normalised expansion, half words
    of independent magnitudes, all between 1e-150 and 1e150."""
    mag = lambda: 10.0 ** rng.uniform(-150, 150, shape)  # noqa: E731
    sign = 1.0 if positive else rng.choice([-1.0, 1.0], shape)
    ws = [sign * rng.uniform(1, 2, shape) * mag()]
    wild = rng.random(shape) < 0.5
    for _ in range(1, nw):
        tame = ws[-1] * 2.0 ** -rng.integers(53, 60, shape) \
            * rng.uniform(-1, 1, shape)
        ws.append(np.where(wild, rng.uniform(-1, 1, shape) * mag(), tame))
    return ws


def _same_nan(a, b):
    """Same bits, any NaN equal to any NaN."""
    for x, y in zip(a, b):
        x, y = x.cpu(), y.cpu()
        nan = torch.isnan(x)
        if not torch.equal(nan, torch.isnan(y)):
            return False
        if not torch.equal(torch.where(nan, 0.0, x).view(torch.int64),
                           torch.where(nan, 0.0, y).view(torch.int64)):
            return False
    return len(a) == len(b)


@pytest.mark.gpu
@pytest.mark.parametrize("nw", [2, 4, 5])
def test_f64_ops_card_equal_cpu(nw, cuda):
    """Every f64 op on the card equals the same op on the CPU bit for bit
    (CUDA f64 keeps subnormals, so the CPU runs without a flush)."""
    from clrs_tpu_torch.dd import f64ops as F

    rng = np.random.default_rng(nw)
    n = 1 << 14
    x, y = _wild_words(rng, n, nw), _wild_words(rng, n, nw)
    p = _wild_words(rng, n, nw, positive=True)
    a = rng.uniform(-3, 3, n) * 10.0 ** rng.uniform(-150, 150, n)
    ops = {"add": lambda x, y, p, a: F.dd_add(x, y),
           "mul": lambda x, y, p, a: F.dd_mul(x, y),
           "div": lambda x, y, p, a: F.dd_div(x, y),
           "mul_f64": lambda x, y, p, a: F.dd_mul_f64(x, a),
           "add_f64": lambda x, y, p, a: F.dd_add_f64(x, a),
           "rsqrt": lambda x, y, p, a: F.dd_rsqrt(p),
           "sqrt": lambda x, y, p, a: F.dd_sqrt(p),
           "qd_add": lambda x, y, p, a: F.qd_add(x, y),
           "qd_mul": lambda x, y, p, a: F.qd_mul(x, y),
           "max": lambda x, y, p, a: F.dd_max(x, y)}
    out = {}
    for dev in ("cpu", cuda):
        args = (_t(x, dev), _t(y, dev), _t(p, dev),
                torch.from_numpy(a).to(dev))
        out[dev] = {k: f(*args) for k, f in ops.items()}
    for k in ops:
        assert _same_nan(out["cpu"][k], out[cuda][k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("nw", [2, 4, 5])
@pytest.mark.parametrize("k", [1, 22, 192])
def test_slice_matmul_card_equals_cpu(k, nw, cuda):
    """The slice GEMM (its one cuBLAS DGEMM exact under the slice budget)
    on the card equals the CPU's bit for bit, batched, rows and columns
    of magnitudes between 1e-150 and 1e150."""
    from clrs_tpu_torch.dd.slice_gemm import slice_matmul

    rng = np.random.default_rng(k + 10 * nw)
    a = _wild_words(rng, (3, 9, k), nw)
    b = _wild_words(rng, (3, k, 7), nw)
    cpu = slice_matmul(_t(a, "cpu"), _t(b, "cpu"))
    card = slice_matmul(_t(a, cuda), _t(b, cuda))
    assert _same_nan(cpu, card)


@pytest.mark.gpu
def test_f64_step_on_card_matches_cpu(cuda, monkeypatch):
    """Two f64 steps of delsarte(3,3) at nw 2: the words agree bit for bit
    up to the first eigensolver call (its input compared word by word);
    the info scalars at rel 1e-13 (two f64 eigensolvers: the eig_lowest
    kernel on the card, LAPACK on the CPU). No other kernel of csrc/ runs
    on f64 words, and no plain version but the f64 boundary's sum and
    max |.|, which f64 words take on both devices."""
    sdp = ct.ClusteredLowRankSDP(delsarte(ct, 3))
    rows, first_eig = {}, {}
    eig_input = TS._eig_input

    def recording(W2):
        first_eig.setdefault(W2[0].device.type,
                             tuple(c.cpu().clone() for c in W2))
        return eig_input(W2)

    monkeypatch.setattr(TS, "_eig_input", recording)
    for dev in ("cpu", cuda):
        ds = TS.DeviceSDP(sdp, nw=2, device=dev, dtype=torch.float64)
        step = TS.make_step_body(ds, **STEP_KW)
        state, feas, r = TS.initial_state(ds, 100.0, 100.0), False, []
        K.reset_counts()
        for _ in range(2):
            state, info = step(state, feas)
            feas = bool(info["pd_feas"])
            r.append([float(info[k]) for k in ("mu", "d_obj", "p_obj",
                                               "alpha_d", "alpha_p")])
        counts = K.counts()
        assert counts.pop("eig_lowest") == (2 if dev != "cpu" else 0)
        # f64 words take the f64 boundary's plain sum and max |.|
        assert counts.pop("expf64_sum_plain") > 0
        assert counts.pop("expf64_max_abs_plain") > 0
        assert all(v == 0 for v in counts.values())
        rows[dev != "cpu"] = r
    assert _same_nan(first_eig["cpu"], first_eig["cuda"])
    for a, b in zip(rows[False], rows[True]):
        assert a == pytest.approx(b, rel=1e-13, abs=1e-18)


@pytest.mark.gpu
@pytest.mark.parametrize("nw", [2, 5])
def test_f64_graph_step_equals_eager_step_on_card(nw, cuda):
    """make_step on f64 words: the graph step's state and info equal the
    eager step's word for word, two steps of delsarte(3,3); the replays
    need no host sync."""
    ds = TS.DeviceSDP(ct.ClusteredLowRankSDP(delsarte(ct, 3)), nw=nw,
                      device=cuda, dtype=torch.float64)
    body = TS.make_step_body(ds, **STEP_KW)
    graph = TS.make_step(ds, **STEP_KW)
    se, fe = TS.initial_state(ds, 100.0, 100.0), False
    sg, fg = se, False
    graph(se, False)                     # capture
    for _ in range(2):
        se, ie = body(se, fe)
        sg, ig = graph(sg, fg)
        torch.cuda.synchronize()
        assert _same_tree(se, sg) and _same_tree(ie, ig)
        fe, fg = ie["pd_feas"], ig["pd_feas"].clone()
        sg = TS._tree_map(torch.clone, sg)
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.buffers["graph"].run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the step's expansion arithmetic (csrc/expmap.cu): expmap<NW, OP> and
# tree_sum<NW> against their plain versions on the card, at the shape
# classes of tests/test_torch_expmap.py
# ---------------------------------------------------------------------------

EW_SHAPES = [((), ()), ((1, 21), ()), ((2, 22, 1), (2, 22, 11)),
             ((1, 21, 22), (1, 21, 1)), ((2, 22, 1, 22, 1), (2, 22, 1, 22, 1)),
             ((2, 11, 11), "T"), ((2, 0, 5), (1, 5))]


def _exp_words(rng, shape, nw, dev):
    """nw f32 words on ``dev``: word 0 over 16 decades, word k ~2^-24k of
    it."""
    w0 = np.asarray(rng.standard_normal(shape)) * 10.0 ** np.asarray(
        rng.integers(-8, 8, shape))
    ws = [w0] + [w0 * np.asarray(rng.standard_normal(shape))
                 * 2.0 ** (-24 * k) for k in range(1, nw)]
    return tuple(torch.from_numpy(np.asarray(w, np.float32)).to(dev)
                 for w in ws)


def _bits(xs, ys):
    return len(xs) == len(ys) and all(
        a.shape == b.shape and torch.equal(a.view(torch.int32),
                                           b.view(torch.int32))
        for a, b in zip(xs, ys))


@pytest.mark.gpu
@pytest.mark.parametrize("xs, ys", EW_SHAPES)
@pytest.mark.parametrize("nw", [5, 8])
def test_expmap_matches_plain_on_card(nw, xs, ys, cuda):
    """Each expmap<NW, OP> equals its plain version bit for bit; an empty
    output launches nothing."""
    rng = np.random.default_rng(nw)
    x = _exp_words(rng, xs, nw, cuda)
    if ys == "T":      # transposed views, both operands
        x = tuple(c.transpose(1, 2) for c in x)
        y = tuple(c.transpose(1, 2) for c in _exp_words(rng, xs, nw, cuda))
    else:
        y = _exp_words(rng, ys, nw, cuda)
    K.reset_counts()
    for name in ("add", "sub", "mul", "div"):
        got = getattr(K, f"ew_{name}")(x, y)
        assert _bits(got, getattr(K, f"ew_{name}_plain")(x, y)), name
    assert _bits(K.ew_neg(x), K.ew_neg_plain(x))
    sym = x if x[0].dim() >= 2 and x[0].shape[-1] == x[0].shape[-2] else None
    if sym is not None:
        assert _bits(K.ew_symmetrize(sym), K.ew_symmetrize_plain(sym))
    torch.cuda.synchronize()
    c = K.counts()
    launched = 0 if x[0].numel() * y[0].numel() == 0 else 1
    for name in ("add", "sub", "mul", "div"):
        assert c[f"ew_{name}"] == launched
    assert c["ew_neg"] == (1 if x[0].numel() else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape, axis", [
    ((1, 2, 22), 1), ((2, 22, 11), 2), ((242,), 0), ((2, 22, 22, 1), 3),
    ((1, 1, 1), 0), ((0, 4), 0), ((3, 0), 0), ((13, 4), 0), ((2, 5, 7, 3), -2),
    ((12001, 2), 0),      # a long column: a cluster of blocks
    ((9000, 3), 0),
    ((400001, 1), 0)])    # past a full cluster: one launch a level
@pytest.mark.parametrize("nw", [5, 8])
def test_tree_sum_matches_plain_on_card(nw, shape, axis, cuda):
    x = _exp_words(np.random.default_rng(nw + len(shape)), shape, nw, cuda)
    if shape == (13, 4):
        x = tuple(c.t().contiguous().t() for c in x)     # a strided input
    K.reset_counts()
    got = K.tree_sum(x, axis)
    assert _bits(got, K.tree_sum_plain(x, axis))
    route, plan = K.tree_sum_plan(shape[axis], nw, 1)
    want = (0 if got[0].numel() == 0 else
            len(plan) if route == "levels" else 1)     # block, cluster: one
    assert K.counts()["tree_sum"] == want


FUSE_SHAPES = [((), (), (), None), ((1, 21), (), (1, 21), (1, 21)),
               ((2, 22, 1), (2, 22, 11), (2, 22, 11), (2, 22, 11)),
               ((2, 11, 11), "T", "T", (2, 11, 11)), ((2, 0, 5), (1, 5),
                                                     (2, 0, 5), None)]


@pytest.mark.gpu
@pytest.mark.parametrize("shapes", FUSE_SHAPES)
@pytest.mark.parametrize("nw", [5, 8])
def test_expfuse_matches_plain_on_card(nw, shapes, cuda):
    """Each fused form (a scale on the last operand of sub2, a {0,1} mask)
    equals its plain version bit for bit, one launch each; an empty output
    launches nothing."""
    rng = np.random.default_rng(nw + 3)
    *sh, ms = shapes
    ops = []
    for s in sh + [sh[-1]]:
        if s == "T":
            ops.append(tuple(c.transpose(1, 2)
                             for c in _exp_words(rng, (2, 11, 11), nw, cuda)))
        else:
            ops.append(_exp_words(rng, s, nw, cuda))
    mask = None if ms is None else torch.from_numpy(
        rng.integers(0, 2, ms).astype(np.float32)).to(cuda)
    K.reset_counts()
    for name, n in (("fma", 3), ("fms", 3), ("msub", 3), ("mms", 4)):
        got = getattr(K, f"ew_{name}")(*ops[:n], mask=mask)
        assert _bits(got, getattr(K, f"ew_{name}_plain")(*ops[:n], mask))
    for scale in (-1.0, None):
        got = K.ew_sub2(*ops[:3], scale, mask)
        assert _bits(got, K.ew_sub2_plain(*ops[:3], scale, mask))
    torch.cuda.synchronize()
    c = K.counts()
    launched = 0 if got[0].numel() == 0 else 1
    for name in ("fma", "fms", "msub", "mms"):
        assert c[f"ew_{name}"] == launched
    assert c["ew_sub2"] == 2 * launched


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 2, 3, 96, 243, 18432, 32768])
@pytest.mark.parametrize("nw", [5, 8])
def test_tree_sum_fused_matches_plain_on_card(nw, n, cuda):
    """acc +- sum(x s y) over a column of n entries (3 columns of a
    transposed view; one column of a long one: a cluster) equals the
    plain composition bit for bit in one launch, both epilogues, the
    scale on x and on the product."""
    rng = np.random.default_rng(n + nw)
    cols = 1 if n > 1000 else 3
    x = tuple(c.t() for c in _exp_words(rng, (cols, n), nw, cuda))
    y = _exp_words(rng, (n, 1), nw, cuda)
    acc = _exp_words(rng, (cols,), nw, cuda)
    sc = torch.from_numpy(rng.integers(0, 2, (n, cols)).astype(
        np.float32)).to(cuda)
    for sub, scale_on in ((False, None), (True, "x"), (False, "product")):
        scale = None if scale_on is None else sc
        K.reset_counts()
        got = K.tree_sum_fused(x, y, 0, acc, sub, scale, scale_on)
        assert _bits(got, K.tree_sum_fused_plain(x, y, 0, acc, sub, scale,
                                                 scale_on))
        assert K.counts()["tree_sum_fused"] == 1
    got = K.tree_sum_fused(x, y, None)                 # a dot over all
    assert _bits(got, K.tree_sum_fused_plain(x, y, None))


@pytest.mark.gpu
@pytest.mark.parametrize("flag", [True, False])
def test_select_matches_plain_on_card(flag, cuda):
    """ew_select picks every word of 27 non-empty pairs among 36 (two
    launches) on a device bool, in place, as torch.where and the copy
    do."""
    rng = np.random.default_rng(4)
    shapes = [(2, 3), (0, 4), (7,), (1, 21, 22)] * 9
    pairs = [(_exp_words(rng, s, 5, cuda), _exp_words(rng, s, 5, cuda))
             for s in shapes]
    cond = torch.tensor(flag, device=cuda)
    dk = [tuple(c.clone() for c in d) for _, d in pairs]
    dp = [tuple(c.clone() for c in d) for _, d in pairs]
    K.reset_counts()
    K.ew_select(cond, [(s, d) for (s, _), d in zip(pairs, dk)])
    K.ew_select_plain(cond, [(s, d) for (s, _), d in zip(pairs, dp)])
    torch.cuda.synchronize()
    assert K.counts()["ew_select"] == 2
    for a, b in zip(dk, dp):
        assert _bits(a, b)


@pytest.mark.gpu
def test_step_runs_expansion_ops_as_kernels_on_card(cuda):
    """An eager f32 step on the card launches every expansion kernel and
    runs no plain version."""
    ds = TS.DeviceSDP(ct.ClusteredLowRankSDP(delsarte(ct, 3)), nw=5,
                      device=cuda)
    K.reset_counts()
    TS.make_step_body(ds, **STEP_KW)(TS.initial_state(ds, 100.0, 100.0),
                                     False)
    torch.cuda.synchronize()
    c = K.counts()
    for name in ("ew_add", "ew_sub", "ew_mul", "ew_div", "ew_neg",
                 "ew_symmetrize", "tree_sum_fused", "ew_fma", "ew_fms",
                 "ew_msub", "ew_mms", "ew_sub2"):
        assert c[name] > 0, name
    assert all(v == 0 for k, v in c.items() if k.endswith("_plain"))


# ---------------------------------------------------------------------------
# the f64 boundary (csrc/expf64.cu): expf64<NW, FORM> against the plain
# versions, PyTorch's kernels on the same CUDA words
# ---------------------------------------------------------------------------

# the cells' shapes: delsarte(3,10)'s and (3,40)'s blocks and scalar packs,
# three-point's larger residual blocks, a long and a two-block max_abs
EXPF64_SHAPES = [(), (1, 20), (1, 80), (2, 11, 11), (4, 41, 41),
                 (12, 27, 27), (3000,), (40000,), (2, 0, 5)]


def _f64_words(rng, shape, nw, dev, special):
    """_exp_words, with NaN (one entry), +-Inf, -0 and subnormal words
    where ``special``."""
    ws = [c.cpu().numpy().reshape(-1).copy()
          for c in _exp_words(rng, shape, nw, "cpu")]
    n = ws[0].size
    if special and n:
        ws[0][0] = ws[min(1, nw - 1)][0] = -0.0
        ws[0][n // 2] = np.nan
        ws[min(2, nw - 1)][n // 3] = np.inf
        ws[nw - 1][n - 1] = -np.inf if n > 2 else ws[nw - 1][n - 1]
        for w in ws[1:]:
            w[1::4] = np.float32(2.0 ** -140) * 7
    return tuple(torch.from_numpy(w.reshape(shape)).to(dev) for w in ws)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", EXPF64_SHAPES)
@pytest.mark.parametrize("nw", [1, 5, 8])
def test_expf64_matches_plain_on_card(nw, shape, cuda):
    """SUM and MAXABS (no accumulator, a finite one, a NaN one) equal their
    plain versions bit for bit, NaN, +-Inf, -0 and subnormal words
    included, on contiguous, transposed and [:, 0, 0] views; one launch
    each (an empty sum launches nothing)."""
    rng = np.random.default_rng(nw + len(shape))
    for special in (False, True):
        x = _f64_words(rng, shape, nw, cuda, special)
        views = [x]
        if len(shape) == 3 and x[0].numel():
            views += [tuple(c.transpose(1, 2) for c in x),
                      tuple(c[:, 0, 0] for c in x)]
        for v in views:
            K.reset_counts()
            assert _same_tree([K.expf64_sum(v)], [K.expf64_sum_plain(v)])
            assert _same_tree([K.expf64_max_abs(v)],
                              [K.expf64_max_abs_plain(v)])
            for acc in (0.5, float("nan")):
                a = torch.tensor(acc, dtype=torch.float64, device=cuda)
                assert _same_tree([K.expf64_max_abs(v, a)],
                                  [K.expf64_max_abs_plain(v, a)])
            torch.cuda.synchronize()
            c = K.counts()
            assert c["expf64_sum"] == (1 if v[0].numel() else 0)
            assert c["expf64_max_abs"] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("nw", [1, 2, 3, 5, 8])
def test_expf64_split_matches_plain_on_card(nw, cuda):
    """SPLIT equals its plain version bit for bit on values that need all
    three words, NaN, +-Inf, -0, f64 subnormals and values whose f32
    rounding is subnormal or overflows, 0-d and strided; the words are
    views of one buffer; one launch a split."""
    rng = np.random.default_rng(nw)
    vals = np.concatenate([
        rng.standard_normal(40) * 2.0 ** rng.integers(-60, 60, 40),
        [1 + 2.0 ** -26 + 2.0 ** -49 + 2.0 ** -52, np.pi, 0.1, np.nan,
         np.inf, -np.inf, -0.0, 5e-310, 2.0 ** -140 * (1 + 2.0 ** -40),
         1e300, -3.5e38]])
    v = torch.from_numpy(vals).to(cuda)
    for src in (v, v[5], v[7], v.reshape(3, 17)[:, ::2],
                v.reshape(3, 17).t()):
        K.reset_counts()
        got = K.expf64_split(src, nw)
        assert _same_tree(list(got), list(K.expf64_split_plain(src, nw)))
        assert all(w.data_ptr() == got[0].data_ptr() + k * 4 * src.numel()
                   for k, w in enumerate(got))
        torch.cuda.synchronize()
        assert K.counts()["expf64_split"] == 1


@pytest.mark.gpu
def test_expf64_graph_iteration_equals_plain_route_at_delsarte_3_10(
        cuda, monkeypatch):
    """One delsarte(3,10) graph iteration through the expf64 kernels gives
    the state and info words of the same graph iteration with the three
    forms' plain versions (PyTorch's kernels) in their place; a replay
    counts the kernels and no plain version; the graph holds at least 150
    fewer PyTorch kernel nodes, and no phase holds more."""
    from fractions import Fraction

    from clrs_tpu_torch.examples import delsarte_problem

    ds = TS.DeviceSDP(ct.ClusteredLowRankSDP(
        delsarte_problem(3, 10, Fraction(1, 2))), nw=5, device=cuda)
    s0 = TS.initial_state(ds, 100.0, 100.0)
    out, info = {}, {}
    for route in ("kernel", "plain"):
        if route == "plain":
            for name in ("expf64_sum", "expf64_max_abs", "expf64_split"):
                monkeypatch.setattr(K, name, getattr(K, name + "_plain"))
        graph = TS.make_step(ds, **STEP_KW)
        graph(s0, False)                                    # capture
        K.reset_counts()
        out[route] = TS._tree_map(torch.clone, graph(s0, False))
        torch.cuda.synchronize()
        c = K.counts()
        if route == "kernel":
            for name in ("expf64_sum", "expf64_max_abs", "expf64_split"):
                assert c[name] > 0 and c[name + "_plain"] == 0, name
        info[route] = graph.buffers["graph"].times.info
        print(route, {k: info[route][k] for k in
                      ("phases", "kernel_nodes", "port_launches",
                       "torch_nodes")})
    assert _same_tree(out["kernel"], out["plain"])
    assert info["kernel"]["torch_nodes"] <= info["plain"]["torch_nodes"] - 150
    for a, b in zip(*(zip(i["kernel_nodes"], i["port_launches"])
                      for i in (info["kernel"], info["plain"]))):
        assert a[0] - a[1] <= b[0] - b[1]


# ---------------------------------------------------------------------------
# the step-length eigensolver (csrc/eig.cu): eig_lowest and eig_pairs, and
# the one-graph iteration they make possible
# ---------------------------------------------------------------------------

def _sym_batch(B, n, kind, dtype, dev, seed=0):
    """B symmetric n x n members: random, diagonal, a lowest eigenvalue of
    multiplicity 3, or random with member 1 zero."""
    rng = np.random.default_rng(seed + 31 * n + B)
    a = rng.standard_normal((B, n, n))
    a = a + np.swapaxes(a, 1, 2)
    if kind == "diagonal":
        a = np.stack([np.diag(np.diag(m)) for m in a])
    elif kind == "repeated":
        out = []
        for m in a:
            q, _ = np.linalg.qr(m + 2 * n * np.eye(n))
            lam = np.sort(rng.standard_normal(n))
            lam[:min(n, 3)] = lam[0]
            out.append((q * lam) @ q.T)
        a = np.stack(out)
        a = 0.5 * (a + np.swapaxes(a, 1, 2))
    elif kind == "zero":
        a[1] = 0.0
    return torch.tensor(a, dtype=dtype, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["eig_lowest", "eig_pairs"])
@pytest.mark.parametrize("B, n, kind", [
    (3, 1, "random"), (3, 2, "random"), (4, 11, "random"),
    (3, 11, "diagonal"), (4, 96, "zero"), (2, 33, "repeated"),
    (4, 96, "random"), (1, 128, "random"), (2, 137, "random"),
    (2, 200, "random"), (2, 234, "random"), (2, 236, "random"),
    (1, 520, "random"), (1, 1030, "random")])
def test_eig_kernels_match_plain_on_card(name, B, n, kind, cuda):
    """Each eigensolver kernel equals its plain version bit for bit, on
    both memory routes (shared memory, and global past it: eig_lowest
    from n 168, eig_pairs' A from n 235), and past N 512 (every thread of
    the sweep kernel shares the other blocks) and N 1024 (a thread forms
    two rotations, pair P - 1 among them); eig_pairs launches its sweep
    kernel and its replay once each."""
    dt = torch.float64 if name == "eig_lowest" else torch.float32
    A = _sym_batch(B, n, kind, dt, cuda)
    K.reset_counts()
    out = getattr(K, name)(A)
    assert K.counts()[name] == 1
    if name == "eig_pairs":
        assert K.counts()["eig_pairs_vec"] == 1
    ref = getattr(K, name + "_plain")(A)
    torch.cuda.synchronize()
    assert _same_tree(list(out) if name == "eig_pairs" else [out],
                      list(ref) if name == "eig_pairs" else [ref])
    if name == "eig_lowest":
        lib = torch.linalg.eigvalsh(A)[:, 0]
        tol = 8 * n * 2.0 ** -53 * torch.linalg.matrix_norm(A)
        assert bool(((out - lib).abs() <= tol).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B, n", [(1, 1), (3, 2), (4, 11), (4, 96),
                                  (2, 129)])
def test_eig_replay_matches_plain_on_card(B, n, cuda):
    """The replay of the sweep kernel's rotation logs equals its plain
    version bit for bit on the same logs, and the sweep counts in the logs
    lie in [1, 30] for random members."""
    A = _sym_batch(B, n, "random", torch.float32, cuda)
    _, log = K.eig_pairs_sweeps(A)
    sweeps = log[:, K.eig_pairs_log_layout(n)[2]]
    vec = K.eig_pairs_vec(log, n)
    ref = K.eig_pairs_vec_plain(log, n)
    torch.cuda.synchronize()
    assert _same_tree([vec], [ref])
    assert bool(((sweeps >= 1) & (sweeps <= 30)).all()) or n == 1


@pytest.mark.gpu
def test_one_graph_step_equals_eager_step_at_delsarte_3_10(cuda):
    """At delsarte(3,10) the step's one graph (head, eig_lowest, tail)
    gives the eager step's state and info word for word, each call one
    replay."""
    from fractions import Fraction

    from clrs_tpu_torch.examples import delsarte_problem

    ds = TS.DeviceSDP(ct.ClusteredLowRankSDP(
        delsarte_problem(3, 10, Fraction(1, 2))), nw=5, device=cuda)
    body = TS.make_step_body(ds, **STEP_KW)
    graph = TS.make_step(ds, **STEP_KW)
    s0 = TS.initial_state(ds, 100.0, 100.0)
    se, ie = body(s0, False)
    sg, ig = graph(s0, False)
    torch.cuda.synchronize()
    assert isinstance(graph.buffers["graph"], G.GraphStep)
    assert _same_tree(se, sg) and _same_tree(ie, ig)
    calls = graph.buffers["graph"].host_calls
    graph(s0, False)
    assert graph.buffers["graph"].host_calls == calls + 1


@pytest.mark.gpu
def test_chunk_at_sync_every_4_gives_the_oracle(cuda):
    """delsarte(3,10) through make_run_chunk in chunks of 4 (replays
    queued two iterations ahead of the host's read of done): chip_smoke
    phase 4's result, code 0 in 28 iterations within 1e-9 of the
    oracle."""
    from fractions import Fraction

    from clrs_tpu_torch.examples import delsarte_problem

    problem = delsarte_problem(3, 10, Fraction(1, 2))
    iters = []
    status, _, primal, _, code = ct.solvesdp(
        problem, device=cuda, omega_p=100, omega_d=100, sync_every=4,
        verbose=False, callback=lambda it, info: iters.append(it),
        dual_error_threshold=1e-12, primal_error_threshold=1e-12)
    assert code == 0 and ct.optimal(status) and iters[-1] == 28
    assert abs(float(ct.objvalue(problem, primal)) - 13.15831434739031) < 1e-9


@pytest.mark.gpu
@pytest.mark.parametrize("substrate, verified", [("f32", None), ("f64", None),
                                                 ("f32", True)])
def test_card_solve_calls_no_cusolver(substrate, verified, cuda,
                                      monkeypatch):
    """torch.linalg's eigensolvers, made to raise on CUDA tensors, never
    run in a card solve: f32, f64 and the certified route."""
    from fractions import Fraction

    from clrs_tpu_torch.examples import delsarte_problem

    def refuse(fn):
        def guarded(A, *a, **kw):
            if A.is_cuda:
                raise AssertionError("cuSOLVER ran in a card solve")
            return fn(A, *a, **kw)
        return guarded

    for name in ("eigvalsh", "eigh", "eigvals", "eig"):
        monkeypatch.setattr(torch.linalg, name,
                            refuse(getattr(torch.linalg, name)))
    monkeypatch.setattr(TS, "_STEPLEN_VERIFIED", verified)
    problem = delsarte_problem(3, 10, Fraction(1, 2))
    K.reset_counts()
    _, _, _, _, code = ct.solvesdp(
        problem, device=cuda, substrate=substrate, omega_p=100,
        omega_d=100, maxiterations=5, verbose=False,
        dual_error_threshold=1e-12, primal_error_threshold=1e-12)
    assert code == 2
    assert K.counts()["eig_pairs" if verified else "eig_lowest"] >= 5
    if verified:
        assert K.counts()["eig_pairs_vec"] == K.counts()["eig_pairs"]
