"""The port's limb GEMM (clrs_tpu_torch.dd.limb_gemm / kernels' plain
versions) against the JAX package's, on the CPU.

Everything here is exact integer and IEEE f32 arithmetic on both sides, so
the tolerance is bit identity. The port runs in the reference's subnormal
flush mode for these comparisons (XLA:CPU flushes; see test_torch_ops).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clrs_tpu.dd import limb_gemm as lg
from clrs_tpu.dd import pallas_linalg as P
from clrs_tpu_torch.dd import kernels as K
from clrs_tpu_torch.dd import limb_gemm as tg
from torch_helpers import split_words, xla_subnormals  # noqa: F401


@pytest.fixture
def jax_xla_route():
    """The JAX fx_matmul with every Pallas route off (its XLA form)."""
    olds = (lg._USE_PLCASCADE, lg._USE_PLEXTRACT, lg._USE_PLFUSED,
            lg._PLCASCADE_C_BUDGET)
    try:
        lg._USE_PLCASCADE = lg._USE_PLEXTRACT = lg._USE_PLFUSED = False
        yield
    finally:
        (lg._USE_PLCASCADE, lg._USE_PLEXTRACT, lg._USE_PLFUSED,
         lg._PLCASCADE_C_BUDGET) = olds


def _operands(rng, m, k, n, nw):
    a = rng.standard_normal((m, k)) * 10.0 ** rng.integers(-6, 6, (m, k))
    a[0] = 0.0                                    # a zero row
    b = rng.standard_normal((k, n))
    b[:, -1] *= 1e30                              # a column far above the rest
    return split_words(a, nw), split_words(b, nw)


def _t(ws, batch=True):
    return tuple(torch.from_numpy(np.array(w))[None] if batch
                 else torch.from_numpy(np.array(w)) for w in ws)


def _same(rj, rt):
    assert len(rj) == len(rt)
    for a, b in zip(rj, rt):
        a = np.asarray(a)
        b = b.numpy()
        assert a.shape == b.shape, (a.shape, b.shape)
        assert np.array_equal(a, b), np.max(np.abs(a.astype(np.float64)
                                                   - b.astype(np.float64)))


@pytest.mark.parametrize("nw,shape", [(5, (7, 9, 5)), (8, (6, 11, 4)),
                                      (5, (1, 22, 1))])
def test_fx_matmul_bit_identical_to_jax_xla_route(nw, shape, xla_subnormals,
                                                  jax_xla_route):
    rng = np.random.default_rng(sum(shape) + nw)
    A, B = _operands(rng, *shape, nw)
    rj = jax.jit(lambda a, b: lg.fx_matmul(a, b))(
        tuple(map(jnp.asarray, A)), tuple(map(jnp.asarray, B)))
    rt = tg.fx_matmul(_t(A), _t(B))
    _same(rj, tuple(c[0] for c in rt))
    # a host-precomputed right operand gives the same words
    pre = tg.host_precompute(B, nw, axis=0)
    rp = tg.fx_matmul(_t(A), None, nw=nw,
                      pre_b=(torch.from_numpy(pre[0])[None],
                             torch.from_numpy(pre[1])[None]))
    _same(rj, tuple(c[0] for c in rp))


def test_fx_matmul_equals_jax_fused_pallas_route(xla_subnormals):
    """The JAX fused kernel route (pl_extract + pl_limb_gemm_fused, in the
    Pallas interpreter with the whole-C budget forced to 0) and the port's
    plain fx_matmul give the same words."""
    rng = np.random.default_rng(9)
    A, B = _operands(rng, 7, 9, 5, 5)
    olds = (lg._USE_PLCASCADE, lg._USE_PLEXTRACT, lg._USE_PLFUSED,
            lg._PLCASCADE_C_BUDGET)
    try:
        lg._USE_PLCASCADE = False
        lg._USE_PLFUSED = lg._USE_PLEXTRACT = True
        lg._PLCASCADE_C_BUDGET = 0
        rj = jax.jit(lambda a, b: lg.fx_matmul(a, b))(
            tuple(map(jnp.asarray, A)), tuple(map(jnp.asarray, B)))
    finally:
        (lg._USE_PLCASCADE, lg._USE_PLEXTRACT, lg._USE_PLFUSED,
         lg._PLCASCADE_C_BUDGET) = olds
    rt = tg.fx_matmul(_t(A), _t(B))
    _same(rj, tuple(c[0] for c in rt))


@pytest.mark.parametrize("side", ["a", "b"])
def test_extract_bit_identical_to_pl_extract(side, xla_subnormals):
    """The plain extraction equals pl_extract 'a3'/'b3' (interpreter) on
    limbs and exponents, with a zero row/column and one scaled by more than
    2^126 (two power-of-two steps)."""
    nw = 5
    L, _ = K.limb_params(nw)
    rng = np.random.default_rng(3)
    v = rng.standard_normal((6, 5)) * 10.0 ** rng.integers(-8, 8, (6, 5))
    if side == "a":
        v[2] = 0.0
        v[4] *= 1e38 / np.max(np.abs(v[4]))
    else:
        v[:, 1] = 0.0
        v[:, 3] *= 3e38 / np.max(np.abs(v[:, 3]))
    ws = split_words(v, nw)
    lj, ej = P.pl_extract(tuple(map(jnp.asarray, ws)), L, side + "3",
                          lg.LIMB_BITS)
    lt, et = K.limb_extract_plain(_t(ws), L, side)
    assert np.array_equal(np.asarray(lj), lt[0].numpy().astype(np.int32))
    assert np.array_equal(np.asarray(ej), et[0].numpy())
    assert int(np.max(np.abs(np.asarray(ej)))) > 126


@pytest.mark.parametrize("axis", [0, 1])
def test_host_precompute_equals_jax(axis):
    rng = np.random.default_rng(4 + axis)
    v = rng.standard_normal((9, 7)) * 10.0 ** rng.integers(-5, 5, (9, 7))
    v[3] = 0.0
    ws = split_words(v, 5)
    lj, ej = lg.host_precompute(ws, 5, axis=axis)
    lt, et = tg.host_precompute(ws, 5, axis=axis)
    assert lj.dtype == lt.dtype and ej.dtype == et.dtype
    assert np.array_equal(lj, lt) and np.array_equal(ej, et)


def test_batched_equals_per_item_loop():
    rng = np.random.default_rng(12)
    nw = 5
    items = [_operands(rng, 5, 6, 4, nw) for _ in range(3)]
    A = tuple(torch.stack([torch.from_numpy(it[0][w]) for it in items])
              for w in range(nw))
    B = tuple(torch.stack([torch.from_numpy(it[1][w]) for it in items])
              for w in range(nw))
    rb = tg.fx_matmul(A, B)
    for i, (a, b) in enumerate(items):
        ri = tg.fx_matmul(_t(a), _t(b))
        for cb, ci in zip(rb, ri):
            assert torch.equal(cb[i], ci[0])


def test_fx_matmul_rejects_inexact_depth():
    a = tuple(torch.zeros((1, 2, tg.MAX_K_EXACT + 1)) for _ in range(5))
    b = tuple(torch.zeros((1, tg.MAX_K_EXACT + 1, 2)) for _ in range(5))
    with pytest.raises(ValueError):
        tg.fx_matmul(a, b)


@pytest.mark.parametrize("side", ["a", "b"])
def test_extract_keeps_nan_as_jax_xla_route(side, xla_subnormals):
    """A NaN in word 0 of one row (side a) or column (side b): the plain
    extraction, which the CUDA kernel must match bit for bit, gives the
    exponents of the JAX XLA route (_row_exp_f32 + mul_pow2_f32 +
    _extract_limbs, Pallas off) and its limbs on the rows (columns) without
    a NaN. jnp.max and amax propagate the NaN, so its row (column) gets
    e = 130, not the exponent of the largest number beside it."""
    nw = 5
    L, _ = K.limb_params(nw)
    rng = np.random.default_rng(17)
    v = rng.standard_normal((4, 6)) * 10.0 ** rng.integers(-3, 3, (4, 6))
    ws = split_words(v, nw)
    ws[0] = ws[0].copy()
    ws[0][1, 2] = np.nan
    axis = 1 if side == "a" else 0
    ej = lg._row_exp_f32(jnp.asarray(ws[0]), axis=axis)
    scaled = tuple(lg.mul_pow2_f32(jnp.asarray(c), -ej) for c in ws)
    lj = np.asarray(lg._extract_limbs(scaled, L))
    ej = np.asarray(ej)
    lt, et = K.limb_extract_plain(_t(ws), L, side)
    lt, et = lt[0].numpy(), et[0].numpy()
    assert np.array_equal(ej, et)
    nan_group = 1 if side == "a" else 2
    assert et.ravel()[nan_group] == 130
    finite = np.abs(v).max(axis=axis)[nan_group]
    assert et.ravel()[nan_group] != int(np.frexp(np.float32(finite))[1]) + 1
    keep = np.arange(v.shape[1 - axis]) != nan_group
    if side == "a":
        assert np.array_equal(lj[:, keep], lt[:, keep].astype(lj.dtype))
    else:
        assert np.array_equal(lj[:, :, keep], lt[:, :, keep].astype(lj.dtype))


def test_limb_gemm_plain_exact_at_deepest_k(xla_subnormals, jax_xla_route):
    """limb_gemm_plain at k = 2^13 with every limb at +-65 (the largest
    diagonal sums the int32 accumulators must hold): its diagonal sums equal
    numpy's int64 ones, and its words equal the JAX XLA route's cascade of
    the same limbs (fx_matmul with pre_a and pre_b)."""
    nw, m, n, k = 5, 2, 2, tg.MAX_K_EXACT
    L, ndiag = K.limb_params(nw)
    rng = np.random.default_rng(5)
    la = (rng.integers(0, 2, (L, m, k)) * 130 - 65).astype(np.int8)
    lb = (rng.integers(0, 2, (L, k, n)) * 130 - 65).astype(np.int8)
    ea = np.array([[3], [-2]], np.int32)
    eb = np.array([[1, 4]], np.int32)
    prod = np.einsum("amk,bkn->abmn", la.astype(np.int64), lb.astype(np.int64))
    d64 = [sum(prod[ta, d - ta] for ta in range(max(0, d - L + 1),
                                                min(d, L - 1) + 1))
           for d in range(ndiag)]
    assert max(np.abs(d).max() for d in d64) < 2 ** 31
    a3, b3 = torch.from_numpy(la)[None], torch.from_numpy(lb)[None]
    C = K._int8_product(a3.reshape(1, L * m, k),
                        b3.permute(0, 2, 1, 3).reshape(1, k, L * n))
    for dt, dn in zip(K._diags_from_c(C, L, m, n, ndiag), d64):
        assert np.array_equal(dt[0].numpy(), dn)
    rj = jax.jit(lambda pa, pb: lg.fx_matmul(None, None, nw=nw, pre_a=pa,
                                             pre_b=pb))(
        (jnp.asarray(la), jnp.asarray(ea)), (jnp.asarray(lb), jnp.asarray(eb)))
    eab = torch.from_numpy(ea + eb)[None]
    _same(rj, tuple(c[0] for c in K.limb_gemm_plain(a3, b3, eab, nw)))


def test_limb_gemm_wrapper_rejects_inexact_depth():
    """The limb_gemm wrapper raises for k = 2^13 + 1 on a CPU tensor too,
    as int8_gemm does on the card, rather than sum inexactly; no plain
    version runs."""
    L, _ = K.limb_params(5)
    k = K.INT8_GEMM_MAX_K + 1
    K.reset_counts()
    with pytest.raises(ValueError):
        K.limb_gemm(torch.zeros((1, L, 2, k), dtype=torch.int8),
                    torch.zeros((1, L, k, 2), dtype=torch.int8),
                    torch.zeros((1, 2, 2), dtype=torch.int32), 5)
    assert K.counts()["limb_gemm_plain"] == 0
