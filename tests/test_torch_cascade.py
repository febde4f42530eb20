"""The split GEMM route of the port (limb extraction in the GEMM layouts,
the int8 product, the cascade from C) and its cascade kernels' plain
versions against the JAX package's Pallas route, on the CPU.

The JAX side runs its Pallas kernels in the interpreter with the routes
forced on (``_USE_PLCASCADE = _USE_PLEXTRACT = True``), unbatched and at
the small shapes its own interpreter tests use (tests/test_plmap.py:120-
273); the grid-tiled cascade is called directly, with small tiles.
Everything is exact integer and IEEE f32 arithmetic on both sides, so the
tolerance is bit identity, with the port in XLA:CPU's subnormal flush
mode (tests/test_torch_ops.py).
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
def jax_split_route():
    """The JAX fx_matmul on its TPU split route: pl_extract 'a'/'b', the
    int8 dot_general, then pl_cascade_tiles (or _grid above the budget)."""
    olds = (lg._USE_PLCASCADE, lg._USE_PLEXTRACT, lg._USE_PLFUSED,
            lg._PLCASCADE_C_BUDGET)
    try:
        lg._USE_PLCASCADE = lg._USE_PLEXTRACT = True
        lg._USE_PLFUSED = False
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


def _t(ws):
    return tuple(torch.from_numpy(np.array(w))[None] for w in ws)


def _pre(ws, nw, axis):
    lb, eb = tg.host_precompute(ws, nw, axis=axis)
    return torch.from_numpy(lb)[None], torch.from_numpy(eb)[None]


def _same(rj, rt):
    assert len(rj) == len(rt)
    for a, b in zip(rj, rt):
        a = np.asarray(a)
        b = b.numpy()
        assert a.shape == b.shape, (a.shape, b.shape)
        assert np.array_equal(a, b), np.max(np.abs(a.astype(np.float64)
                                                   - b.astype(np.float64)))


def _jax_fx(A, B, pre_b=None):
    if pre_b is None:
        return jax.jit(lambda a, b: lg.fx_matmul(a, b))(
            tuple(map(jnp.asarray, A)), tuple(map(jnp.asarray, B)))
    pj = (jnp.asarray(pre_b[0][0].numpy()), jnp.asarray(pre_b[1][0].numpy()))
    return jax.jit(lambda a: lg.fx_matmul(a, None, nw=len(A), pre_b=pj))(
        tuple(map(jnp.asarray, A)))


def test_split_route_bit_identical_to_jax_pallas_route(xla_subnormals,
                                                       jax_split_route):
    """The port's split route against the JAX route through pl_extract 'a'/
    'b', the int8 dot_general and pl_cascade_tiles (C within the budget),
    with runtime and host-precomputed right operands."""
    nw = 5
    m, k, n = 7, 9, 5
    assert tg.gemm_route(m, k, n, nw) == "split"
    rng = np.random.default_rng(21)
    A, B = _operands(rng, m, k, n, nw)
    K.reset_counts()
    rt = tg.fx_matmul(_t(A), _t(B))
    assert K.counts()["cascade_from_c_plain"] == 1
    assert K.counts()["limb_gemm_plain"] == 0
    _same(_jax_fx(A, B), tuple(c[0] for c in rt))
    # a host-precomputed right operand (limb-major -> [k, L n] copy)
    pre = _pre(B, nw, axis=0)
    rp = tg.fx_matmul(_t(A), None, nw=nw, pre_b=pre)
    _same(_jax_fx(A, B, pre_b=pre), tuple(c[0] for c in rp))


def _grid_case(nw, m, k, n, seed):
    """The plain cascade from C against the grid-tiled kernel
    (_cascade_tiles_grid_call, interpreter) on the int8 product of real
    limbs, with (m, n) padded up to its smallest (8, 8) output tiles."""
    tm, tn = 8, 8
    L, ndiag = K.limb_params(nw)
    rng = np.random.default_rng(seed)
    A, B = _operands(rng, m, k, n, nw)
    A2, ea = K.limb_extract_plain(_t(A), L, "a", layout="gemm")
    B2, eb = K.limb_extract_plain(_t(B), L, "b", layout="gemm")
    C = K.int8_gemm_plain(A2, B2)                       # [1, L m, L n]
    eab = (ea + eb).expand(1, m, n).contiguous()
    Mp, Np = -(-m // tm) * tm, -(-n // tn) * tn
    C4 = np.pad(C[0].numpy().reshape(L, m, L, n),
                ((0, 0), (0, Mp - m), (0, 0), (0, Np - n)))
    e2 = np.pad(eab[0].numpy(), ((0, Mp - m), (0, Np - n)))
    out = P._cascade_tiles_grid_call(nw, L, ndiag, Mp, Np, tm, tn,
                                     lg.LIMB_BITS)(jnp.asarray(C4),
                                                   jnp.asarray(e2)[None])
    rj = tuple(out[0, w, :m, :n] for w in range(nw))
    _same(rj, tuple(c[0] for c in K.cascade_from_c_plain(C, eab, nw)))


def test_cascade_from_c_bit_identical_to_grid_kernel(xla_subnormals):
    """The grid-tiled kernel at nw = 1 (7 limbs, 7 kept diagonals) on a
    2 x 2 grid of tiles."""
    _grid_case(1, 9, 6, 10, 23)


def test_cascade_from_c_bit_identical_to_grid_kernel_nw5(xla_subnormals):
    """The grid-tiled kernel at nw = 5, the port's default (21 limbs, 21
    kept diagonals), on one padded tile: the interpreter's compile time and
    memory grow steeply with the tiles of the grid at this limb count, and
    the grid route through the JAX fx_matmul, which pins its tiles at
    (8, 128), takes longer than a test may on the CPU. So the kernel is
    called directly; the whole-C route through fx_matmul is the first test
    of this file."""
    _grid_case(5, 7, 6, 6, 31)


@pytest.mark.parametrize("side", ["a", "b"])
def test_gemm_layout_extract_bit_identical_to_pl_extract(side,
                                                         xla_subnormals):
    """The plain extraction in the GEMM layouts equals pl_extract 'a'
    ([L d0, d1]) and 'b' ([d0, L d1]) on limbs and exponents."""
    nw = 5
    L, _ = K.limb_params(nw)
    rng = np.random.default_rng(13)
    v = rng.standard_normal((6, 5)) * 10.0 ** rng.integers(-8, 8, (6, 5))
    v[:, 1] = 0.0
    v[2] = 0.0
    ws = split_words(v, nw)
    lj, ej = P.pl_extract(tuple(map(jnp.asarray, ws)), L, side, lg.LIMB_BITS)
    lt, et = K.limb_extract_plain(_t(ws), L, side, layout="gemm")
    assert lt.dtype == torch.int8
    assert np.array_equal(np.asarray(lj), lt[0].numpy().astype(np.int32))
    assert np.array_equal(np.asarray(ej), et[0].numpy())


def test_diags_cascade_bit_identical_to_pl_cascade(xla_subnormals):
    """The plain FROM_DIAGS cascade against pl_cascade (interpreter) on
    diagonal sums and exponents of a real product, and on random int32
    sums over the whole range that the diagonal sums of this product can
    take."""
    nw = 5
    L, ndiag = K.limb_params(nw)
    m, k, n = 6, 7, 4
    rng = np.random.default_rng(17)
    A, B = _operands(rng, m, k, n, nw)
    A2, ea = K.limb_extract_plain(_t(A), L, "a", layout="gemm")
    B2, eb = K.limb_extract_plain(_t(B), L, "b", layout="gemm")
    C = K.int8_gemm_plain(A2, B2)
    real = torch.stack(K._diags_from_c(C, L, m, n, ndiag), dim=1)
    bound = L * k * 65 * 65                   # |diagonal sum| of this product
    rand = torch.from_numpy(rng.integers(-bound, bound, (1, ndiag, m, n))
                            .astype(np.int32))
    eab = (ea + eb).expand(1, m, n).contiguous()
    for diags in (real, rand):
        rj = P.pl_cascade(jnp.asarray(diags[0].numpy()),
                          jnp.asarray(eab[0].numpy()), nw, lg.LIMB_BITS)
        rt = K.cascade_from_diags_plain(diags, eab, nw)
        _same(rj, tuple(c[0] for c in rt))


@pytest.mark.parametrize("nw", [5, 8])
def test_split_route_equals_fused_route(nw):
    """Inside the port, the split and fused routes give the same words:
    batched, ragged, with runtime and host-precomputed operands."""
    rng = np.random.default_rng(40 + nw)
    Bt, m, k, n = 3, 6, 11, 9
    a = tuple(torch.from_numpy(w) for w in split_words(
        rng.standard_normal((Bt, m, k))
        * 10.0 ** rng.integers(-6, 6, (Bt, m, k)), nw))
    b = tuple(torch.from_numpy(w) for w in split_words(
        rng.standard_normal((Bt, k, n)), nw))
    for route in ("split", "fused"):
        K.reset_counts()
        tg.fx_matmul(a, b, route=route)
        kernel = "cascade_from_c_plain" if route == "split" \
            else "limb_gemm_plain"
        assert K.counts()[kernel] == 1
    rs = tg.fx_matmul(a, b, route="split")
    rf = tg.fx_matmul(a, b, route="fused")
    assert all(torch.equal(x, y) for x, y in zip(rs, rf))
    pa = [tg.host_precompute([w[i].numpy() for w in a], nw, axis=1)
          for i in range(Bt)]
    pre_a = (torch.from_numpy(np.stack([p[0] for p in pa])),
             torch.from_numpy(np.stack([p[1] for p in pa])))
    ps = tg.fx_matmul(None, b, nw=nw, pre_a=pre_a, route="split")
    pf = tg.fx_matmul(None, b, nw=nw, pre_a=pre_a, route="fused")
    assert all(torch.equal(x, y) for x, y in zip(ps, pf))
    assert all(torch.equal(x, y) for x, y in zip(ps, rs))


@pytest.mark.parametrize("nw", [5, 8])
def test_gemm_route_reproduces_jax_routing(nw):
    """gemm_route takes the fused route exactly where clrs_tpu's fx_matmul
    does on the TPU: C above 6 MiB and a fused tiling that exists."""
    L, _ = K.limb_params(nw)
    seen = set()
    for m in (1, 7, 22, 64, 96, 192, 400):
        for n in (1, 22, 96, 130, 192):
            for k in (1, 22, 96, 1000, 8192):
                fused = ((L * m) * (L * n) * 4 > lg._PLCASCADE_C_BUDGET
                         and P._fused_tile_sizes(
                             m, n, L, k, lg._PLCASCADE_C_BUDGET) is not None)
                route = tg.gemm_route(m, k, n, nw)
                assert route == ("fused" if fused else "split"), (m, k, n)
                seen.add(route)
    assert seen == {"fused", "split"}
    assert tg.JAX_ROUTE_C_BYTES == lg._PLCASCADE_C_BUDGET


def test_int8_product_exact_at_deepest_k_with_extreme_limbs():
    """The plain int8 product, the reference the card's tensor-core kernel
    is held to, is exact at the deepest K the split route allows (2^13)
    with every limb at +-65, where |C| reaches its bound 2^13 65^2: it
    equals numpy's int64 product and the JAX split route's int8
    dot_general (clrs_tpu/dd/limb_gemm.py:307) on the same limbs."""
    k = K.INT8_GEMM_MAX_K
    assert k == tg.MAX_K_EXACT
    rng = np.random.default_rng(51)
    a = (rng.integers(0, 2, (1, 6, k)) * 130 - 65).astype(np.int8)
    b = (rng.integers(0, 2, (1, k, 5)) * 130 - 65).astype(np.int8)
    a[0, 0] = 65                                  # |C| at its bound
    b[0, :, 0] = 65
    b[0, :, 1] = -65
    ref = np.einsum("bmk,bkn->bmn", a.astype(np.int64), b.astype(np.int64))
    assert ref[0, 0, 0] == k * 65 * 65 and ref[0, 0, 1] == -k * 65 * 65
    c = K.int8_gemm_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert c.dtype == torch.int32
    assert np.array_equal(c.numpy().astype(np.int64), ref)
    cj = jax.lax.dot_general(jnp.asarray(a[0]), jnp.asarray(b[0]),
                             (((1,), (0,)), ((), ())),
                             preferred_element_type=jnp.int32)
    assert np.array_equal(np.asarray(cj), c[0].numpy())
