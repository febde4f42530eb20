"""The step's expansion arithmetic as kernels (clrs_tpu_torch.dd.kernels
``ew_*`` and ``tree_sum``, csrc/expmap.cu), on the CPU.

- Each wrapper on CPU tensors runs its plain version: bit for bit the
  port's ``ops.exp_*`` and today's tree sum, and the JAX package's
  barrier-free forms (``clrs_tpu.dd.expops``, the forms its TPU step
  compiles, and ``clrs_tpu.dd.linalg.dd_sum`` over ``expops.exp_add``) on
  the same words, at nw 5 and 8 and at the shape classes one IPM iteration
  gives them: scalars, broadcasts, 5-D, transposed views and numel 0. The
  tolerance is bit identity (the same IEEE f32 op sequence; the port in
  XLA:CPU's subnormal flush mode).
- The host-side launch arguments the CUDA route builds are emulated at the
  index level, as the kernels read and write memory: expmap's broadcast
  shape, coalesced dims and per-word strides select the elements PyTorch
  broadcasting selects; tree_sum's level plan, its in-place levels (in a
  shuffled order) and its scratch buffer reproduce dd_sum's pairing for
  n = 0..300 on both routes.
- A delsarte(3,3) eager step sends every f32 dd_add/sub/mul/div/neg/sum/
  symmetrize through a wrapper and its state is what the plain ops give.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clrs_tpu_torch as ct
from clrs_tpu.dd import expops as E
from clrs_tpu.dd import linalg as JL
from clrs_tpu_torch.dd import kernels as K
from clrs_tpu_torch.dd import linalg as TL
from clrs_tpu_torch.dd import ops as O
from clrs_tpu_torch.solver import step as TS
from torch_helpers import (delsarte, emulate_tree_launch,  # noqa: F401
                           index_offsets, raw_memory, state_words,
                           unfused_forms, xla_subnormals)

NWS = (5, 8)
# (x shape, y shape, transposed): the classes of a delsarte(3,10) iteration
# (recorded on the way to the wrappers), and the edges
SHAPES = {
    "scalar": ((), (), False),
    "row_by_scalar": ((1, 21), (), False),
    "col_bcast": ((2, 22, 1), (2, 22, 11), False),
    "row_bcast": ((1, 21, 22), (1, 21, 1), False),
    "five_d": ((2, 22, 1, 22, 1), (2, 22, 1, 22, 1), False),
    "transposed": ((2, 11, 11), (2, 11, 11), True),
    "empty": ((2, 0, 5), (1, 5), False),
}


def _words(rng, shape, nw, transposed=False):
    """nw f32 words: word 0 over 16 decades, word k about 2^-24k of it,
    some elements exact zeros; a transposed view of contiguous words when
    asked."""
    full = shape[:-2] + shape[:-3:-1] if transposed else shape
    w0 = rng.standard_normal(full) * 10.0 ** rng.integers(-8, 8, full)
    ws = [w0.astype(np.float32)]
    for k in range(1, nw):
        ws.append((w0 * rng.standard_normal(full) * 2.0 ** (-24 * k))
                  .astype(np.float32))
    if ws[0].size > 3:
        for w in ws:
            w.reshape(-1)[:2] = 0.0
    if transposed:
        return [np.swapaxes(w, -1, -2) for w in ws]
    return ws


def _t(ws):
    """Torch views of the same memory (transposed views stay so)."""
    return tuple(torch.from_numpy(np.asarray(w)) for w in ws)


def _j(ws):
    return tuple(jnp.asarray(w) for w in ws)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.shape == y.shape, (x.shape, y.shape)
        assert np.array_equal(x.view(np.int32), y.astype(np.float32)
                              .view(np.int32))


@pytest.mark.parametrize("cls", list(SHAPES))
@pytest.mark.parametrize("nw", NWS)
def test_ew_ops_bit_identical(nw, cls, xla_subnormals):
    xs, ys, tr = SHAPES[cls]
    rng = np.random.default_rng(nw * 31 + len(cls))
    x, y = _words(rng, xs, nw, tr), _words(rng, ys, nw, tr)
    y[0] = np.where(y[0] == 0, np.float32(1.5), y[0])    # divisor nonzero
    tx, ty = _t(x), _t(y)
    if tr:
        assert not tx[0].is_contiguous()
    jx, jy = _j(x), _j(y)
    K.reset_counts()
    for wrap, plain, jax_op in ((K.ew_add, O.exp_add, E.exp_add),
                                (K.ew_sub, O.exp_sub, E.exp_sub),
                                (K.ew_mul, O.exp_mul, E.exp_mul),
                                (K.ew_div, O.exp_div, E.exp_div)):
        got = wrap(tx, ty)
        _same(plain(tx, ty), got)
        _same(jax_op(jx, jy), got)
    got = K.ew_neg(tx)
    _same(O.exp_neg(tx), got)
    _same(E.exp_neg(jx), got)
    c = K.counts()
    assert all(c[f"ew_{op}_plain"] == 1
               for op in ("add", "sub", "mul", "div", "neg"))
    assert all(c[f"ew_{op}"] == 0
               for op in ("add", "sub", "mul", "div", "neg"))


@pytest.mark.parametrize("shape,tr", [((2, 11, 11), False),
                                      ((2, 22, 22), True),
                                      ((1, 1, 1), False),
                                      ((0, 4, 4), False)])
@pytest.mark.parametrize("nw", NWS)
def test_symmetrize_bit_identical(nw, shape, tr, xla_subnormals):
    x = _words(np.random.default_rng(nw + shape[-1]), shape, nw, tr)
    tx, jx = _t(x), _j(x)
    got = K.ew_symmetrize(tx)
    s = O.exp_add(tx, tuple(c.transpose(-1, -2) for c in tx))
    _same(tuple(0.5 * c for c in s), got)
    s = E.exp_add(jx, tuple(jnp.swapaxes(c, -1, -2) for c in jx))
    _same(tuple(c * np.float32(0.5) for c in s), got)
    _same(TL.dd_symmetrize(tx), got)


# (shape, axis) of the tree sums of a delsarte(3,10) iteration, and edges:
# n 0, no columns, odd n, a negative axis, a transposed input
TREES = [((1, 2, 22), 1), ((2, 22, 11), 2), ((242,), 0), ((2, 22, 22, 1), 3),
         ((21,), 0), ((1, 1, 1), 0), ((0, 4), 0), ((3, 0), 0),
         ((13, 4), 0), ((2, 5, 7, 3), -2), ((6, 9), 1)]


@pytest.mark.parametrize("shape,axis", TREES)
@pytest.mark.parametrize("nw", NWS)
def test_tree_sum_bit_identical(nw, shape, axis, monkeypatch, xla_subnormals):
    x = _words(np.random.default_rng(7 * nw + len(shape)), shape, nw,
               transposed=shape == (6, 9))
    tx = _t(x)
    got = K.tree_sum(tx, axis)
    _same(K.pairwise_sum(tx, axis, O.exp_add), got)
    _same(TL.dd_sum(tx, axis), got)
    monkeypatch.setattr(JL, "dd_add", E.exp_add)      # the TPU step's add
    _same(JL.dd_sum(_j(x), axis), got)


# ---------------------------------------------------------------------------
# the CUDA route's launch arguments, emulated on CPU tensors
# ---------------------------------------------------------------------------

def _unpack_dims(dims, nd):
    return tuple(dims[:nd])


def _unpack_strides(strides, slot, nd):
    base = (slot + 1) * K.EW_MAX_DIMS - nd
    return tuple(strides[base:base + nd])


def _gather(ptrs, strides, slot0, nw, dims):
    out = []
    for k in range(nw):
        st = _unpack_strides(strides, slot0 + k, len(dims))
        off = index_offsets(dims, st)
        out.append(torch.from_numpy(raw_memory(ptrs[slot0 + k], off)[off]
                                    .copy()))
    return tuple(out)


EMU = [((1, 21), (), False), ((2, 22, 1), (2, 22, 11), False),
       ((1, 21, 22), (1, 21, 1), False), ((2, 22, 1, 22, 1), (22, 1), False),
       ((3, 9, 9), (3, 9, 9), True), ((2, 1, 3, 1, 2, 2, 2, 2), (2, 2), False),
       ((4, 1, 5), (3, 1), False), ((), (), False)]


@pytest.mark.parametrize("xs,ys,tr", EMU)
def test_expmap_launch_args_select_broadcast_elements(xs, ys, tr):
    nw = 5
    rng = np.random.default_rng(3)
    x, y = _t(_words(rng, xs, nw, tr)), _t(_words(rng, ys, nw))
    if tr:            # the second operand a transposed view as well
        y = tuple(c.transpose(-1, -2) for c in y)
    shape, numel, ptrs, strides, shared, dims, nd = K.ew_pack([x, y])
    assert shape == tuple(torch.broadcast_shapes(xs, ys))
    assert nd <= K.EW_MAX_DIMS
    d = _unpack_dims(dims, nd)
    assert int(np.prod(d)) == numel
    gx = _gather(ptrs, strides, 0, nw, d)
    gy = _gather(ptrs, strides, K._MAX_NW, nw, d)
    for g, op in ((gx, x), (gy, y)):
        for gw, c in zip(g, op):
            assert torch.equal(gw, c.expand(shape).reshape(-1))
    want = O.exp_mul(x, y)
    got = O.exp_mul(gx, gy)
    _same(tuple(c.reshape(-1) for c in want), got)
    for k, op in enumerate((x, y)):
        st = [_unpack_strides(strides, k * K._MAX_NW + w, nd)
              for w in range(nw)]
        assert shared[k] == int(all(s == st[0] for s in st))


def test_expmap_refuses_shapes_beyond_six_dims():
    # seven dims of 2 cut from dims of 3: no two neighbours merge
    x = tuple(torch.zeros((3,) * 7)[(slice(0, 2),) * 7] for _ in range(5))
    y = x
    with pytest.raises(ValueError, match="dims"):
        K.ew_pack([x, y])


@pytest.mark.parametrize("route", ["shared", "levels"])
def test_tree_sum_plan_reproduces_pairing(route):
    """Every n in 0..300 over 3 columns (a strided, transposed input): the
    launches that tree_sum builds, emulated, equal dd_sum's tree bit for
    bit. "levels" forces the level route with a shared-memory budget below
    one column's level-1 entries and no cluster."""
    nw = 5
    rng = np.random.default_rng(5)
    for n in range(301):
        x = tuple(torch.from_numpy(w).transpose(0, 1)
                  for w in _words(rng, (3, n), nw))      # [n, 3], strided
        if route == "shared":
            smem, cluster = K.TREE_SMEM, K.TREE_CLUSTER
        else:
            smem, cluster = 4 * nw * ((n + 1) // 2) - 1, 1
        plan = K.tree_sum_plan(n, nw, 3, smem, cluster)
        assert plan[0] == (route if n > 1 else "shared")
        out, launches = K.tree_sum_launches(x, 0, smem=smem, cluster=cluster)
        if plan[0] == "levels":
            assert [ln.n for ln in launches] == list(plan[1])
            assert launches[-1].dst.data_ptr() == out[0].data_ptr()
        else:
            assert len(launches) == 1 and launches[0].C == plan[1]
        for ln in launches:
            emulate_tree_launch(ln, nw, rng)
        _same(K.pairwise_sum(x, 0, O.exp_add), out)


def test_tree_sum_plan_columns_fill_a_block():
    assert K.tree_sum_plan(2, 5, 36864) == ("shared", K.TREE_THREADS)
    assert K.tree_sum_plan(22, 5, 1000) == ("shared", 23)  # 11 entries each
    assert K.tree_sum_plan(242, 8, 1) == ("shared", 1)
    assert K.tree_sum_plan(0, 5, 7) == ("shared", 7)
    # first level on load: 12000 entries keep 6000 (120 KB), spread over
    # a cluster of ceil(6000 / TREE_SPREAD) blocks; the level route only
    # past a full cluster's shared memory
    assert K.tree_sum_plan(12000, 5, 1) == ("cluster", 6)
    route, levels = K.tree_sum_plan(400000, 5, 1)
    assert route == "levels" and levels[0] == 400000 and levels[-1] == 2
    for n in range(1, 400):
        route, C = K.tree_sum_plan(n, 8, 10 ** 6)
        assert 4 * 8 * n * C <= K.TREE_SMEM


# ---------------------------------------------------------------------------
# the step goes through the wrappers
# ---------------------------------------------------------------------------

def test_step_routes_expansion_ops_through_wrappers(monkeypatch):
    """A delsarte(3,3) eager step on the CPU calls every f32 expansion op
    through a wrapper (plain counters > 0; every tree sum of a one-process
    step is a fused one), and its state is bit for bit the state of the
    same step with the wrappers' plain ops called directly (the arithmetic
    before the wrappers; the fused forms as their compositions)."""
    sdp = ct.ClusteredLowRankSDP(delsarte(ct, 3))
    ds = TS.DeviceSDP(sdp, nw=5, device="cpu")
    kw = dict(gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
              dual_error_threshold=1e-12, primal_error_threshold=1e-12)
    step = TS.make_step_body(ds, **kw)
    K.reset_counts()
    s1, info1 = step(TS.initial_state(ds, 100.0, 100.0), False)
    c = K.counts()
    names = ("ew_add", "ew_sub", "ew_mul", "ew_div", "ew_neg",
             "ew_symmetrize", "tree_sum_fused")
    for name in names:
        assert c[name + "_plain"] > 0, name
        assert c[name] == 0, name
    # the same step with the wrappers bypassed: the plain ops called as
    # before the wrappers existed
    for name, fn in (("ew_add", O.exp_add), ("ew_sub", O.exp_sub),
                     ("ew_mul", O.exp_mul), ("ew_div", O.exp_div),
                     ("ew_neg", O.exp_neg)):
        monkeypatch.setattr(K, name, fn)
    monkeypatch.setattr(K, "ew_symmetrize", lambda x: tuple(
        0.5 * c for c in O.exp_add(x, TL.dd_transpose(x))))
    monkeypatch.setattr(K, "tree_sum",
                        lambda x, a: K.pairwise_sum(x, a, O.exp_add))
    # the fused forms as the compositions of the same plain ops
    for name, fn in unfused_forms().items():
        monkeypatch.setattr(K, name, fn)
    K.reset_counts()
    s2, info2 = TS.make_step_body(ds, **kw)(
        TS.initial_state(ds, 100.0, 100.0), False)
    assert all(v == 0 for k, v in K.counts().items()
               if k.startswith(("ew_", "tree_sum")))
    w1, w2 = state_words(s1), state_words(s2)
    assert len(w1) == len(w2) > 0
    for a, b in zip(w1, w2):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    for k in ("mu", "alpha_d", "alpha_p", "d_obj", "p_obj"):
        assert torch.equal(torch.as_tensor(info1[k]),
                           torch.as_tensor(info2[k]))
