"""The step's fused expansion kernels (clrs_tpu_torch.dd.kernels
``tree_sum_fused``, ``ew_fma``/``ew_fms``/``ew_msub``/``ew_mms``/
``ew_sub2`` and ``ew_select``; csrc/exptree.cu and csrc/expfuse.cu), on the
CPU.

- Each fused form's plain version equals the composition of today's plain
  ops (``ops.exp_*``, ``pairwise_sum``, PyTorch word scales) and the JAX
  package's composition of its barrier-free forms (``clrs_tpu.dd.expops``,
  and ``clrs_tpu.dd.linalg.dd_sum`` over ``expops.exp_add``) on the same
  seeded numpy words, at nw 5 and 8 and at the shape classes of
  tests/test_torch_expmap.py. The tolerance is bit identity (the same IEEE
  f32 op sequence; the port in XLA:CPU's subnormal flush mode).
- The host-side launch arguments are emulated at the index level, as the
  kernels read and write memory: expfuse's 3- and 4-operand views with a
  scale and a mask over a broadcast shape; tree_sum<NW, PRO>'s plan with
  the first level on load, the block, cluster (sizes 2..8, forced by small
  shared-memory budgets) and level routes, the product, scale and
  accumulate, reproduce dd_sum's pairing for n = 0..300, 18,432 and
  32,768.
- An eager delsarte(3,3) chunk iteration sends the census's product-sum
  sites and the commit through the fused wrappers, and its state is word
  for word the state of the same iteration with each fused form computed
  by the unfused wrappers it replaces.
- f64 words take the front ends' compositions, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clrs_tpu_torch as ct
from clrs_tpu.dd import expops as E
from clrs_tpu.dd import linalg as JL
from clrs_tpu_torch.dd import arith as TA
from clrs_tpu_torch.dd import f64ops as F
from clrs_tpu_torch.dd import kernels as K
from clrs_tpu_torch.dd import linalg as TL
from clrs_tpu_torch.dd import ops as O
from clrs_tpu_torch.solver import step as TS
from clrs_tpu_torch.solver.ipm import _to_host
from torch_helpers import (delsarte, emulate_fuse_launch,  # noqa: F401
                           emulate_tree_launch, state_words, unfused_forms,
                           xla_subnormals)

NWS = (5, 8)
# operand shapes of each class (the last operand's shape repeats), and the
# mask's: the classes of tests/test_torch_expmap.py's SHAPES that the step's
# fused sites give the forms (scalars, a row by a scalar, broadcasts, 5-D,
# transposed, empty)
SHAPES = {
    "scalar": ((), (), (), None),
    "row_by_scalar": ((1, 21), (), (1, 21), (1, 21)),
    "col_bcast": ((2, 22, 1), (2, 22, 11), (2, 22, 11), (2, 22, 11)),
    "row_bcast": ((1, 21, 22), (1, 21, 1), (1, 21, 22), (1, 21, 22)),
    "five_d": ((2, 22, 1, 22, 1),) * 3 + ((2, 22, 1, 22, 1),),
    "transposed": ((2, 11, 11),) * 3 + ((2, 11, 11),),
    "empty": ((2, 0, 5), (1, 5), (2, 0, 5), None),
}
FORMS = {"fma": 3, "fms": 3, "msub": 3, "mms": 4, "sub2": 3}


def _words(rng, shape, nw, transposed=False):
    """nw f32 words: word 0 over 16 decades, word k about 2^-24k of it,
    some exact zeros; a transposed view of contiguous words when asked."""
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


def _mask(rng, shape):
    return np.asarray(rng.integers(0, 2, shape) * 1.0, np.float32)


def _t(ws):
    return tuple(torch.from_numpy(np.asarray(w)) for w in ws)


def _j(ws):
    return tuple(jnp.asarray(w) for w in ws)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.shape == y.shape, (x.shape, y.shape)
        assert np.array_equal(x.astype(np.float32).view(np.int32),
                              y.astype(np.float32).view(np.int32))


def _compose(mod, form, ops, scale=None, mask=None):
    """The form as the composition of ``mod``'s exp_add/exp_sub/exp_mul
    (the port's ops or the JAX package's expops) and word scales."""
    a = list(ops)
    if scale is not None:
        a[2] = tuple(c * scale for c in a[2])
    r = {"fma": lambda: mod.exp_add(a[0], mod.exp_mul(a[1], a[2])),
         "fms": lambda: mod.exp_sub(a[0], mod.exp_mul(a[1], a[2])),
         "msub": lambda: mod.exp_sub(mod.exp_mul(a[0], a[1]), a[2]),
         "mms": lambda: mod.exp_sub(mod.exp_mul(a[0], a[1]),
                                    mod.exp_mul(a[2], a[3])),
         "sub2": lambda: mod.exp_sub(mod.exp_sub(a[0], a[1]), a[2])}[form]()
    return r if mask is None else tuple(c * mask for c in r)


def _call(form, ops, scale=None, mask=None):
    fn = getattr(K, f"ew_{form}")
    if form == "sub2":
        return fn(*ops, scale, mask)
    return fn(*ops, mask=mask)


@pytest.mark.parametrize("cls", list(SHAPES))
@pytest.mark.parametrize("nw", NWS)
def test_fused_forms_bit_identical(nw, cls, xla_subnormals):
    *shapes, mshape = SHAPES[cls]
    tr = cls == "transposed"
    rng = np.random.default_rng(nw * 17 + len(cls))
    for form, nops in FORMS.items():
        sh = (shapes + [shapes[-1]])[:nops]
        ws = [_words(rng, s, nw, tr) for s in sh]
        ops, jops = [_t(w) for w in ws], [_j(w) for w in ws]
        for mask in (None, mshape):
            m = None if mask is None else _mask(rng, mask)
            tm = None if m is None else torch.from_numpy(m)
            sc = (-1.0, None) if form == "sub2" else (None,)
            for scale in sc:
                K.reset_counts()
                got = _call(form, ops, scale, tm)
                assert K.counts()[f"ew_{form}_plain"] == 1
                assert K.counts()[f"ew_{form}"] == 0
                _same(_compose(O, form, ops, scale, tm), got)
                _same(_compose(E, form, jops, scale,
                               None if m is None else jnp.asarray(m)), got)
                _same(getattr(TA, f"dd_{form}")(
                    *ops, *((scale,) if form == "sub2" else ()), mask=tm),
                    got)


# (x shape, y shape or None, axis, acc shape or None, scale on, scale shape):
# the step's sites (the (3,10) classes: lam [2, 2, 11] viewed [J, P, Lc,
# T]; the Hadamard [L, PT, n] rows; the objectives' flat dots; the dy sum;
# the pairs' [L, P, P, T, T]), and edges
TREES = [
    ((1, 22, 2, 11), (1, 22, 2, 11), (2, 3), (1, 22), None, None),
    ((1, 22, 2, 11), (1, 22, 2, 11), (2, 3), (1, 22), "product",
     (1, 22, 2, 11)),
    ((2, 22, 11), (2, 22, 11), 2, None, None, None),
    ((2, 11, 11), (2, 11, 11), None, (), "x", (2, 11, 11)),
    ((21,), (21,), None, (), None, None),
    ((1, 21, 1), None, 0, (21, 1), None, None),
    ((2, 2, 2, 11, 11), (2, 2, 2, 11, 11), (3, 4), None, None, None),
    ((1, 2, 2, 2), None, 1, (1, 2, 2), None, None),
    ((2, 0, 3), (2, 0, 3), 1, (2, 3), None, None),
    ((1, 1, 1), (1, 1, 1), None, (), "x", (1, 1, 1)),
    ((5, 3), (1, 3), 0, (3,), "x", (5, 1)),
]


def _jax_tree(x, y, axis, acc, sub, scale, scale_on):
    if scale_on == "x":
        x = tuple(c * scale for c in x)
    p = E.exp_mul(x, y) if y is not None else x
    if scale_on == "product":
        p = tuple(c * scale for c in p)
    shape = np.broadcast_shapes(*(c.shape for c in p))
    p = tuple(jnp.broadcast_to(c, shape) for c in p)
    if not isinstance(axis, int):
        a0, a1 = K.sum_axes(axis, len(shape)) if shape else (0, 0)
        p = tuple(jnp.moveaxis(c, tuple(range(a0, a1)),
                               tuple(range(len(shape) - (a1 - a0),
                                           len(shape))))
                  .reshape(shape[:a0] + shape[a1:] + (-1,)) for c in p)
        axis = -1
    s = JL.dd_sum(p, axis)
    if acc is None:
        return s
    return E.exp_sub(acc, s) if sub else E.exp_add(acc, s)


@pytest.mark.parametrize("case", range(len(TREES)))
@pytest.mark.parametrize("nw", NWS)
def test_tree_sum_fused_bit_identical(nw, case, monkeypatch, xla_subnormals):
    xs, ys, axis, accs, son, scs = TREES[case]
    rng = np.random.default_rng(100 * nw + case)
    x = _words(rng, xs, nw)
    y = None if ys is None else _words(rng, ys, nw)
    acc = None if accs is None else _words(rng, accs, nw)
    sc = None if scs is None else _mask(rng, scs)
    monkeypatch.setattr(JL, "dd_add", E.exp_add)      # the TPU step's add
    for sub in (False, True):
        tx, ty = _t(x), None if y is None else _t(y)
        tacc = None if acc is None else _t(acc)
        tsc = None if sc is None else torch.from_numpy(sc)
        K.reset_counts()
        got = K.tree_sum_fused(tx, ty, axis, tacc, sub, tsc, son)
        assert K.counts()["tree_sum_fused_plain"] == 1
        _same(unfused_forms()["tree_sum_fused"](tx, ty, axis, tacc, sub, tsc,
                                                 son), got)
        _same(_jax_tree(_j(x), None if y is None else _j(y), axis,
                        None if acc is None else _j(acc), sub,
                        None if sc is None else jnp.asarray(sc), son), got)
        _same(TL.dd_sum_prod(tx, ty, axis, tacc, sub, tsc,
                             son or "x"), got)


# ---------------------------------------------------------------------------
# the CUDA route's launch arguments, emulated on CPU tensors
# ---------------------------------------------------------------------------

EMU = [((2, 22, 1), (2, 22, 11), (1, 22, 11), (2, 1, 11), (2, 22, 11)),
       ((1, 21), (), (21,), (1, 1), (1, 21)),
       ((3, 9, 9), (3, 9, 9), (3, 9, 9), (3, 9, 9), (1, 9, 9)),
       ((2, 1, 3, 1, 2), (2, 2, 3, 1, 2), (1, 3, 2, 2), (2, 1, 1, 1, 2),
        (2, 2, 3, 2, 2)),
       ((), (), (), (), ())]


@pytest.mark.parametrize("case", range(len(EMU)))
@pytest.mark.parametrize("form", list(FORMS))
def test_expfuse_launch_args_emulated(form, case):
    """ew_fuse_pack's pointers and strides (3 and 4 operands, transposed
    and broadcast views, a scale tensor or constant on one operand, a
    mask), gathered as csrc/expfuse.cu does, give the plain version's
    words."""
    nw, nops = 5, FORMS[form]
    rng = np.random.default_rng(7 + case)
    sh = EMU[case]
    ops = [_t(_words(rng, s, nw, transposed=case == 2 and j == 1))
           for j, s in enumerate(sh[:nops])]
    mask = torch.from_numpy(_mask(rng, sh[4]))
    for scale in (None, 0.5, torch.from_numpy(np.asarray(_mask(rng, sh[0]) * 2))):
        sc_op = -1 if scale is None else nops - 1
        pack = K.ew_fuse_pack(ops, scale, sc_op, mask)
        got = emulate_fuse_launch(pack, form, nops, nw, scale, sc_op, mask)
        a = list(ops)
        if scale is not None:
            a[sc_op] = tuple(c * scale for c in a[sc_op])
        want = _compose(O, form, a, None, mask)
        _same(tuple(c.expand(pack[0]) for c in want), got)
        assert pack[0] == tuple(torch.broadcast_shapes(
            *(c.shape for op in ops for c in op), mask.shape,
            *((scale.shape,) if isinstance(scale, torch.Tensor) else ())))


def _tree_case(rng, n, nw, cols=3, pro=False, acc=False):
    """[n, cols] words read strided (a transposed view), their partner and
    an accumulator when asked."""
    x = tuple(torch.from_numpy(w).transpose(0, 1)
              for w in _words(rng, (cols, n), nw))
    y = _t(_words(rng, (n, 1), nw)) if pro else None
    a = _t(_words(rng, (cols,), nw)) if acc else None
    return x, y, a


def _check_tree(x, y, acc, nw, rng, smem, cluster, sub=False, scale=None,
                scale_on=None):
    out, launches = K.tree_sum_launches(x, 0, y, acc, sub, scale, scale_on,
                                        smem=smem, cluster=cluster)
    for ln in launches:
        emulate_tree_launch(ln, nw, rng)
    _same(K.tree_sum_fused_plain(x, y, 0, acc, sub, scale, scale_on), out)
    return launches


def test_tree_plan_cluster_route_reproduces_pairing():
    """n = 0..300 over 3 columns with budgets of ceil(h / G) level-1
    entries a block (h = ceil(n / 2)): the cluster route at every size
    2..8 and the block route, then budgets below h / 8 a block (the level
    route; below h with no cluster for short columns),
    each emulated as the kernel runs it; the product, a scale and the
    accumulate on some of them."""
    nw = 5
    rng = np.random.default_rng(11)
    sizes = set()
    for n in range(301):
        h = (n + 1) // 2
        for G in (1, 2, 3, 5, 8):
            smem = 4 * nw * max(1, -(-h // G))
            route, plan = K.tree_sum_plan(n, nw, 3, smem)
            if route == "cluster":
                sizes.add(plan)
                assert plan * (smem // (4 * nw)) >= h
            else:
                assert route == "shared"
            pro, acc = n % 3 == 1, n % 2 == 1
            x, y, a = _tree_case(rng, n, nw, pro=pro, acc=acc)
            ls = _check_tree(x, y, a, nw, rng, smem, K.TREE_CLUSTER,
                             sub=n % 4 == 3)
            assert len(ls) == 1 and ls[0].G == (plan if route == "cluster"
                                                else 1)
        if n > 1:
            # below h / 8 a block (or, for short columns, below h and no
            # cluster)
            smem, cl = ((4 * nw * (h // 9), K.TREE_CLUSTER) if h >= 18
                        else (4 * nw * (h - 1), 1))
            assert K.tree_sum_plan(n, nw, 3, smem, cl)[0] == "levels"
            x, y, a = _tree_case(rng, n, nw, pro=True, acc=True)
            ls = _check_tree(x, y, a, nw, rng, smem, cl)
            assert [ln.pro for ln in ls] == [1] + [0] * (len(ls) - 1)
            assert [ln.epi for ln in ls] == [0] * (len(ls) - 1) + [1]
    assert sizes == set(range(2, 9))


@pytest.mark.parametrize("n,nw", [(18432, 5), (32768, 5), (32768, 8)])
def test_tree_plan_large_columns_one_cluster_launch(n, nw):
    """The (3,95) dd_dot's 18,432 entries and (3,127)'s ~32,768: one
    launch over a cluster (the level route took 15), emulated with the
    product and the accumulate, equal to the plain composition."""
    rng = np.random.default_rng(n + nw)
    x, y, a = _tree_case(rng, n, nw, cols=1, pro=True, acc=True)
    route, G = K.tree_sum_plan(n, nw, 1)
    assert route == "cluster" and 2 <= G <= K.TREE_CLUSTER
    ls = _check_tree(x, y, a, nw, rng, K.TREE_SMEM, K.TREE_CLUSTER)
    assert len(ls) == 1 and ls[0].G == G
    assert 4 * nw * ls[0].S <= K.TREE_SMEM


def test_tree_plan_block_route_and_spread():
    # the (3,95) [2, 192, 96] sums over 96 entries: 48 level-1 entries a
    # column, 5 columns a block of 256 threads
    assert K.tree_sum_plan(96, 5, 384) == ("shared", 5)
    # a long column spreads over a cluster only while few columns fill
    # the card
    assert K.tree_sum_plan(4000, 5, 2)[0] == "cluster"
    assert K.tree_sum_plan(4000, 5, 100)[0] == "shared"
    # capacity alone: 100,000 entries at nw 8 need 7 blocks of 227 KB
    assert K.tree_sum_plan(100000, 8, 100) == ("cluster", 7)
    for n in range(0, 600):
        route, C = K.tree_sum_plan(n, 8, 10 ** 6)
        assert route == "shared"
        assert 4 * 8 * ((n + 1) // 2) * C <= K.TREE_SMEM


def test_select_plain_and_segments():
    """ew_select on CPU words is torch.where then the copy into dst, for
    both values of cond; the CUDA route's segments hold every non-empty
    pair once, at most SELECT_MAX_SEGS a launch, and refuse strided
    words."""
    rng = np.random.default_rng(3)
    nw = 5
    pairs = [(_t(_words(rng, s, nw)), _t(_words(rng, s, nw)))
             for s in [(2, 3), (0, 4), (7,), (1, 21, 22)] * 9]
    for flag in (True, False):
        dsts = [tuple(c.clone() for c in d) for _, d in pairs]
        want = [tuple(torch.where(torch.tensor(flag), s, d)
                      for s, d in zip(src, dst))
                for (src, _), dst in zip(pairs, dsts)]
        K.reset_counts()
        got = K.ew_select(torch.tensor(flag), [(s, d) for (s, _), d in
                                               zip(pairs, dsts)])
        assert K.counts()["ew_select_plain"] == 1
        for w, g, d in zip(want, got, dsts):
            assert g is d
            _same(w, g)
    chunks = K.select_segments(torch.tensor(True), pairs)
    assert [len(c) for c in chunks] == [24, 3]
    assert all(p[0][0].numel() for c in chunks for p in c)
    strided = (tuple(c.t() for c in pairs[0][0]), pairs[0][1])
    with pytest.raises(ValueError, match="contiguous"):
        K.select_segments(torch.tensor(True), [strided])


def test_f64_front_ends_are_the_compositions():
    """On f64 words the fused front ends call the f64 compositions they
    replace, bit for bit."""
    rng = np.random.default_rng(5)
    w = [tuple(torch.from_numpy(rng.standard_normal((3, 4)) * 10.0 ** k)
               for k in (0, -17)) for _ in range(4)]
    m = torch.from_numpy(rng.integers(0, 2, (3, 4)).astype(np.float64))
    a, b, c, d = w
    _same(TA.dd_fma(a, b, c, m),
          tuple(x * m for x in F.dd_add(a, F.dd_mul(b, c))))
    _same(TA.dd_fms(a, b, c), F.dd_sub(a, F.dd_mul(b, c)))
    _same(TA.dd_msub(a, b, c), F.dd_sub(F.dd_mul(a, b), c))
    _same(TA.dd_mms(a, b, c, d, m), tuple(
        x * m for x in F.dd_sub(F.dd_mul(a, b), F.dd_mul(c, d))))
    _same(TA.dd_sub2(a, b, c, -1.0, m), tuple(
        x * m for x in F.dd_sub(F.dd_sub(a, b), tuple(-x for x in c))))
    s = K.pairwise_sum(F.dd_mul(a, b), 1, F.dd_add)
    _same(TL.dd_sum_prod(a, b, 1, tuple(x[:, 0] for x in c), sub=True),
          F.dd_sub(tuple(x[:, 0] for x in c), s))
    flat = tuple(x.reshape(-1) for x in F.dd_mul(tuple(x * m for x in a), b))
    _same(TL.dd_sum_prod(a, b, None, scale=m),
          K.pairwise_sum(flat, 0, F.dd_add))
    src = tuple(x.clone() for x in a)
    dst = tuple(x.clone() for x in b)
    TA.dd_commit(torch.tensor(False), [(src, dst)])
    _same(dst, b)
    TA.dd_commit(torch.tensor(True), [(src, dst)])
    _same(dst, a)


# ---------------------------------------------------------------------------
# the step goes through the fused wrappers
# ---------------------------------------------------------------------------

CENSUS = ("tree_sum_fused", "ew_fma", "ew_fms", "ew_msub", "ew_mms",
          "ew_sub2", "ew_select")


def _unfused_wrappers():
    """The fused forms as compositions of today's (unfused) wrappers, as
    the step called them before they were fused."""
    def masked(r, m):
        return r if m is None else tuple(c * m for c in r)

    def tree(x, y, axis, acc=None, sub=False, scale=None, scale_on=None):
        if scale_on == "x":
            x = tuple(c * scale for c in x)
        p = K.ew_mul(x, y) if y is not None else x
        if scale_on == "product":
            p = tuple(c * scale for c in p)
        p, axis = K.flatten_sum_axes(p, axis)
        s = K.tree_sum(p, axis)
        if acc is None:
            return s
        return K.ew_sub(acc, s) if sub else K.ew_add(acc, s)

    return {
        "ew_fma": lambda a, b, c, mask=None: masked(
            K.ew_add(a, K.ew_mul(b, c)), mask),
        "ew_fms": lambda a, b, c, mask=None: masked(
            K.ew_sub(a, K.ew_mul(b, c)), mask),
        "ew_msub": lambda a, b, c, mask=None: masked(
            K.ew_sub(K.ew_mul(a, b), c), mask),
        "ew_mms": lambda a, b, c, d, mask=None: masked(
            K.ew_sub(K.ew_mul(a, b), K.ew_mul(c, d)), mask),
        "ew_sub2": lambda a, b, c, c_scale=None, mask=None: masked(
            K.ew_sub(K.ew_sub(a, b), c if c_scale is None
                     else tuple(w * c_scale for w in c)), mask),
        "tree_sum_fused": tree,
        "ew_select": unfused_forms()["ew_select"],
    }


def test_step_census_sites_go_through_fused_wrappers(monkeypatch):
    """One eager delsarte(3,3) chunk iteration on the CPU (step and
    commit) calls every fused wrapper, and its state, info and flags are
    word for word those of the same iteration with each fused form
    computed by the unfused wrappers it replaces."""
    sdp = ct.ClusteredLowRankSDP(delsarte(ct, 3))
    ds = TS.DeviceSDP(sdp, nw=5, device="cpu")
    kw = dict(gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
              dual_error_threshold=1e-12, primal_error_threshold=1e-12)

    def one():
        state = TS.initial_state(ds, 100.0, 100.0)
        info = TS.zero_info(_to_host(TS.make_assess(ds)(state)), ds.device)
        run = TS.make_run_chunk(ds, duality_gap_threshold=1e-15, **kw)
        K.reset_counts()
        s, pd, inf, it, code, done = run(state, False, info, 1)
        return s, inf, (pd, it, code, done), K.counts()

    s1, i1, f1, c1 = one()
    for name in CENSUS:
        assert c1[name + "_plain"] > 0, name
        assert c1[name] == 0, name
    assert int(f1[1]) == 1                    # the iteration committed
    for name, fn in _unfused_wrappers().items():
        monkeypatch.setattr(K, name, fn)
    s2, i2, f2, c2 = one()
    assert all(c2[n + "_plain"] == 0 for n in CENSUS if n != "ew_select")
    w1, w2 = state_words(s1), state_words(s2)
    assert len(w1) == len(w2) > 0
    for a, b in zip(w1, w2):
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    for k in i1:
        assert torch.equal(torch.as_tensor(i1[k]), torch.as_tensor(i2[k])), k
    for a, b in zip(f1, f2):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
