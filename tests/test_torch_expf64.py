"""The f64 boundary of the step's expansion arithmetic
(clrs_tpu_torch.dd.kernels ``expf64_sum``, ``expf64_max_abs`` and
``expf64_split``; csrc/expf64.cu), on the CPU.

- Each plain version equals, bit for bit, the step's functions that call it
  (``solver/step.py::_f64sum`` and ``_scalar_split``,
  ``dd/linalg.py::dd_max_abs``), an IEEE f64 reference in numpy, and the
  JAX package's functions (clrs_tpu/solver/step.py:104-140,
  clrs_tpu/dd/linalg.py:136-144), over random expansions at nw 5-8: 0-d,
  [J, s], [2L, n, n], transposed and empty shapes, words holding NaN,
  +-Inf and -0, subnormal words, and splits of values that need all three
  words. The JAX comparisons run in XLA:CPU's subnormal flush mode.
- The launches' host arguments (``expf64_pack``, ``expf64_cluster``) are
  emulated on CPU memory as the kernel reads them: every element through
  its word's pointer and strides, MAXABS's cluster walk over every entry
  once with its integer max, SPLIT's source through its strides.
- f64 words and CPU words take the plain versions, counted as such; an
  eager delsarte(3,3) step on the CPU runs all three.
The kernels run only on the card (tests/test_torch_gpu.py).
"""

import ctypes
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clrs_tpu_torch as ct
from clrs_tpu.dd import linalg as JL
from clrs_tpu.solver import step as JS
from clrs_tpu_torch.dd import kernels as K
from clrs_tpu_torch.dd import linalg as TL
from clrs_tpu_torch.solver import step as TS
from torch_helpers import (_slot_strides, delsarte, index_offsets,  # noqa: F401
                           raw_memory, xla_subnormals)

NWS = (5, 6, 7, 8)
SHAPES = {"scalar": (), "pack": (3, 7), "blocks": (4, 11, 11),
          "empty": (2, 0, 5)}
KINDS = ("random", "special", "subnormal")
STEP_KW = dict(gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
               dual_error_threshold=1e-12, primal_error_threshold=1e-12)


def _words(shape, nw, kind, seed=0):
    """nw f32 words: an expansion of random values (word k about 2^-24k of
    word 0); "special" puts NaN, +-Inf and -0 into some entries of some
    words; "subnormal" makes the low words subnormal."""
    rng = np.random.default_rng(seed + 97 * nw + len(shape))
    head = rng.standard_normal(shape) * 2.0 ** rng.integers(-20, 20, shape)
    ws = [head.astype(np.float32)]
    for k in range(1, nw):
        ws.append((rng.standard_normal(shape) * np.abs(head)
                   * 2.0 ** (-24 * k)).astype(np.float32))
    flat = [w.reshape(-1) for w in ws]
    n = flat[0].size
    if kind == "special" and n:
        for i, v in enumerate((np.nan, np.inf, -np.inf, -0.0)):
            flat[(2 * i) % nw][(7 * i + 1) % n] = v
        flat[0][0] = -0.0
        for w in flat[1:]:
            w[0] = -0.0
    if kind == "subnormal" and n:
        tiny = np.float32(2.0 ** -140)
        for k in range(1, nw):
            flat[k][::2] = tiny * rng.integers(-50, 50, flat[k][::2].shape)
        flat[0][1::3] = tiny * 3
    return tuple(torch.from_numpy(w.reshape(shape).copy()) for w in flat)


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.int64 if a.dtype == np.float64 else np.int32),
        b.view(np.int64 if b.dtype == np.float64 else np.int32))


def _np_sum(x):
    s = x[0].numpy().astype(np.float64)
    for c in x[1:]:
        s = s + c.numpy().astype(np.float64)
    return s


def _np_max_abs(x):
    s = np.abs(_np_sum(x))
    return np.float64(0.0) if s.size == 0 else np.max(s)


@pytest.mark.parametrize("nw", NWS)
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", KINDS)
def test_sum_plain_equals_step_and_numpy(nw, shape, kind):
    x = _words(SHAPES[shape], nw, kind)
    got = K.expf64_sum_plain(x)
    assert got.dtype == torch.float64 and got.shape == SHAPES[shape]
    assert _bits(got, _np_sum(x))
    assert _bits(TS._f64sum(x), got)
    t = tuple(c.transpose(-1, -2) for c in x) if len(SHAPES[shape]) > 1 \
        else x
    assert _bits(K.expf64_sum_plain(t), _np_sum(t))


@pytest.mark.parametrize("nw", NWS)
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", KINDS)
def test_max_abs_plain_equals_step_and_numpy(nw, shape, kind):
    x = _words(SHAPES[shape], nw, kind)
    got = K.expf64_max_abs_plain(x)
    assert got.dtype == torch.float64 and got.dim() == 0
    ref = _np_max_abs(x)
    assert _bits(got, ref) or (np.isnan(ref) and bool(got.isnan()))
    assert _bits(TL.dd_max_abs(x), got)
    for acc in (0.0, 5e30, -1.0, float("nan")):
        a = torch.tensor(acc, dtype=torch.float64)
        want = torch.maximum(a, got)
        assert _bits(K.expf64_max_abs_plain(x, a), want)
        assert _bits(TL.dd_max_abs(x, a), want)


def _split_values():
    """f64 values: random, ones that need all three f32 words, and the
    edges (NaN, +-Inf, -0, f64 subnormals, values whose f32 rounding is
    subnormal or overflows)."""
    rng = np.random.default_rng(5)
    v = [rng.standard_normal(16) * 2.0 ** rng.integers(-60, 60, 16),
         np.array([1 + 2.0 ** -26 + 2.0 ** -49 + 2.0 ** -52,
                   -(3 + 2.0 ** -25 + 2.0 ** -48 + 2.0 ** -51),
                   np.pi, 0.1, 1.0 / 3.0, 2.0 ** 100 * (1 + 2.0 ** -52)]),
         np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 5e-310, -2.0 ** -1074,
                   2.0 ** -140 * (1 + 2.0 ** -40), 1e300, -3.5e38])]
    return np.concatenate(v)


@pytest.mark.parametrize("nw", (1, 2, 3) + NWS)
def test_split_plain_equals_step_and_numpy(nw):
    vals = _split_values()
    v = torch.from_numpy(vals)
    got = K.expf64_split_plain(v, nw)
    assert len(got) == nw and all(w.dtype == torch.float32 for w in got)
    r = vals.copy()
    with np.errstate(over="ignore", invalid="ignore"):
        for k in range(nw):
            w = r.astype(np.float32) if k < 3 else np.zeros_like(
                vals, np.float32)
            assert _bits(got[k], w), k
            r = r - w.astype(np.float64)
    step = TS._scalar_split(v, nw, torch.float32)
    assert all(_bits(a, b) for a, b in zip(step, got))
    # 0-d, as the step splits its scalars
    for i in (0, 7, 21):
        one = K.expf64_split_plain(v[i], nw)
        assert all(_bits(a, b[i]) for a, b in zip(one, got))
    # values within f32's range are exact in three words; 16 and 17 need
    # all three
    if nw >= 3:
        for i in range(22):
            parts = [float(got[k][i]) for k in range(3)]
            assert sum(Fraction(p) for p in parts) == Fraction(vals[i])
            if i in (16, 17):
                assert parts[1] != 0 and parts[2] != 0


@pytest.mark.parametrize("nw", (5, 8))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", KINDS)
def test_plain_versions_equal_the_jax_package(nw, shape, kind,
                                              xla_subnormals):
    x = _words(SHAPES[shape], nw, kind)
    jx = tuple(jnp.asarray(c.numpy()) for c in x)
    assert _bits(K.expf64_sum_plain(x), np.asarray(JS._f64sum(jx)))
    got = K.expf64_max_abs_plain(x)
    ref = np.asarray(JL.dd_max_abs(jx))
    assert _bits(got, ref) or (np.isnan(ref) and bool(got.isnan()))
    vals = _split_values()
    got = K.expf64_split_plain(torch.from_numpy(vals), nw)
    ref = JS._scalar_split(jnp.asarray(vals), nw, jnp.float32)
    assert all(_bits(a, np.asarray(b)) for a, b in zip(got, ref))


# ---------------------------------------------------------------------------
# the launches' host arguments, emulated as csrc/expf64.cu reads them
# ---------------------------------------------------------------------------

def _read_words(pack, nw):
    numel, ptrs, strides, _, _, dims, nd = pack
    d = tuple(dims[:nd])
    assert int(np.prod(d)) == numel or numel == 0
    if numel == 0:
        return [np.zeros(0, np.float32)] * nw
    out = []
    for k in range(nw):
        off = index_offsets(d, _slot_strides(strides, k, nd))
        out.append(raw_memory(ptrs[k], off)[off].copy())
    return out


def _emulate_sum(pack, nw):
    ws = _read_words(pack, nw)
    s = ws[0].astype(np.float64)
    for w in ws[1:]:
        s = s + w.astype(np.float64)
    return s


def _emulate_max_abs(pack, nw, acc=None):
    """The cluster walk: thread t of block r takes entries r T + t + j G T;
    each takes the integer max of |v|'s bits from +0, then the block, then
    the cluster (every entry once, asserted), then the accumulator as
    torch.maximum combines it."""
    numel = pack[0]
    s = _emulate_sum(pack, nw)
    G, T = K.expf64_cluster(numel), K.EXPF64_THREADS
    seen = np.zeros(numel, np.int64)
    m = np.uint64(0)
    rng = np.random.default_rng(numel)
    for r in rng.permutation(G):
        for t in rng.permutation(T)[:64] if numel < 64 else range(T):
            i = np.arange(r * T + t, numel, G * T)
            seen[i] += 1
            if i.size:
                m = max(m, np.abs(s[i]).view(np.uint64).max())
    if numel >= 64:
        assert np.all(seen == 1)
    else:
        m = max(m, np.abs(s).view(np.uint64).max()) if numel else m
    v = np.array([m], np.uint64).view(np.float64)[0]
    if acc is None:
        return v
    return torch.maximum(torch.tensor(acc, dtype=torch.float64),
                         torch.tensor(v)).numpy()


def _views(nw):
    """Word views as the step hands them over: contiguous, transposed,
    [:, 0, 0] slices of a block, 0-d, a broadcast row, a scalar pack's
    [J, s] and empty."""
    base = _words((4, 11, 11), nw, "special")
    yield "contiguous", base
    yield "transposed", tuple(c.transpose(-1, -2) for c in base)
    yield "diag_slice", tuple(c[:, 0, 0] for c in base)
    yield "scalar", _words((), nw, "random")
    yield "broadcast", tuple(c.expand(6, 7) for c in _words((1, 7), nw,
                                                            "random"))
    yield "pack", _words((3, 7), nw, "subnormal")
    yield "empty", _words((2, 0, 5), nw, "random")
    yield "long", _words((40_000,), nw, "random", seed=3)
    yield "two_blocks", _words((3000,), nw, "special", seed=4)


@pytest.mark.parametrize("nw", (1, 5, 8))
def test_sum_and_max_abs_launch_arguments(nw):
    for label, x in _views(nw):
        pack = K.expf64_pack(x)
        assert pack[0] == K.expf64_sum_plain(x).numel(), label
        if pack[0]:
            assert _bits(_emulate_sum(pack, nw),
                         K.expf64_sum_plain(x).reshape(-1)), label
        got = _emulate_max_abs(pack, nw)
        want = K.expf64_max_abs_plain(x).numpy()
        assert _bits(got, want) or (np.isnan(want) and np.isnan(got)), label
        a = torch.tensor(7.5, dtype=torch.float64)
        assert _bits(_emulate_max_abs(pack, nw, 7.5),
                     K.expf64_max_abs_plain(x, a)), label


def _raw_f64(ptr, off):
    size = int(np.max(off)) + 1 if np.size(off) else 1
    return np.ctypeslib.as_array(
        (ctypes.c_double * size).from_address(ptr))[off].copy()


@pytest.mark.parametrize("nw", (2, 5, 8))
def test_split_launch_arguments(nw):
    vals = torch.from_numpy(_split_values())
    for v in (vals[3], vals, vals.reshape(2, 16)[:, ::3],
              vals.reshape(4, 8).t()):
        numel, ptrs, strides, _, src_st, dims, nd = K.expf64_pack(src=v)
        assert ptrs is None and numel == v.numel()
        off = index_offsets(tuple(dims[:nd]), tuple(src_st[6 - nd:]))
        r = _raw_f64(v.data_ptr(), off)
        want = K.expf64_split_plain(v, nw)
        with np.errstate(over="ignore", invalid="ignore"):
            for k in range(nw):
                w = r.astype(np.float32) if k < 3 else np.zeros_like(
                    r, np.float32)
                assert _bits(w, want[k].reshape(-1)), k
                r = r - w.astype(np.float64)


def test_max_abs_cluster_sizes():
    """One block up to 4 x 512 entries, a block more for each 2,048, at
    most 8, and every thread of a full cluster walks a bounded share."""
    assert K.expf64_cluster(0) == 1 and K.expf64_cluster(1) == 1
    assert K.expf64_cluster(2048) == 1 and K.expf64_cluster(2049) == 2
    assert K.expf64_cluster(16384) == 8 and K.expf64_cluster(10 ** 7) == 8
    prev = 1
    for n in range(0, 40_000, 97):
        g = K.expf64_cluster(n)
        assert prev <= g <= K.EXPF64_MAX_CLUSTER
        assert g == K.EXPF64_MAX_CLUSTER or \
            n <= g * K.EXPF64_THREADS * K.EXPF64_PER_THREAD
        prev = g


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

def test_f64_and_cpu_words_take_the_plain_versions():
    """f64 words (the f64 substrate) and CPU words take the plain versions
    and launch nothing; the step's functions keep their f64 forms; a
    non-f64 split source is refused."""
    K.reset_counts()
    x64 = tuple(torch.randn(3, 4, dtype=torch.float64) for _ in range(2))
    s = TS._f64sum(x64)
    assert _bits(s, x64[0] + x64[1])
    m = TL.dd_max_abs(x64, torch.zeros((), dtype=torch.float64))
    assert _bits(m, (x64[0] + x64[1]).abs().max())
    v = torch.tensor(0.3, dtype=torch.float64)
    w64 = TS._scalar_split(v, 4, torch.float64)
    assert _bits(w64[0], v) and all(float(c) == 0 for c in w64[1:])
    TS._scalar_split(v, 5, torch.float32)
    c = K.counts()
    assert c["expf64_sum_plain"] == 1 and c["expf64_max_abs_plain"] == 1
    assert c["expf64_split_plain"] == 1
    assert c["expf64_sum"] == c["expf64_max_abs"] == c["expf64_split"] == 0
    with pytest.raises(ValueError):
        K.expf64_split(v.float(), 5)


def test_cpu_step_runs_the_plain_versions():
    """An eager delsarte(3,3) step on the CPU runs every form's plain
    version and launches none of the kernels."""
    ds = TS.DeviceSDP(ct.ClusteredLowRankSDP(delsarte(ct, 3)), nw=5,
                      device="cpu")
    step = TS.make_step_body(ds, **STEP_KW)
    K.reset_counts()
    step(TS.initial_state(ds, 100.0, 100.0), False)
    c = K.counts()
    for name in ("expf64_sum", "expf64_max_abs", "expf64_split"):
        assert c[name + "_plain"] > 0 and c[name] == 0, name
