"""The port's slice GEMM (clrs_tpu_torch.dd.slice_gemm.slice_matmul)
against the JAX package's on the CPU.

- Bit for bit against the jitted clrs_tpu.dd.slice_gemm.slice_matmul at
  K in {1, 7, 64, 65, 192, 1024} and nw in {2, 4, 5}, with rows and
  columns of very different scales (XLA:CPU flushes f64 subnormals, so
  the port runs under the same flush).
- A batched call equals the member-by-member calls bit for bit (each
  member takes its own exponents, as jax.vmap(dd_matmul) does).
- Against the exact Fraction product: the error is within the final
  rounding into nw words, 2^-(53 nw - 2) of the product, plus the
  truncation, 2^-(53 nw + 12) of rowscale(A) colscale(B) K with the
  scales the powers of two above the row and column maxima
  (clrs_tpu/dd/slice_gemm.py:24-25).
- The bit-built powers of two equal np.ldexp wherever the result is a
  normal number, also where |e| exceeds 1022.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clrs_tpu.dd import slice_gemm as SG
from clrs_tpu_torch.dd import slice_gemm as TG
from torch_helpers import xla_subnormals  # noqa: F401


def words(rng, shape, nw, spread=20):
    """nw-word f64 expansions; word 0 spans 10^-spread..10^spread."""
    w0 = rng.uniform(-2, 2, shape) * 10.0 ** rng.uniform(-spread, spread,
                                                         shape)
    ws = [w0]
    for _ in range(1, nw):
        ws.append(ws[-1] * 2.0 ** -rng.integers(53, 60, shape)
                  * rng.uniform(-1, 1, shape))
    return ws


def _t(ws):
    return tuple(torch.from_numpy(np.ascontiguousarray(w)) for w in ws)


def _same(a, b):
    for x, y in zip(a, b):
        x = np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        if not np.array_equal(x.view(np.int64), y.view(np.int64)):
            return False
    return len(a) == len(b)


@pytest.mark.parametrize("nw", [2, 4, 5])
@pytest.mark.parametrize("k", [1, 7, 64, 65, 192, 1024])
def test_slice_matmul_bit_identical_to_jax(k, nw, xla_subnormals):
    rng = np.random.default_rng(1000 * nw + k)
    a = words(rng, (5, k), nw)
    b = words(rng, (k, 6), nw)
    a[0][1] *= 1e120                      # rows and columns far apart
    b[0][:, 2] *= 1e-120
    for w in a[1:]:
        w[1] *= 1e120
    for w in b[1:]:
        w[:, 2] *= 1e-120
    want = jax.jit(SG.slice_matmul)(tuple(map(jnp.asarray, a)),
                                    tuple(map(jnp.asarray, b)))
    got = TG.slice_matmul(_t(a), _t(b))
    assert _same(want, got)


@pytest.mark.parametrize("nw", [2, 5])
def test_batched_call_equals_member_calls(nw):
    """[B] batch, members of very different scales: each member's words
    equal its own unbatched call's."""
    rng = np.random.default_rng(nw)
    B, m, k, n = 4, 7, 33, 5
    a = words(rng, (B, m, k), nw)
    b = words(rng, (B, k, n), nw)
    for i, s in enumerate((1e-200, 1.0, 1e100, 1e250)):
        for w in a:
            w[i] *= s
    got = TG.slice_matmul(_t(a), _t(b))
    for i in range(B):
        one = TG.slice_matmul(_t([w[i] for w in a]), _t([w[i] for w in b]))
        assert _same(tuple(c[i] for c in got), one)


def _frac(ws):
    return sum(Fraction(float(w)) for w in ws)


@pytest.mark.parametrize("nw, k", [(2, 7), (2, 192), (4, 65), (5, 192)])
def test_slice_matmul_within_its_bound_of_the_exact_product(nw, k):
    rng = np.random.default_rng(nw + k)
    m, n = 3, 4
    a = words(rng, (m, k), nw, spread=3)
    b = words(rng, (k, n), nw, spread=3)
    got = TG.slice_matmul(_t(a), _t(b))
    rowmax = np.abs(a[0]).max(axis=1)
    colmax = np.abs(b[0]).max(axis=0)
    for i in range(m):
        ai = [_frac([w[i, t] for w in a]) for t in range(k)]
        for j in range(n):
            exact = sum(ai[t] * _frac([w[t, j] for w in b])
                        for t in range(k))
            err = abs(_frac([c[i, j].item() for c in got]) - exact)
            tol = (Fraction(2) ** -(53 * nw + 12) * 4 * Fraction(rowmax[i])
                   * Fraction(colmax[j]) * k
                   + Fraction(2) ** -(53 * nw - 2) * abs(exact))
            assert err <= tol, (i, j, float(err), float(tol))


def test_mul_pow2_is_ldexp_where_normal():
    rng = np.random.default_rng(5)
    x = rng.uniform(1, 2, 4096) * np.exp2(rng.integers(-1000, 1000, 4096)
                                           .astype(np.float64))
    e = rng.integers(-2900, 2900, 4096).astype(np.int32)
    want = np.ldexp(x, e)
    got = TG.mul_pow2(torch.from_numpy(x), torch.from_numpy(e),
                      steps=3).numpy()
    normal = (np.abs(want) >= np.finfo(np.float64).tiny) & np.isfinite(want)
    assert normal.sum() > 1000
    assert np.array_equal(want[normal], got[normal])
