"""The transposed triangular solve's halving tree: the schedule the port's
plain version runs and the CUDA kernel reads, against the JAX package.

(a) ``tree_sum_rows`` equals ``pallas_linalg._exp_sum_axis0`` (plain JAX,
no Pallas) bit for bit; (b) the flattened table the wrapper hands to the
kernel (``kernels.tree_table``), evaluated here in plain PyTorch height by
height as the kernel does, gives the same words, also with the rows the
kernel leaves at +0 for a solved row i; (c) ``tri_solve_plain`` equals the
interpreted Pallas solves at n 7 (the interpreter takes 8-15 s per form
at nw 5). Same tolerance everywhere: bit identity (the same IEEE op
sequence), in XLA:CPU's flush-to-zero mode on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clrs_tpu.dd import pallas_linalg as P
from clrs_tpu_torch.dd import kernels as K
from clrs_tpu_torch.dd import ops as O
from torch_helpers import spd_words, split_words, xla_subnormals  # noqa: F401

NW = 5
TREE_N = [1, 2, 3, 5, 11, 22, 32, 64, 95]


def _rows(n, m, seed):
    """nw-word values [n, m] spread over 12 decades, so that the tree's sums
    round in every word."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, m)) * 10.0 ** rng.integers(-6, 6, (n, m))
    return split_words(v, NW)


def _t(ws):
    return tuple(torch.from_numpy(np.array(w)) for w in ws)


def _same(xs, ys):
    return all(np.array_equal(np.asarray(x).view(np.int32),
                              np.asarray(y).view(np.int32))
               for x, y in zip(xs, ys))


def _eval_table(ws, n):
    """Evaluate :func:`kernels.tree_table` (n) on words [B, n, m] in plain
    PyTorch, as the kernel reads it: leaves 0..n-1, then per height one
    exp_add of (left, right) into out over the height's nodes; the root is
    the last node's out (leaf 0 for n = 1)."""
    table, H = K.tree_table(n)
    table = table.tolist()
    offs, nodes = table[:H + 1], table[H + 1:]
    assert len(nodes) == 3 * (n - 1) and offs[0] == 0 and offs[-1] == n - 1
    buf = [torch.cat([c, c.new_zeros((c.shape[0], n - 1) + c.shape[2:])], 1)
           for c in ws]
    for h in range(H):
        trip = [nodes[3 * k:3 * k + 3] for k in range(offs[h], offs[h + 1])]
        a, b, o = (torch.tensor(v) for v in zip(*trip))
        s = O.exp_add(tuple(c.index_select(1, a) for c in buf),
                      tuple(c.index_select(1, b) for c in buf))
        for c, sc in zip(buf, s):
            c.index_copy_(1, o, sc)
    root = nodes[-1] if n > 1 else 0
    return tuple(c[:, root:root + 1] for c in buf)


@pytest.mark.parametrize("n", TREE_N)
def test_tree_sum_rows_bit_identical_to_exp_sum_axis0(n, xla_subnormals):
    ws = _rows(n, 3, seed=n)
    ref = P._exp_sum_axis0(tuple(map(jnp.asarray, ws)), 0, n)       # [1, m]
    got = K.tree_sum_rows(tuple(c[None] for c in _t(ws)))            # [1, 1, m]
    assert _same(ref, [c[0].numpy() for c in got])


@pytest.mark.parametrize("n", TREE_N)
def test_kernel_tree_table_gives_tree_sum_rows(n):
    """The flattened schedule is the one tree_sum_rows runs, and every
    height's nodes are independent (no node reads an out of its own
    height). With the leaves of rows r <= i at +0, as the kernel leaves them
    while it solves row i, the sum is the same as well."""
    ws = tuple(c[None] for c in _t(_rows(n, 2, seed=100 + n)))
    assert _same(_eval_table(ws, n), K.tree_sum_rows(ws))
    table, H = K.tree_table(n)
    table = table.tolist()
    offs, nodes = table[:H + 1], table[H + 1:]
    for h in range(H):
        outs = {nodes[3 * k + 2] for k in range(offs[h], offs[h + 1])}
        for k in range(offs[h], offs[h + 1]):
            assert not {nodes[3 * k], nodes[3 * k + 1]} & outs
    i = n // 2
    masked = tuple(torch.where(torch.arange(n)[None, :, None] > i, c,
                               torch.zeros_like(c)) for c in ws)
    assert _same(_eval_table(masked, n), K.tree_sum_rows(masked))


@pytest.mark.parametrize("trans", [False, True])
def test_tri_solve_plain_bit_identical_to_pallas_n7(trans, xla_subnormals):
    n, m = 7, 1
    L, _ = K.chol_plain(_t(spd_words(1, n, NW, seed=11)))
    Bm = split_words(np.random.default_rng(12).standard_normal((1, n, m)), NW)
    fj = P.pl_solve_tril_t_b if trans else P.pl_solve_tril_b
    Xj = fj(tuple(jnp.asarray(c.numpy()) for c in L),
            tuple(map(jnp.asarray, Bm)))
    Xt = K.tri_solve_plain(L, _t(Bm), trans)
    assert _same(Xj, [c.numpy() for c in Xt])


def test_solve_forms_counted_apart():
    """counts() names each form of the solve after its kernel; the CPU
    route runs the plain version and launches neither."""
    K.reset_counts()
    A = _t(spd_words(1, 4, NW, seed=3))
    Bm = _t(split_words(np.ones((1, 4, 2)), NW))
    K.tri_solve_batched(A, Bm, trans=True)
    c = K.counts()
    assert c["tri_solve_batched<false>"] == c["tri_solve_batched<true>"] == 0
    assert c["tri_solve_plain"] == 1 and c["tri_solve_batched"] == 0
    assert set(K.TRI_FORMS.values()) <= set(c)
