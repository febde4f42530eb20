"""Expansion arithmetic dispatched on the word dtype.

f32 words go to the ``ew_*`` wrappers of :mod:`.kernels`: one
``expmap<NW, OP>`` launch an op for CUDA words (csrc/expmap.cu, the
counterpart of the XLA fusions of the TPU step), the sort-free forms of
:mod:`.ops` (``exp_*``, the forms of the JAX package's TPU path) for CPU
words; f64 words go to :mod:`.f64ops` (the forms of ``clrs_tpu/dd/core.py``
off the TPU). This mirrors the dispatching ``dd_add``/``dd_mul``/... of
``dd.core`` that the JAX step imports (clrs_tpu/solver/step.py:48).

The step's product-then-sum chains have fused front ends (``dd_fma``,
``dd_fms``, ``dd_msub``, ``dd_mms``, ``dd_sub2``, each with an optional
exact mask, and the commit's ``dd_commit``): f32 words go to one
``expfuse`` or ``expselect`` launch (csrc/expfuse.cu) for CUDA words and
to the composition of the plain ops for CPU words; f64 words run the
composition of the ops above that the fused form replaces.
"""

from __future__ import annotations

import torch

from . import f64ops
from . import kernels as K

__all__ = ["is_f64", "dd_add", "dd_sub", "dd_mul", "dd_div", "dd_neg",
           "dd_fma", "dd_fms", "dd_msub", "dd_mms", "dd_sub2", "dd_commit"]


def is_f64(x):
    """True for an expansion of float64 words."""
    return x[0].dtype == torch.float64


def dd_add(x, y):
    return f64ops.dd_add(x, y) if is_f64(x) else K.ew_add(x, y)


def dd_sub(x, y):
    return f64ops.dd_sub(x, y) if is_f64(x) else K.ew_sub(x, y)


def dd_mul(x, y):
    return f64ops.dd_mul(x, y) if is_f64(x) else K.ew_mul(x, y)


def dd_div(x, y):
    return f64ops.dd_div(x, y) if is_f64(x) else K.ew_div(x, y)


def dd_neg(x):
    return tuple(-c for c in x) if is_f64(x) else K.ew_neg(x)


_mask = K._masked          # each word times an exact mask, or none


def dd_fma(a, b, c, mask=None):
    """(a + b c) [mask]."""
    if is_f64(a):
        return _mask(dd_add(a, dd_mul(b, c)), mask)
    return K.ew_fma(a, b, c, mask)


def dd_fms(a, b, c, mask=None):
    """(a - b c) [mask]."""
    if is_f64(a):
        return _mask(dd_sub(a, dd_mul(b, c)), mask)
    return K.ew_fms(a, b, c, mask)


def dd_msub(a, b, c, mask=None):
    """(a b - c) [mask]."""
    if is_f64(a):
        return _mask(dd_sub(dd_mul(a, b), c), mask)
    return K.ew_msub(a, b, c, mask)


def dd_mms(a, b, c, d, mask=None):
    """(a b - c d) [mask]."""
    if is_f64(a):
        return _mask(dd_sub(dd_mul(a, b), dd_mul(c, d)), mask)
    return K.ew_mms(a, b, c, d, mask)


def dd_sub2(a, b, c, c_scale=None, mask=None):
    """((a - b) - c s) [mask], s an exact word or float on c's words."""
    if is_f64(a):
        cs = c if c_scale is None else tuple(w * c_scale for w in c)
        return _mask(dd_sub(dd_sub(a, b), cs), mask)
    return K.ew_sub2(a, b, c, c_scale, mask)


def dd_commit(cond, pairs):
    """dst = cond ? src : dst for every (src, dst) pair of expansions, in
    place (cond a device bool)."""
    pairs = list(pairs)
    if not pairs:
        return []
    if is_f64(pairs[0][0]):
        for src, dst in pairs:
            for d, s in zip(dst, src):
                d.copy_(torch.where(cond, s, d))
        return [dst for _, dst in pairs]
    return K.ew_select(cond, pairs)
