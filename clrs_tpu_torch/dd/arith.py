"""Expansion arithmetic dispatched on the word dtype.

f32 words go to the ``ew_*`` wrappers of :mod:`.kernels`: one
``expmap<NW, OP>`` launch an op for CUDA words (csrc/expmap.cu, the
counterpart of the XLA fusions of the TPU step), the sort-free forms of
:mod:`.ops` (``exp_*``, the forms of the JAX package's TPU path) for CPU
words; f64 words go to :mod:`.f64ops` (the forms of ``clrs_tpu/dd/core.py``
off the TPU). This mirrors the dispatching ``dd_add``/``dd_mul``/... of
``dd.core`` that the JAX step imports (clrs_tpu/solver/step.py:48).
"""

from __future__ import annotations

import torch

from . import f64ops
from . import kernels as K

__all__ = ["is_f64", "dd_add", "dd_sub", "dd_mul", "dd_div", "dd_neg"]


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
