"""IPM state across packages: the port's tensors <-> numpy word arrays.

A state is the dict the step functions carry: ``x`` (per cluster group),
``y``, ``X``/``Y`` (per group, per size class) and ``Xs``/``Ys`` (scalar
packs), each an expansion: a tuple of same-shape word arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .solver.step import _w


def _map(state, fn):
    out = {}
    for key, val in state.items():
        if key in ("X", "Y"):
            out[key] = [[fn(ws) for ws in cls] for cls in val]
        elif key == "y":
            out[key] = fn(val)
        else:
            out[key] = [fn(ws) for ws in val]
    return out


def state_from_numpy(ds, words_np):
    """A state of numpy word tuples (the JAX package's state after
    ``np.asarray``) -> the port's nw f32 words on ``ds.device``. f32 words
    of the port's count are taken as they are; anything else (the JAX f64
    two-word states) is re-split into nw f32 words by the host rule of
    ``_w`` (clrs_tpu/solver/step.py:75-95)."""

    def conv(ws):
        ws = tuple(np.asarray(w) for w in ws)
        if len(ws) == ds.nw and all(w.dtype == np.float32 for w in ws):
            return tuple(torch.from_numpy(np.array(w))
                         .to(ds.device) for w in ws)
        return _w(tuple(w.astype(np.float64) for w in ws), ds.nw, ds.device)

    return _map(words_np, conv)


def state_to_numpy(state):
    """The port's state -> numpy word tuples (host copies)."""
    return _map(state, lambda ws: tuple(c.detach().cpu().numpy() for c in ws))
