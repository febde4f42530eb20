"""IPM states and solutions across packages.

A state is the dict the step functions carry: ``x`` (per cluster group),
``y``, ``X``/``Y`` (per group, per size class) and ``Xs``/``Ys`` (scalar
packs), each an expansion: a tuple of same-shape word arrays; the port's
tensors go to and from numpy word arrays.

A solution crosses as plain data (:func:`solution_from_data`), so that a
solution of another package (the JAX package's, in the tests) reaches the
port's rounding as the port's own classes.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from .model.problem import Block
from .solver.status import DualSolution, PrimalSolution
from .solver.step import _w
from .utils.hp import DDScalar


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
    ``np.asarray``) -> the port's words on ``ds.device``.

    An f64 DeviceSDP takes f64 words of its own count word for word (the
    JAX f64 states, nw 2, 4, 5, ...). An f32 DeviceSDP takes f32 words of
    its count as they are and re-splits anything else (the JAX f64
    two-word states) into nw f32 words by the host rule of ``_w``
    (clrs_tpu/solver/step.py:75-95)."""

    def conv(ws):
        ws = tuple(np.asarray(w) for w in ws)
        if ds.dtype == torch.float64:
            if len(ws) != ds.nw or any(w.dtype != np.float64 for w in ws):
                raise ValueError(
                    f"an f64 DeviceSDP of {ds.nw} words takes f64 states of "
                    f"{ds.nw} words, got {len(ws)} words of "
                    f"{ws[0].dtype}")
            return tuple(torch.from_numpy(np.array(w)).to(ds.device)
                         for w in ws)
        if len(ws) == ds.nw and all(w.dtype == np.float32 for w in ws):
            return tuple(torch.from_numpy(np.array(w))
                         .to(ds.device) for w in ws)
        return _w(tuple(w.astype(np.float64) for w in ws), ds.nw, ds.device)

    return _map(words_np, conv)


def state_to_numpy(state):
    """The port's state -> numpy word tuples (host copies)."""
    return _map(state, lambda ws: tuple(c.detach().cpu().numpy() for c in ws))


def _entry(v):
    """A (hi, lo) pair of floats -> DDScalar; an int or Fraction ->
    Fraction."""
    if isinstance(v, tuple):
        hi, lo = v
        return DDScalar(float(hi), float(lo))
    if isinstance(v, (int, Fraction)):
        return Fraction(v)
    raise TypeError(f"a solution entry is a (hi, lo) pair of floats or a "
                    f"Fraction, got {type(v).__name__}")


def _key(k):
    """("block", l, r, s) -> Block(l, r, s); ("name", l) -> l."""
    if k[0] == "block":
        return Block(*k[1:])
    if k[0] == "name":
        return k[1]
    raise ValueError(f"a matrix key is ('name', l) or ('block', l, r, s), "
                     f"got {k!r}")


def solution_from_data(data):
    """Plain data -> the port's DualSolution or PrimalSolution.

    ``data["kind"]`` is ``"dual"`` or ``"primal"``; ``data["matrixvars"]``
    a list of (key, rows) with key ``("name", l)`` for a whole variable or
    ``("block", l, r, s)`` for its (r, s) subblock and rows a list of rows
    of entries; a dual's ``data["x"]`` a list (per constraint) of lists of
    entries, a primal's ``data["freevars"]`` a list of (name, entry). An
    entry is a (hi, lo) pair of floats (a numerical solution's DDScalar)
    or a Fraction (an exact one)."""
    mats = {}
    for k, rows in data["matrixvars"]:
        m = np.empty((len(rows), len(rows[0]) if rows else 0), dtype=object)
        for i, row in enumerate(rows):
            for j, v in enumerate(row):
                m[i, j] = _entry(v)
        mats[_key(k)] = m
    if data["kind"] == "dual":
        return DualSolution([[_entry(v) for v in xs] for xs in data["x"]],
                            mats)
    if data["kind"] == "primal":
        return PrimalSolution(mats, {name: _entry(v)
                                     for name, v in data["freevars"]})
    raise ValueError(f"kind is 'dual' or 'primal', got {data['kind']!r}")
