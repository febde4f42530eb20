"""SDPA sparse format reader.

Port of `ClusteredLowRankSolver.jl/src/SDPAtoCLRS.jl`: parse `.dat-s`
(negative block sizes = diagonal blocks, expanded into 1x1 scalar blocks —
which the compiler then batches into the scalar pack), build a dense
`Problem`, drop empty constraints with warnings.
"""

from __future__ import annotations

import warnings
from fractions import Fraction

import numpy as np

from .problem import Constraint, Maximize, Objective, Problem

__all__ = ["sdpa_sparse_to_problem", "read_sdpa_sparse_file"]


def _parse_num(s):
    return Fraction(s) if ("/" in s or "." not in s and "e" not in s.lower()) \
        else Fraction(float(s))


def read_sdpa_sparse_file(filename):
    with open(filename) as f:
        lines = [ln.split() for ln in f.readlines()]
    i = 0
    while lines[i][0][0] not in "0123456789":
        i += 1
    m = int(lines[i][0].rstrip(";,")); i += 1
    int(lines[i][0].rstrip(";,")); i += 1  # nblocks
    blocksizes = [int(x.rstrip(";,")) for x in lines[i]]; i += 1
    diag_blocks = {idx for idx, b in enumerate(blocksizes) if b < 0}
    c = [_parse_num(x.rstrip(";,")) for x in lines[i]]; i += 1
    assert len(c) == m

    def make_blocks():
        out = []
        for b in blocksizes:
            if b < 0:
                out.append([np.zeros((1, 1), dtype=object) + Fraction(0)
                            for _ in range(-b)])
            else:
                out.append(np.zeros((b, b), dtype=object) + Fraction(0))
        return out

    blocks = [make_blocks() for _ in range(m + 1)]
    for ln in lines[i:]:
        if not ln:
            continue
        cidx, bidx, a, bb = (int(x.rstrip(";,")) for x in ln[:4])
        v = _parse_num(ln[4].rstrip(";,"))
        if bidx - 1 in diag_blocks:
            assert a == bb
            blocks[cidx][bidx - 1][a - 1][0, 0] = v
        else:
            blocks[cidx][bidx - 1][a - 1, bb - 1] = v
            blocks[cidx][bidx - 1][bb - 1, a - 1] = v
    return m, blocksizes, c, blocks


def sdpa_sparse_to_problem(filename, obj_shift=0):
    """Build a `Problem` from an SDPA-sparse file (SDPAtoCLRS.jl:49-84)."""
    m, blocksizes, c, blocks = read_sdpa_sparse_file(filename)
    dicts = [{} for _ in range(m + 1)]
    for cidx in range(m + 1):
        for bidx, b in enumerate(blocksizes):
            if b < 0:
                for b2 in range(-b):
                    mat = blocks[cidx][bidx][b2]
                    if any(x != 0 for x in mat.reshape(-1)):
                        dicts[cidx][(bidx + 1, b2 + 1)] = mat
            else:
                mat = blocks[cidx][bidx]
                if any(x != 0 for x in mat.reshape(-1)):
                    dicts[cidx][bidx + 1] = mat
    obj = Objective(obj_shift, dicts[0], {})
    cons = []
    for i in range(m):
        if not dicts[i + 1]:
            if c[i] != 0:
                warnings.warn("Constraint without constraint matrices but with "
                              "nonzero constant found. Removing the constraint.")
            continue
        cons.append(Constraint(c[i], dicts[i + 1], {}))
    return Problem(Maximize(obj), cons)
