"""PSD-to-free-variable reformulation.

Port of `model_psd_variables_as_free_variables`
(`ClusteredLowRankSolver.jl/src/interface.jl:652-752`): rewrite chosen PSD
variables as free variables plus equality constraints tying them to auxiliary
1x1 PSD blocks — this splits one big cluster into many, which is the key
lever for clustering/sharding.
"""

from __future__ import annotations

from ..utils.hp import hp_mul
from .problem import Block, Constraint, Objective, Problem, name_of, subblock_of

__all__ = ["model_psd_variables_as_free_variables"]


def model_psd_variables_as_free_variables(problem: Problem, as_free):
    cons = []
    for c in problem.constraints:
        cons.append(Constraint(c.constant, dict(c.matrixcoeff),
                               dict(c.freecoeff), c.samples, c.scalings))
    o = problem.objective
    obj = Objective(o.constant, dict(o.matrixcoeff), dict(o.freecoeff))

    for l in as_free:
        m = 0
        n = 0
        for constraint in cons:
            for block in list(constraint.matrixcoeff.keys()):
                if name_of(block) == l:
                    mat = constraint.matrixcoeff[block]
                    shape = mat.shape
                    if n == 0:
                        n = shape[0]
                    elif n != shape[0]:
                        raise ValueError("blocks of unequal sizes")
                    r, s = subblock_of(block)
                    for i in range(shape[0]):
                        for jj in range(shape[1]):
                            key = (l, (r - 1) * n + i + 1, (s - 1) * n + jj + 1)
                            if r == s and i >= jj:
                                if i == jj:
                                    constraint.freecoeff[key] = mat[i, jj]
                                else:
                                    constraint.freecoeff[key] = hp_mul(2, mat[i, jj])
                            elif r > s:
                                constraint.freecoeff[key] = hp_mul(2, mat[i, jj])
                            m = max(r, s, m)
                    del constraint.matrixcoeff[block]

        # equality constraints tying free vars to auxiliary PSD blocks
        for i in range(1, n * m + 1):
            for jj in range(1, i + 1):
                if i == jj:
                    cons.append(Constraint(0, {Block(l, i, jj): [[1]]},
                                           {(l, i, jj): -1}))
                else:
                    cons.append(Constraint(0, {Block(l, i, jj): [[1]],
                                               Block(l, jj, i): [[1]]},
                                           {(l, i, jj): -2}))

        # move the objective onto the new 1x1 subblocks
        new_blocks = {}
        for block in list(obj.matrixcoeff.keys()):
            r, s = subblock_of(block)
            if name_of(block) == l and r >= s:
                mat = obj.matrixcoeff[block]
                mat = mat.to_dense() if hasattr(mat, "to_dense") else mat
                for i in range(n):
                    for jj in range(i + 1 if r == s else n):
                        gi, gj = (r - 1) * n + i + 1, (s - 1) * n + jj + 1
                        if gi == gj:
                            new_blocks[Block(l, gi, gj)] = [[mat[i][jj] if isinstance(mat, list) else mat[i, jj]]]
                        else:
                            v = mat[i][jj] if isinstance(mat, list) else mat[i, jj]
                            new_blocks[Block(l, gi, gj)] = [[v]]
                            new_blocks[Block(l, gj, gi)] = [[v]]
            if name_of(block) == l:
                del obj.matrixcoeff[block]
        obj.matrixcoeff.update(new_blocks)

    return Problem(problem.maximize, obj, cons)
