"""Time one of the port's kernels at every shape one IPM iteration gives it.

Runs ``--iters`` iterations of delsarte(3, d) on the card with the calls of
the kernel recorded on their way to its wrapper: the triangular solve and
the Cholesky through ``clrs_tpu_torch.dd.linalg`` (every caller of both;
``--kernel tri`` records (nw, B, n, m, trans), ``--kernel chol`` (nw, B,
n)); the split route's int8 product and cascade, the fused limb GEMM and
the limb extraction through ``clrs_tpu_torch.dd.limb_gemm`` (their only
caller; ``--kernel int8_gemm`` records (B, M, K, N), ``--kernel cascade``
(nw, B, m, n, form), ``--kernel limb_gemm`` (nw, B, m, k, n), ``--kernel
limb_extract`` (nw, B, d0, d1, side, layout, L), L the limbs of the product
the operand goes into); the three pl_map chains
through ``clrs_tpu_torch.solver.step`` (``--kernel plmap`` records (chain,
nw, L, n), chain one of add, axpy, residual, residual_corr); the expansion
ops through ``clrs_tpu_torch.dd.arith`` and ``clrs_tpu_torch.dd.linalg``
(every f32 caller; ``--kernel expmap`` records (op, nw, x shape, y shape),
op one of add, sub, mul, div, neg, symmetrize, y None for the one-operand
ops), the tree sums through ``clrs_tpu_torch.dd.linalg`` (``--kernel
tree_sum`` records (nw, shape, axis)), the fused forms through
``clrs_tpu_torch.dd.arith`` (``--kernel expfuse`` records (form, nw,
operand shapes, scale: None, a constant or its shape, mask shape)), the
fused tree sums through ``clrs_tpu_torch.dd.linalg`` (``--kernel
tree_fused`` records (nw, x, y, axis, acc, sub, scale_on, scale shape)) and
the commit's select (``--kernel select`` records (nw, leaf shapes)), the
f64 boundary through ``clrs_tpu_torch.solver.step`` and
``clrs_tpu_torch.dd.linalg`` (``--kernel expf64`` records (form, nw, shape,
acc), form one of sum, max_abs, split, acc whether max_abs folds an
accumulator in), and
the step-length eigensolver through ``clrs_tpu_torch.solver.step``
(``--kernel eig_lowest`` and ``eig_pairs`` record (B, n); with eig_pairs
the solve runs again on the certified route, which calls it). Then
it times
the kernel at every recorded shape on random inputs of that shape with
chip_smoke.py's ``time_ms`` (CUDA events around calls queued behind a spin
kernel): a solve on an SPD matrix's factor from the Cholesky kernel and
standard normal right-hand sides, the Cholesky on SPD matrices, the int8
product on limbs drawn from [-65, 65], the extraction on standard normal
words with rows scaled by powers of ten, the limb GEMM on such words'
limbs (from the plain extraction), the cascade on int32 C (form ``c``) or
diagonal sums (form ``diags``) drawn from +-2^24, the chains on standard
normal [L, n, n] words with mu and alpha as [L, 1, 1] broadcast scalars,
the expansion ops and tree sums on contiguous words of the recorded shapes
(word 0 over 16 decades, word k about 2^-24k of it), with {0,1} masks and
scales, the select with a true cond (every word moves), the eigensolvers on
random symmetric batches; for these and the f64 boundary (words as the
expansion ops', split sources standard normal f64) the plain version's
time and its bit identity with the kernel, and for the eigensolvers
cuSOLVER's time for the same function
(torch.linalg.eigvalsh's lowest column, torch.linalg.eigh) as well, and
for eig_pairs its two launches apart (the sweep kernel, the replay of its
rotation logs on V with the replay's bound) with the members' sweep
counts.
``--kernel`` takes a comma list (one solve records them all); ``--shape
kernel:a,b,...`` times a shape of that kernel besides (``--d 0``: no
solve, only those; an extraction's L may be left out, the L of an nw-word
product; a key of expfuse, tree_fused or select is a Python tuple, e.g.
``tree_fused:(5,(18432,),(18432,),None,(),False,None,None)``). Prints one JSON line per kernel: per shape the calls
per iteration, ms per call, ms per iteration and the bound of
chip_smoke.py's ``cost_*`` (the least time the card could take), and the
sums (per form for the solve, per chain for the chains). The package and
chip_smoke.py are imported from beside the script, so a copy of it in
another checkout times that checkout's kernels. On a machine with a card:

    python3 torch_kernel_timing.py --kernel tri --d 95 --iters 1
    python3 torch_kernel_timing.py --kernel chol,int8_gemm --d 95 --iters 1
    python3 torch_kernel_timing.py --kernel limb_gemm,limb_extract --d 95 --iters 1
    python3 torch_kernel_timing.py --kernel cascade,plmap --d 10 --iters 1
    python3 torch_kernel_timing.py --kernel chol --d 0 --shape chol:5,2,64
    python3 torch_kernel_timing.py --kernel limb_extract --d 0 --shape limb_extract:5,4,192,64,a,limb
    python3 torch_kernel_timing.py --kernel cascade --d 0 --shape cascade:5,4,22,22,diags
    python3 torch_kernel_timing.py --kernel expmap,tree_sum --d 95 --iters 1
    python3 torch_kernel_timing.py --kernel expfuse,tree_fused,select --d 95 --iters 1
    python3 torch_kernel_timing.py --kernel expf64 --d 40 --iters 1 --shape "expf64:('max_abs',5,(12,27,27),True)"
    python3 torch_kernel_timing.py --kernel eig_lowest,eig_pairs --d 95 --iters 1
    python3 torch_kernel_timing.py --kernel eig_lowest,eig_pairs --d 0 --shape eig_pairs:2,128
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

# kernel -> (the (module of clrs_tpu_torch, its kernels-module attribute)
# pairs recorded, the wrappers recorded)
RECORDED = {"tri": ((("dd.linalg", "K"),), ("tri_solve_batched",)),
            "chol": ((("dd.linalg", "K"),), ("chol_batched",)),
            "int8_gemm": ((("dd.limb_gemm", "K"),), ("int8_gemm",)),
            "limb_gemm": ((("dd.limb_gemm", "K"),), ("limb_gemm",)),
            "limb_extract": ((("dd.limb_gemm", "K"),), ("limb_extract",)),
            "cascade": ((("dd.limb_gemm", "K"),), ("cascade_from_c",)),
            "plmap": ((("solver.step", "dk"),),
                      ("plmap_add", "plmap_axpy", "plmap_residual")),
            "expmap": ((("dd.arith", "K"), ("dd.linalg", "K")),
                       ("ew_add", "ew_sub", "ew_mul", "ew_div", "ew_neg",
                        "ew_symmetrize")),
            "tree_sum": ((("dd.linalg", "K"),), ("tree_sum",)),
            "expfuse": ((("dd.arith", "K"),),
                        ("ew_fma", "ew_fms", "ew_msub", "ew_mms", "ew_sub2")),
            "tree_fused": ((("dd.linalg", "K"),), ("tree_sum_fused",)),
            "select": ((("dd.arith", "K"),), ("ew_select",)),
            "expf64": ((("solver.step", "dk"), ("dd.linalg", "K")),
                       ("expf64_sum", "expf64_max_abs", "expf64_split")),
            "eig_lowest": ((("solver.step", "dk"),), ("eig_lowest",)),
            "eig_pairs": ((("solver.step", "dk"),), ("eig_pairs",))}
FIELDS = {"tri": ("nw", "B", "n", "m", "trans"), "chol": ("nw", "B", "n"),
          "int8_gemm": ("B", "M", "K", "N"),
          "limb_gemm": ("nw", "B", "m", "k", "n"),
          "limb_extract": ("nw", "B", "d0", "d1", "side", "layout", "L"),
          "cascade": ("nw", "B", "m", "n", "form"),
          "plmap": ("chain", "nw", "L", "n"),
          "expmap": ("op", "nw", "x", "y"),
          "tree_sum": ("nw", "shape", "axis"),
          "expfuse": ("form", "nw", "shapes", "scale", "mask"),
          "tree_fused": ("nw", "x", "y", "axis", "acc", "sub", "scale_on",
                         "scale"),
          "select": ("nw", "shapes"),
          "expf64": ("form", "nw", "shape", "acc"),
          "eig_lowest": ("B", "n"), "eig_pairs": ("B", "n")}


def _shape(kernel, wrapper, args, kw):
    """The recorded key of one call."""
    if kernel == "tri":
        l, b = args[:2]
        trans = kw.get("trans", args[2] if len(args) > 2 else False)
        return (len(l),) + tuple(l[0].shape[:2]) + (b[0].shape[2],
                                                    bool(trans))
    if kernel == "chol":
        (a,) = args
        return (len(a),) + tuple(a[0].shape[:2])
    if kernel == "limb_gemm":
        a3, b3, _, nw = args
        Bt, _, m, k = a3.shape
        return (nw, Bt, m, k, b3.shape[3])
    if kernel == "limb_extract":
        words, L, side = args[:3]
        layout = kw.get("layout", args[3] if len(args) > 3 else "limb")
        return (len(words),) + tuple(words[0].shape) + (side, layout, L)
    if kernel == "cascade":
        C, eab, nw = args
        return (nw,) + tuple(eab.shape) + ("c",)
    if kernel == "plmap":
        chain = wrapper.split("_", 1)[1]
        words = args[2] if chain == "residual" else args[0]
        if chain == "residual" and len(args) > 3 and args[3] is not None:
            chain = "residual_corr"
        L, n = words[0].shape[:2]
        return (chain, len(words), L, n)
    if kernel == "expmap":
        op = wrapper.split("_", 1)[1]
        y = tuple(args[1][0].shape) if len(args) > 1 else None
        return (op, len(args[0]), tuple(args[0][0].shape), y)
    if kernel == "tree_sum":
        x, axis = args
        shape = tuple(x[0].shape)
        return (len(x), shape, axis % len(shape))
    if kernel == "expfuse":
        form = wrapper.split("_", 1)[1]
        n = 4 if form == "mms" else 3
        rest = list(args[n:]) + [None, None]
        if form == "sub2":
            sc = kw.get("c_scale", rest[0])
            mask = kw.get("mask", rest[1])
        else:
            sc, mask = None, kw.get("mask", rest[0])
        scale = (None if sc is None else tuple(sc.shape)
                 if hasattr(sc, "shape") else float(sc))
        return (form, len(args[0]), tuple(tuple(op[0].shape)
                                          for op in args[:n]),
                scale, None if mask is None else tuple(mask.shape))
    if kernel == "tree_fused":
        x, y, axis, acc, sub, scale, scale_on = (
            list(args) + [None, False, None, None])[:7]

        def sh(w):
            return None if w is None else tuple(w[0].shape)

        return (len(x), sh(x), sh(y), axis, sh(acc), bool(sub), scale_on,
                None if scale is None else tuple(scale.shape))
    if kernel == "select":
        cond, pairs = args
        return (len(pairs[0][0]), tuple(tuple(src[0].shape)
                                        for src, _ in pairs))
    if kernel in ("eig_lowest", "eig_pairs"):
        return tuple(args[0].shape[:2])
    if kernel == "expf64":
        form = wrapper.split("_", 1)[1]
        if form == "split":
            return (form, args[1], tuple(args[0].shape), False)
        acc = kw.get("acc", args[1] if len(args) > 1 else None)
        return (form, len(args[0]), tuple(args[0][0].shape), acc is not None)
    a, b = args
    return tuple(a.shape) + (b.shape[2],)


def _chain_args(key, rng, S):
    """A chain's operands as the step passes them: [L, n, n] words, mu and
    alpha as [L, 1, 1] broadcast scalars, a one-word mask."""
    import numpy as np
    import torch

    chain, nw, L, n = key
    x = S._words(rng, (L, n, n), nw)
    d = S._words(rng, (L, n, n), nw)
    if chain == "add":
        return (x, d)
    if chain == "axpy":
        return (x, d, tuple(c.expand(L, 1, 1) for c in S._split(
            np.asarray([[[0.9130357142857143]]]), 3)))
    mu = tuple(c.expand(L, 1, 1) for c in
               S._split(np.asarray([[[rng.random() * 1e3]]]), nw))
    mask = torch.ones((L, n, n), device="cuda")
    return (mu, mask, x) + ((d,) if chain == "residual_corr" else ())


def _cascade_args(key, rng, K):
    """int32 C [B, L m, L n] (or diagonal sums [B, nd, m, n]) and eab."""
    import numpy as np
    import torch

    nw, B, m, n, form = key
    L, nd = K.limb_params(nw)
    shape = (B, L * m, L * n) if form == "c" else (B, nd, m, n)
    src = rng.integers(-(1 << 24), 1 << 24, shape).astype(np.int32)
    eab = rng.integers(-8, 9, (B, m, n)).astype(np.int32)
    return (torch.from_numpy(src).to("cuda"), torch.from_numpy(eab).to("cuda"),
            nw)


def _expmap_args(key, rng, S):
    """Contiguous words of the recorded shapes: (x,) or (x, y)."""
    op, nw, xs, ys = key
    x = S._exp_words(rng, xs, nw)
    return (x,) if ys is None else (x, S._exp_words(rng, ys, nw))


def _mask01(rng, shape):
    import numpy as np
    import torch

    return torch.from_numpy(np.asarray(rng.integers(0, 2, shape),
                                       np.float32)).to("cuda")


def _expfuse_args(key, rng, S):
    """Contiguous words of the recorded shapes, the scale (the recorded
    constant, or a {0,1} word of its shape) and a {0,1} mask."""
    form, nw, shapes, scale, mask = key
    ops = [S._exp_words(rng, sh, nw) for sh in shapes]
    sc = (None if scale is None else _mask01(rng, scale)
          if isinstance(scale, tuple) else scale)
    mk = None if mask is None else _mask01(rng, mask)
    return tuple(ops) + ((sc,) if form == "sub2" else ()) + (mk,)


def _tree_fused_args(key, rng, S):
    nw, xs, ys, axis, accs, sub, scale_on, scs = key
    return (S._exp_words(rng, xs, nw),
            None if ys is None else S._exp_words(rng, ys, nw), axis,
            None if accs is None else S._exp_words(rng, accs, nw), sub,
            None if scs is None else _mask01(rng, scs), scale_on)


def _select_fns(key, rng, S, K):
    """ew_select and its plain version on one set of sources (cond true:
    every word moves) into two copies of one set of destinations, so that
    both can run on the same arguments and be compared."""
    import torch

    nw, shapes = key
    src = [S._exp_words(rng, sh, nw) for sh in shapes]
    dst = [S._exp_words(rng, sh, nw) for sh in shapes]
    dk = [tuple(c.clone() for c in d) for d in dst]
    cond = torch.ones((), dtype=torch.bool, device="cuda")
    return (lambda c, s, a, b: K.ew_select(c, zip(s, a)),
            lambda c, s, a, b: K.ew_select_plain(c, zip(s, b)),
            (cond, src, dk, dst))


def inputs(kernel, key, rng, S, K):
    """The call of the kernel at shape ``key`` on random inputs: (the name
    its launches are counted under, its wrapper, its plain version, the
    arguments)."""
    import numpy as np
    import torch

    if kernel == "tri":
        nw, B, n, m, trans = key
        # the factor by the Cholesky kernel where the solver would call it
        # (n < 96; its plain version, equal bit for bit, runs seconds a
        # shape on the card)
        chol = K.chol_batched if n < 96 else K.chol_plain
        lw, _ = chol(S._spd(rng, B, n, nw))
        bw = S._words(rng, (B, n, m), nw)
        return (K.TRI_FORMS[trans], K.tri_solve_batched, K.tri_solve_plain,
                (lw, bw, trans))
    if kernel == "chol":
        nw, B, n = key
        return ("chol_batched", K.chol_batched, K.chol_plain,
                (S._spd(rng, B, n, nw),))
    if kernel == "limb_gemm":
        nw, B, m, k, n = key
        L, _ = K.limb_params(nw)
        A3, ea = K.limb_extract_plain(S._words(rng, (B, m, k), nw, True), L,
                                      "a")
        B3, eb = K.limb_extract_plain(S._words(rng, (B, k, n), nw), L, "b")
        eab = (ea + eb).expand(B, m, n).contiguous()
        return ("limb_gemm", K.limb_gemm, K.limb_gemm_plain,
                (A3, B3, eab, nw))
    if kernel == "limb_extract":
        nw, B, d0, d1, side, layout, L = key
        w = S._words(rng, (B, d0, d1), nw, True)
        return ("limb_extract", K.limb_extract, K.limb_extract_plain,
                (w, L, side, layout))
    if kernel == "cascade":
        name = "cascade_from_c" if key[-1] == "c" else "cascade_from_diags"
        return (name, getattr(K, name), getattr(K, name + "_plain"),
                _cascade_args(key, rng, K))
    if kernel == "plmap":
        name = "plmap_" + key[0].replace("_corr", "")
        return (name, getattr(K, name), getattr(K, name + "_plain"),
                _chain_args(key, rng, S))
    if kernel == "expmap":
        name = "ew_" + key[0]
        return (name, getattr(K, name), getattr(K, name + "_plain"),
                _expmap_args(key, rng, S))
    if kernel == "tree_sum":
        nw, shape, axis = key
        return ("tree_sum", K.tree_sum, K.tree_sum_plain,
                (S._exp_words(rng, shape, nw), axis))
    if kernel == "expfuse":
        name = "ew_" + key[0]
        return (name, getattr(K, name), getattr(K, name + "_plain"),
                _expfuse_args(key, rng, S))
    if kernel == "tree_fused":
        return ("tree_sum_fused", K.tree_sum_fused, K.tree_sum_fused_plain,
                _tree_fused_args(key, rng, S))
    if kernel == "select":
        return ("ew_select",) + _select_fns(key, rng, S, K)
    if kernel in ("eig_lowest", "eig_pairs"):
        return (kernel, getattr(K, kernel), getattr(K, kernel + "_plain"),
                (eig_input(kernel, key, rng),))
    if kernel == "expf64":
        form, nw, shape, acc = key
        name = "expf64_" + form
        if form == "split":
            a = (torch.from_numpy(rng.standard_normal(shape)).to("cuda"), nw)
        else:
            a = (S._exp_words(rng, shape, nw),) + (
                (torch.ones((), dtype=torch.float64, device="cuda"),)
                if acc else ())
        return (name, getattr(K, name), getattr(K, name + "_plain"), a)
    B, M, k, N = key
    a, b = (torch.from_numpy(rng.integers(-65, 66, s).astype(np.int8))
            .to("cuda") for s in ((B, M, k), (B, k, N)))
    return ("int8_gemm", K.int8_gemm, K.int8_gemm_plain, (a, b))


def eig_input(kernel, key, rng):
    """A random symmetric batch [B, n, n] on the card: float64 for
    eig_lowest, float32 for eig_pairs."""
    import numpy as np
    import torch

    B, n = key
    a = rng.standard_normal((B, n, n))
    return torch.tensor(a + np.swapaxes(a, 1, 2), device="cuda",
                        dtype=torch.float64 if kernel == "eig_lowest"
                        else torch.float32)


def eig_pairs_parts(A, reps, S, K):
    """eig_pairs' two launches timed apart on A: the sweep kernel, the
    replay of its rotation logs (with its bound) and the members' sweep
    counts."""
    n = A.shape[-1]
    _, log = K.eig_pairs_sweeps(A)
    sweeps = log[:, K.eig_pairs_log_layout(n)[2]].long().tolist()
    return dict(sweeps=sweeps,
                sweep_ms=S.time_ms(lambda: K.eig_pairs_sweeps(A), reps),
                replay_ms=S.time_ms(lambda: K.eig_pairs_vec(log, n), reps),
                replay_bound_ms=S.bound(*S.cost_eig_pairs_vec(
                    A.shape[0], n))[0])


def library_eig(kernel):
    """The PyTorch call computing the same function: cuSOLVER's
    torch.linalg.eigvalsh (its lowest column) or torch.linalg.eigh."""
    import torch

    if kernel == "eig_lowest":
        return lambda A: torch.linalg.eigvalsh(A)[:, 0]
    return torch.linalg.eigh


def _bound_ms(kernel, key, S, K):
    """chip_smoke.py's bound of one call at shape ``key``."""
    if kernel == "eig_lowest":
        return S.bound(*S.cost_eig_lowest(*key))[0]
    if kernel == "eig_pairs":
        return S.bound(*S.cost_eig_pairs(*key))[0]
    if kernel == "tri":
        nw, B, n, m, trans = key
        return S.bound(*S.cost_tri(nw, B, n, m, trans))[0]
    if kernel == "chol":
        return S.bound(*S.cost_chol(*key))[0]
    if kernel == "int8_gemm":
        return S.bound(*S.cost_int8_gemm(*key))[0]
    if kernel == "limb_gemm":
        nw, B, m, k, n = key
        return S.bound(*S.cost_limb_gemm(nw, *K.limb_params(nw), B, m, k,
                                         n))[0]
    if kernel == "cascade":
        nw, B, m, n, form = key
        return S.bound(*S.cost_cascade(nw, *K.limb_params(nw), B, m, n,
                                       form == "c"))[0]
    if kernel == "plmap":
        import numpy as np

        chain, nw, L, n = key
        add, mul = S.exp_add_ops(nw), S.exp_mul_ops(nw)
        ops = {"add": add, "axpy": 1 + mul + add, "residual": 2 * nw + add,
               "residual_corr": 2 * nw + 2 * add}[chain]
        args = _chain_args(key, np.random.default_rng(0), S)
        return S.bound(*S.cost_plmap(args, nw, L * n * n, ops))[0]
    if kernel == "expmap":
        return S.bound(*S.cost_expmap(*key))[0]
    if kernel == "tree_sum":
        return S.bound(*S.cost_tree_sum(*key))[0]
    if kernel == "expfuse":
        return S.bound(*S.cost_expfuse(*key))[0]
    if kernel == "tree_fused":
        return S.bound(*S.cost_tree_fused(*key))[0]
    if kernel == "select":
        return S.bound(*S.cost_select(*key))[0]
    if kernel == "expf64":
        return S.bound(*S.cost_expf64(*key))[0]
    nw, B, d0, d1, side, _, L = key
    return S.bound(*S.cost_extract(nw, L, B, d0, d1, side))[0]


def record(kernel, run):
    """Calls of ``kernel`` per shape while ``run()`` runs: its caller's
    kernels module is wrapped in one that counts the wrappers' shapes on
    their way to them (recordings nest)."""
    import importlib

    callers, wrappers = RECORDED[kernel]
    seen = collections.Counter()

    class Recording:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, name):
            fn = getattr(self.inner, name)
            if name not in wrappers:
                return fn

            def recorded(*a, **kw):
                seen[_shape(kernel, name, a, kw)] += 1
                return fn(*a, **kw)

            return recorded

    patched = []
    for modname, attr in callers:
        caller = importlib.import_module(f"clrs_tpu_torch.{modname}")
        patched.append((caller, attr, getattr(caller, attr)))
        setattr(caller, attr, Recording(patched[-1][2]))
    try:
        run()
    finally:
        for caller, attr, inner in reversed(patched):
            setattr(caller, attr, inner)
    return seen


def _parse_key(kernel, text):
    """A --shape key: comma-separated values, ints where they read as ints;
    a shape of expmap or tree_sum written as 2x22x1 ("-" the shape (),
    "none" no second operand), e.g. expmap:mul,5,2x22x1,2x22x11 or
    tree_sum:5,242,0."""
    def dims(v):
        return () if v == "-" else tuple(int(d) for d in v.split("x"))

    if kernel in ("expfuse", "tree_fused", "select", "expf64"):
        import ast

        return tuple(ast.literal_eval(text))
    vals = text.split(",")
    if kernel == "expmap":
        op, nw, xs, ys = vals
        return (op, int(nw), dims(xs), None if ys == "none" else dims(ys))
    if kernel == "tree_sum":
        nw, shape, axis = vals
        return (int(nw), dims(shape), int(axis))
    return tuple(int(v) if v.lstrip("-").isdigit() else v for v in vals)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", default="tri",
                    help=f"comma list of {', '.join(sorted(RECORDED))}")
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shape", action="append", default=[],
                    help="kernel:a,b,... timed besides the recorded shapes")
    args = ap.parse_args()
    kernels = args.kernel.split(",")
    extra = [(k, _parse_key(k, dims))
             for k, dims in (x.split(":") for x in args.shape)]
    for k in kernels + [k for k, _ in extra]:
        if k not in RECORDED:
            ap.error(f"unknown kernel {k!r}")
    # an extraction's L defaults to the L of an nw-word product
    extra = [(k, key + (-(-(24 * key[0] + 21) // 7),)
              if k == "limb_extract" and len(key) == 6 else key)
             for k, key in extra]
    sys.path.insert(0, str(Path(__file__).resolve().parent))

    import numpy as np
    import torch

    import chip_smoke as S
    import clrs_tpu_torch as ct
    from clrs_tpu_torch.dd import kernels as K
    from clrs_tpu_torch.examples import delsarte_problem

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    seen = {k: collections.Counter() for k in kernels}
    if args.d:
        problem = delsarte_problem(3, args.d, Fraction(1, 2))

        from clrs_tpu_torch.solver import step as TS

        def solve():
            return ct.solvesdp(
                problem, device="cuda", omega_p=100, omega_d=100,
                dual_error_threshold=1e-12, primal_error_threshold=1e-12,
                maxiterations=args.iters, verbose=False)

        def run(ks):
            if not ks:
                solve()
                if "eig_pairs" in kernels:    # the certified route's too
                    TS._STEPLEN_VERIFIED = True
                    try:
                        solve()
                    finally:
                        TS._STEPLEN_VERIFIED = None
                return
            seen[ks[0]] = record(ks[0], lambda: run(ks[1:]))

        run(kernels)
    rng = np.random.default_rng(0)
    for k in dict.fromkeys(kernels + [k for k, _ in extra]):
        rows, sums = [], collections.Counter()
        keys = list(sorted(seen.get(k, {}).items(), key=repr)) + [
            (key, 0) for kk, key in extra if kk == k]
        for key, calls in keys:
            _, fn, plain, a = inputs(k, key, rng, S, K)
            ms = S.time_ms(lambda: fn(*a), args.reps)
            per_it = calls / args.iters
            row = dict(zip(FIELDS[k], key), calls_per_iteration=per_it,
                       ms=ms, ms_per_iteration=per_it * ms)
            if k in ("eig_lowest", "eig_pairs", "expf64"):
                same, _ = S._compare(S._flat(fn(*a)), S._flat(plain(*a)))
                row.update(bit_identical_to_plain=same,
                           plain_ms=S.time_ms(lambda: plain(*a), 1))
            if k in ("eig_lowest", "eig_pairs"):
                lib = library_eig(k)
                row["library_ms"] = S.time_ms(lambda: lib(*a), args.reps)
            if k == "eig_pairs":
                row.update(eig_pairs_parts(a[0], args.reps, S, K))
            row["bound_ms"] = _bound_ms(k, key, S, K)
            rows.append(row)
            form = (("transposed" if key[-1] else "forward") if k == "tri"
                    else key[0] if k in ("plmap", "expmap", "expfuse",
                                         "expf64")
                    else "all")
            sums[form] += per_it * ms
        print(json.dumps({
            "card": card, "checkout": str(Path(__file__).resolve().parent),
            "kernel": k, "problem": f"delsarte(3,{args.d})" if args.d
            else None, "iters": args.iters, "shapes": rows,
            "ms_per_iteration": dict(sorted(sums.items())),
        }), flush=True)


if __name__ == "__main__":
    main()
