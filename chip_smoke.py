"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from clrs_tpu_torch/csrc (one nvcc per
     source, all at once), with its seconds;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the main path, at nw = 5 and 8 and at the edge shapes each
     kernel treats apart (bit-identical is the tolerance, ok flags and the
     extraction's NaN rows and columns included; the cascade's one-element,
     m or n 1, ragged and B-300 tilings and its largest diagonal sums; the
     chains' broadcast, stacked, transposed and sliced operands), the split
     GEMM route against the fused one, and at its main-path shapes (at
     least one per TPU kernel it replaces; every int8_gemm, limb_gemm and
     limb_extract shape of a delsarte(3,95) iteration) its time, its plain
     version's time (time_ms), its bound on this card (bound) and a library
     call's time where one PyTorch call computes the same function; the
     step's expansion arithmetic (csrc/expmap.cu: expmap<NW, OP> for add,
     sub, mul, div, neg and symmetrize; csrc/exptree.cu: tree_sum<NW, PRO>
     behind tree_sum and tree_sum_fused; csrc/expfuse.cu: expfuse<NW,
     FORM> behind ew_fma, ew_fms, ew_msub, ew_mms and ew_sub2, expselect<NW>
     behind ew_select) bit for bit at every shape one eager delsarte(3,10)
     and one delsarte(3,95) chunk iteration (step and commit) give its
     wrappers (recorded on the way), at nw 5 and 8, timed at the nw-5
     (3,95) shapes, and at numel 0, (), stride-0 broadcasts, transposed
     operands, odd n, both tree routes (block and cluster) and the level
     route, the cluster route at 18,432 entries (nw 5) and 32,768 (nw 5
     and 8) with the product and the accumulate, and a false commit; the
     step-length eigensolver (csrc/eig.cu: eig_lowest, the f64 route's
     lowest eigenvalue, and eig_pairs, the certified route's f32 Jacobi
     eigenpairs: the sweeps on A, then eig_pairs_vec, the replay of their
     rotations on V) bit for bit at every shape one (3,10) and one (3,95)
     chunk iteration gives them on both routes and both substrates,
     timed at the nw-5 (3,95) shape beside cuSOLVER's eigvalsh and eigh
     (eig_pairs' two launches apart), and at n 1 and 2, a diagonal batch,
     a zero member, a repeated lowest eigenvalue, n 137 and 200
     (eig_lowest's global-memory route), eig_lowest within 8 n 2^-53
     ||A||_F of cuSOLVER's eigvalsh at each; the kernels beside cuSOLVER
     alone at (B, n) (4, 128) and (2, 128);
  4. delsarte(3, 10) through clrs_tpu_torch.solvesdp (the card is its
     default device; each iteration is one replay of the step's CUDA
     graph, the eigensolver kernel inside it):
     error code 0, Optimal, objective within 1e-9 of 13.15831434739031 in
     28 iterations, every kernel of its path launched (counts set to 0
     just before, read just after; a graph replay counts the launches its
     capture recorded), no plain version run and no torch.linalg
     eigensolver (cuSOLVER) on the card, here and in every phase that
     counts kernels;
  5. three IPM iterations of delsarte(3, 95) (P = 192, SOS blocks 96/95:
     blocked Cholesky and solves, the fused GEMM route), counted the same
     way;
  6. the graphs against the eager step (make_step_body): delsarte(3,10)'s
     first step word for word and its solve at sync_every=4 (phase 4's
     checks); delsarte(3,95)'s mu, alpha_d and alpha_p of phase 5 equal
     the eager step's to the last digit; then, at both problems, in turns
     eager, graph, graph, eager, wall ms per iteration, capture seconds,
     host calls (one replay, no more than one flag copy) and kernel
     launches per iteration and peak memory, and
     host launch calls and device kernels of one profiled iteration;
  7. the f64 substrate's ops (clrs_tpu_torch.dd.f64ops) and slice GEMM
     (clrs_tpu_torch.dd.slice_gemm) on the card against the same functions
     on the CPU, bit for bit: nw 2, 4 and 5, magnitudes 1e-150..1e150
     mixed in one expansion, the slice GEMM at k 1, 22 and 192;
  8. delsarte(3, 10) at substrate="f64" (nw 2) through solvesdp at
     sync_every 1: code 0, Optimal, objective within 1e-9 of the oracle in
     the JAX f64 solve's 28 iterations, no f32 kernel or plain version run
     (eig_lowest, which the f64 route shares, launched);
  9. three iterations of delsarte(3, 95) at f64 nw 2 (blocked f64
     factorizations at P = 192): ok, finite mu, alpha > 0, and mu, alpha_d,
     alpha_p within rel 1e-12 of phase 5's f32 values; then the slice GEMM
     card against CPU at the deepest and the largest of its shapes, and
     its time at the largest beside its DGEMM's time and bound;
 10. min_f(2) at the reference's literal defaults (prec 256: 5 f64
     words): pdOpt, code 0, objective within 1e-9, gap below 1e-15;
 11. the f64 graphs against the eager f64 step (delsarte(3,10)'s first
     step word for word), and phase 6's rows for f64 at both problems,
     with one profiled graph iteration each (torch_step_profile.py);
 12. the exact-certificate path: the reference's rounding oracles (GW
     max-cut 9/4, delsarte_round(8,3,1/2) 240, delsarte over Q(sqrt5) 12
     and 120, theta(C5) and the POVM through the frontend Model, the
     three-point bound 10) solved on the card at the f32 default with
     their reference tests' settings and rounded to their exact values on
     the host (one line each: code, iterations, solve and rounding
     seconds, the RREF's native or Python route; every kernel of
     PATH_3_10 launched, three-point's PATH_3_95, and no plain version);
     then the SDPA fixture solved on the card, its objective within 1e-12
     of the CPU solve's; then every kernel against its plain version, bit
     for bit, at every shape those solves gave its wrapper (recorded on
     the way to it);
 13. sharded solves through solvesdp(mesh=make_mesh(n)), every rank
     eager (graphs: off (mesh)): (13a) one NCCL rank in this process,
     three iterations of delsarte(3,95) by row panels; (13b) 2, then 4
     gloo rank processes on the one card (words staged through host
     memory), each problem compiled once here: delsarte(3,95) by row
     panels (96 and 48 rows a rank, three iterations), delsarte(3,10)
     solved on 2 ranks (row panels) and 4 iterations of it on 4 (class
     and scalar-pack axes; mu/alpha within rel 1e-12 of the one-process
     card solve's), multi_cluster_test_problem(16, 8) solved on 4
     (cluster and class axes). mu/alpha within rel 1e-8 of phase 5's on
     row panels; the full solves' codes, the one-process card solve's
     iterations and
     objective (rel 1e-12; delsarte(3,10) within 1e-10 of the oracle);
     every rank held to check_counts; one line per rank (backend, world
     size, axes, s/iteration, words moved and collectives per iteration);
     then every kernel against its plain version at every new shape the
     ranks gave it; 13a runs after phase 12's rounding, whose Decimal
     precision no longer outlasts it (ROADMAP C3);
 14. the certified step-length route (clrs_tpu_torch.solver.step.
     _STEPLEN_VERIFIED = True, the JAX package's TPU route: f32
     eigenpairs from the eig_pairs kernel, certified in the same graph
     by exact limb GEMMs): delsarte(3,10) through the graph (code
     0, Optimal, within 1e-9 of the oracle); three iterations of
     delsarte(3,95), every certified bound within [-1e-4, 1e-12]
     (1 + |lambda|) of the f64 eigvalsh lambda_min of its member, the
     graphs' mu/alpha within rel 1e-12 of the eager run's;
     delsarte(3,4) at f32 prec 212 (nw 8) with thresholds 1e-20: code 0,
     pdOpt; graph wall ms per iteration on both routes at both problems,
     in turns; phase 3 holds the kernels at the route's word counts
     (limb_extract of 1-4-word operands at L 10, 21, 31, cascade<2, true>,
     limb_gemm_fused<2>) against their plain versions and times them at
     the route's shapes;
 15. the f32 oracles of tests/test_solver_examples.py with their
     settings: min_f(2) (-2.1129138814 within 1e-6, code 0),
     cohnelkies(8,3) at nw 5 (0.3255058828303 within 1e-8) and nw 8 (the
     same, code 0); one line each (the d-15 sphere-packing oracles at f64
     nw 4 take minutes each: tests/test_torch_gpu_examples.py);
 16. solver/timing.py: phase_breakdown at delsarte(3,95), f32 and f64, and
     solvesdp(testing=True)'s timing line and table at delsarte(3,10);
     then every kernel against its plain version at every new shape that
     phases 14-16 gave its wrapper;
 17. the benchmark (torch_bench.py beside this script): bench_problem at
     delsarte(3,10), f32 nw 5 and f64 nw 2, a few iterations a chunk:
     every chunk commits all its iterations with code 0, the int8 and f64
     tensor-core ops per iteration are positive and both MFUs lie in
     (0, 1]; then solvesdp(substrate=None) on the card gives phase 4's
     solve word for word (code, iterations, objective). The (3,127) tiers
     are torch_bench.py's own (their host build alone takes minutes).
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from fractions import Fraction

DELSARTE_3_10 = 13.15831434739031


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


SPIN_CYCLES_PER_S = 2e9      # clock64 cycles per second at most (H100 boost)


def time_ms(fn, reps=5):
    """Milliseconds per call of ``fn`` on the card: CUDA events around
    ``reps`` calls, after a warm-up, queued behind a spin kernel that lasts
    about twice as long as the host takes to issue them. The device then
    runs the calls back to back, so the host's time between launches does
    not count while the launch queue holds them; a plain version that
    issues thousands of launches per call overflows the queue, and its time
    is the host's. The garbage collector is held off while the calls are
    issued: a collection longer than the spin would be timed."""
    import gc

    import torch

    fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin_s = min(2 * reps * (time.perf_counter() - h0), 0.2)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    collecting = gc.isenabled()
    gc.disable()
    try:
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
    finally:
        if collecting:
            gc.enable()
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------------------
# bounds: the least time one H100 could take for a kernel's work, the larger
# of its bytes over the memory rate and its operations over their unit's
# peak (NVIDIA's H100 SXM data sheet, dense rates at the full 700 W limit).
# Bytes: each input element the function needs read once, each output
# written once. Operations: closed forms of the algorithm each kernel runs
# (clrs_tpu_torch/dd/ops.py, which csrc/expansion.cuh mirrors op for op),
# one per f32 or int32 arithmetic, compare or bit operation, and two per
# int8 multiply-add.
# ---------------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"scalar": 67e12,   # f32 outside the tensor cores; int32 alike
                  "f64": 34e12,      # f64 outside the tensor cores
                  "int8": 1979e12}   # int8 tensor-core operations


def bound(nbytes, ops):
    """(bound_ms, 'bytes' or 'operations'). The units run concurrently, so
    the operations take as long as the busiest unit."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(n / PEAK_OPS_PER_S[k] for k, n in ops.items())
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def _vec_sum(k):
    return 6 * (k - 1)                       # k - 1 two_sums of 6


def _renorm(k, w):
    return 3 * _vec_sum(k) + (k - w)         # three sweeps, then the tail fold


def exp_add_ops(w):
    """One w-word exp_add (or exp_sub: the negation folds into the sum)."""
    return 6 * w + _renorm(2 * w, w)


def exp_mul_ops(w):
    """One w-word exp_mul: the splits, the two_prods (9 each) of the kept
    diagonals, the last column, and the renormalisation."""
    if w == 1:
        return 1
    return (4 * (w - 1) + 9 * w * (w - 1) // 2 + (3 * w - 2)
            + _renorm((w - 1) ** 2 + 1, w))


def _mul_f32_ops(w):
    """exp_mul_f32 by a host constant (its split is free)."""
    return 11 * (w - 1) + 2 + _renorm(2 * w - 2, w)


def _pow2_ops(w, steps=3):
    return 5 * steps + w * steps             # factors, then w words scaled


def _widths(nw):
    w, out = 1, []
    while w < nw:
        w = min(2 * w, nw)
        out.append(w)
    return out


def exp_rsqrt_ops(nw):
    core = 2 + sum(1 + 2 * exp_mul_ops(w) + 2 + exp_add_ops(w)
                   + _mul_f32_ops(w) + exp_mul_ops(w) + exp_add_ops(w)
                   for w in _widths(nw))
    return 5 + 2 * _pow2_ops(nw) + 1 + core


def exp_div_ops(nw):
    core = 1 + sum(1 + 2 * exp_mul_ops(w) + 2 + 2 * exp_add_ops(w)
                   for w in _widths(nw))
    return 4 + 2 * _pow2_ops(nw) + core + 3 * exp_mul_ops(nw) \
        + 2 * exp_add_ops(nw)


def _fold_ops(nw, ndiag):
    """The cascade's fold of ndiag int32 sums into nw words, per element:
    per sum the split into halves, the scale 2^sc (four clamped factors
    shared by both halves), one (nw + 4)-term vec_sum and two adds; then two
    sweeps and the tail."""
    return ndiag * (37 + _vec_sum(nw + 4)) + 2 * _vec_sum(nw + 2) + 2


def _npairs(L, ndiag):
    """Limb pairs (ta, tb) on the kept diagonals ta + tb < ndiag."""
    return sum(min(d, L - 1) - max(0, d - L + 1) + 1 for d in range(ndiag))


def _nbytes(t):
    """Bytes of the distinct elements a tensor view addresses (a broadcast
    axis, stride 0, is read once)."""
    n = 1
    for s, st in zip(t.shape, t.stride()):
        n *= s if st != 0 else 1
    return n * t.element_size() if t.numel() else 0


def _tree_adds(lo, hi):
    """exp_adds of the transposed solve's halving tree over rows [lo, hi),
    summed over the rows i solved, that have a nonzero operand: node
    [lo, hi) holds a row r > i for the hi - 1 rows i < hi - 1 (two zero
    subtrees add up to +0)."""
    if hi - lo == 1:
        return 0
    mid = lo + (hi - lo) // 2
    return (hi - 1) + _tree_adds(lo, mid) + _tree_adds(mid, hi)


def cost_extract(nw, L, B, d0, d1, side):
    rows = B * (d0 if side == "a" else d1)
    el = B * d0 * d1
    ops = el * (2 + 4 * nw + L * (nw + _vec_sum(nw) + 3)) + rows * 25
    return 4 * nw * el + L * el + 4 * rows, {"scalar": ops}


def cost_limb_gemm(nw, L, nd, B, m, k, n):
    return (B * L * (m * k + k * n) + 4 * B * m * n * (1 + nw),
            {"int8": 2 * _npairs(L, nd) * B * m * n * k,
             "scalar": B * m * n * _fold_ops(nw, nd)})


def cost_int8_gemm(B, M, K, N):
    return B * (M * K + K * N + 4 * M * N), {"int8": 2 * B * M * N * K}


def cost_cascade(nw, L, nd, B, m, n, from_c):
    """FROM_C reads only the kept limb-pair tiles of C and adds them up;
    FROM_DIAGS reads the nd sums."""
    tiles = _npairs(L, nd) if from_c else nd
    ops = B * m * n * (_fold_ops(nw, nd) + (tiles - nd))
    return 4 * B * m * n * (tiles + 1 + nw), {"scalar": ops}


def cost_plmap(args, nw, numel, chain_ops):
    """A chain over ``numel`` output elements of nw words; broadcast
    operands are read once."""
    nbytes = sum(_nbytes(c) for c in _flat(args)) + 4 * nw * numel
    return nbytes, {"scalar": numel * chain_ops}


def _numel(shape):
    return math.prod(shape) if shape is not None else 0


def cost_expmap(op, nw, xs, ys):
    """One expansion op on contiguous words of shapes xs and ys (ys None:
    one operand): each word read once, the broadcast output written once;
    per output element the op's chain."""
    out = xs if ys is None else tuple(
        max(a, b) if min(a, b) else 0 for a, b in zip(
            (1,) * (len(ys) - len(xs)) + tuple(xs),
            (1,) * (len(xs) - len(ys)) + tuple(ys)))
    if op == "symmetrize":
        out = xs
    per = {"add": exp_add_ops(nw), "sub": exp_add_ops(nw),
           "mul": exp_mul_ops(nw), "div": exp_div_ops(nw), "neg": nw,
           "symmetrize": exp_add_ops(nw) + nw}[op]
    n_out = _numel(out)
    return (4 * nw * (_numel(xs) + _numel(ys) + n_out),
            {"scalar": n_out * per})


def cost_tree_sum(nw, shape, axis):
    """A tree sum along ``axis``: the input read once, one word set a
    column written; n - 1 expansion adds a column."""
    n = shape[axis]
    M = _numel(shape) // n if n else _numel(shape[:axis] + shape[axis + 1:])
    return (4 * nw * (_numel(shape) + M),
            {"scalar": M * max(n - 1, 0) * exp_add_ops(nw)})


def _bshape(*shapes):
    """The broadcast of shapes (None left out)."""
    shapes = [tuple(s) for s in shapes if s is not None]
    nd = max((len(s) for s in shapes), default=0)
    out = []
    for d in range(nd):
        dims = [s[d - nd + len(s)] for s in shapes if d - nd + len(s) >= 0]
        out.append(0 if 0 in dims else max(dims))
    return tuple(out)


FUSE_CHAIN = {"fma": ("mul", "add"), "fms": ("mul", "add"),
              "msub": ("mul", "add"), "mms": ("mul", "mul", "add"),
              "sub2": ("add", "add")}


def cost_expfuse(form, nw, shapes, scale, mask):
    """One fused form (csrc/expfuse.cu): each operand word, the scale and
    the mask read once, the broadcast output written once; per output
    element the form's ops, the scale's and the mask's nw multiplies."""
    out = _bshape(*shapes, scale if isinstance(scale, tuple) else None,
                  mask)
    n_out = _numel(out)
    per = sum(exp_mul_ops(nw) if op == "mul" else exp_add_ops(nw)
              for op in FUSE_CHAIN[form])
    per += nw * ((scale is not None) + (mask is not None))
    nbytes = (4 * nw * (sum(_numel(sh) for sh in shapes) + n_out)
              + 4 * (_numel(scale) if isinstance(scale, tuple) else 0)
              + 4 * (_numel(mask) if mask is not None else 0))
    return nbytes, {"scalar": n_out * per}


def cost_tree_fused(nw, xs, ys, axis, accs, sub, scale_on, scs):
    """acc +- sum of x s y over ``axis`` (csrc/exptree.cu): x, y, the
    scale and acc read once, one word set a column written; per column n
    products, n - 1 adds and the accumulate."""
    shape = _bshape(xs, ys, scs)
    if not shape:
        a0, a1 = 0, 0
    elif axis is None:
        a0, a1 = 0, len(shape)
    else:
        axes = sorted(a % len(shape) for a in ((axis,) if isinstance(
            axis, int) else axis))
        a0, a1 = axes[0], axes[-1] + 1
    n = _numel(shape[a0:a1])
    M = _numel(shape[:a0] + shape[a1:])
    per_col = (max(n - 1, 0) * exp_add_ops(nw)
               + (n * exp_mul_ops(nw) if ys is not None else 0)
               + (n * nw if scs is not None else 0)
               + (exp_add_ops(nw) if accs is not None else 0))
    nbytes = (4 * nw * (_numel(xs) + _numel(ys) + _numel(accs) + M)
              + 4 * _numel(scs))
    return nbytes, {"scalar": M * per_col}


def cost_expf64(form, nw, shape, acc):
    """One expf64 conversion (csrc/expf64.cu): every word and the f64
    values read once, the result written once; per element the nw exact
    casts and nw - 1 f64 adds (SUM, MAXABS, with |.| and the max), or
    three roundings and three f64 subtractions (SPLIT)."""
    n = _numel(shape)
    if form == "split":
        return 8 * n + 4 * nw * n, {"f64": 6 * n}
    out = 8 if form == "max_abs" else 8 * n
    per = 2 * nw - 1 + (2 if form == "max_abs" else 0)
    return 4 * nw * n + out + 8 * bool(acc), {"f64": n * per}


def cost_select(nw, shapes):
    """The commit with cond true (every word moves): each source word
    read, each destination word written, once."""
    return 8 * nw * sum(_numel(sh) for sh in shapes) + 1, {"scalar": 0}


def cost_chol(nw, B, n):
    """Both triangles of each trailing update: the next pivot row reads the
    upper one, and expansion products are not symmetric bit for bit."""
    per = n * (nw + 1 + exp_rsqrt_ops(nw) + exp_mul_ops(nw))
    per += sum(2 * r * exp_mul_ops(nw) + r * r * (exp_mul_ops(nw)
                                                  + exp_add_ops(nw))
               for r in range(n))
    return 8 * nw * B * n * n + 4 * B, {"scalar": B * per}


def cost_tri(nw, B, n, m, trans):
    """L's lower triangle read; per column the products of the rows below
    each pivot and their sums (the transposed form's tree adds with a
    nonzero operand), then one scaling per row."""
    mul, add = exp_mul_ops(nw), exp_add_ops(nw)
    sums = _tree_adds(0, n) if trans else n * (n - 1) // 2
    per_col = n * (n - 1) // 2 * mul + sums * add + n * (mul + add * trans)
    ops = B * (n * exp_div_ops(nw) + m * per_col)
    return 4 * nw * B * (n * (n + 1) // 2 + 2 * n * m), {"scalar": ops}


# The eigensolvers' bounds count the work the function needs by the
# standard direct method (LAPACK's counts), not what the kernels' own
# algorithms do: multisection and Jacobi do more than that work.
LAPACK_BISECTION_COUNTS = 53   # dstebz's halvings to f64 precision


def cost_eig_lowest(B, n):
    """Each member read once, lambda_min written. dsytrd's
    tridiagonalization, 4 m^2 operations a column (m = n - 1 - k, about
    4/3 n^3 in all), then bisection's 53 Sturm counts of 5 operations a
    row; f64."""
    ops = sum(4 * m * m for m in range(1, n))
    ops += LAPACK_BISECTION_COUNTS * 5 * n
    return 8 * B * n * n + 8 * B, {"f64": B * ops}


def cost_eig_pairs(B, n):
    """Each member read once, eigenvalues and vectors written. A direct
    method's f32 eigenpairs (tridiagonalization, implicit QR and the
    back-transformation: about 9 n^3 operations, Golub and Van Loan
    8.3.3) at the f32 rate."""
    return 4 * B * (2 * n * n + n), {"scalar": B * 9 * n ** 3}


def cost_eig_pairs_vec(B, n):
    """The eigenvectors of eig_pairs' call, which its replay launch forms:
    their share of the direct method's work, not the replay's own (the
    9 n^3 of cost_eig_pairs less the 4/3 n^3 that the eigenvalues alone
    take, Golub and Van Loan 8.3.3) at the f32 rate, the ranks read and
    the eigenvectors written."""
    return 8 * B * n + 4 * B * n * n, {"scalar": B * (9 * n ** 3
                                                       - 4 * n ** 3 // 3)}


def _split(v, nw):
    """f64 values -> nw f32 words on the card (successive rounding)."""
    import numpy as np
    import torch

    ws = []
    for _ in range(nw):
        w = v.astype(np.float32)
        ws.append(torch.from_numpy(w).to("cuda"))
        v = v - w.astype(np.float64)
    return tuple(ws)


def _words(rng, shape, nw, scale_rows=False):
    v = rng.standard_normal(shape)
    if scale_rows:
        v = v * 10.0 ** rng.integers(-6, 6, shape[:-1] + (1,))
    return _split(v, nw)


def _chain_words(rng, shape, nw, form, scale):
    """nw words [L, n, n] on the card laid out as ``form`` says: separate
    contiguous tensors, views of one word-major stack, transposed views,
    views sliced out of larger planes (pointers off alignment), or one
    matrix broadcast over L."""
    import numpy as np
    import torch

    L, n, _ = shape
    v = rng.standard_normal(shape) * scale
    if form == "stack":
        st = torch.stack(_split(v, nw), 1).contiguous()
        return tuple(st[:, w] for w in range(nw))
    if form == "transposed":
        return tuple(c.transpose(1, 2) for c in
                     _split(v.transpose(0, 2, 1).copy(), nw))
    if form == "sliced":
        big = np.zeros((L, n + 1, n + 1))
        big[:, 1:, 1:] = v
        return tuple(c[:, 1:, 1:] for c in _split(big, nw))
    if form == "shared":
        return tuple(c.expand(L, n, n) for c in _split(v[:1], nw))
    return _split(v, nw)


def _exp_words(rng, shape, nw):
    """nw f32 words of ``shape`` on the card, every word in use: word 0
    over 16 decades, word k about 2^-24k of it (a nonzero leading word:
    a divisor)."""
    import numpy as np
    import torch

    w0 = np.asarray(rng.standard_normal(shape)) * 10.0 ** np.asarray(
        rng.integers(-8, 8, shape))
    ws = [w0] + [w0 * np.asarray(rng.standard_normal(shape)) * 2.0 ** (-24 * k)
                 for k in range(1, nw)]
    return tuple(torch.from_numpy(np.asarray(w, np.float32)).to("cuda")
                 for w in ws)


def _spd(rng, B, n, nw):
    import numpy as np

    a = rng.standard_normal((B, n, n))
    return _split(a @ a.transpose(0, 2, 1) + n * np.eye(n), nw)


def _indefinite(rng, B, n, nw):
    """B SPD members, the last one L D L^T with unit lower L whose pivot
    n // 2 is -1 while its diagonal entry there starts positive."""
    import numpy as np

    a = rng.standard_normal((B, n, n))
    v = a @ a.transpose(0, 2, 1) + n * np.eye(n)
    j = n // 2
    lu = np.tril(rng.standard_normal((n, n)) * 0.2, -1) + np.eye(n)
    lu[j, :j] = 1.0
    d = np.ones(n)
    d[j] = -1.0
    v[-1] = lu @ np.diag(d) @ lu.T
    return _split(v, nw)


def _edge_words(rng, shape, nw, kind):
    """nw f32 words [B, d0, d1] on the card for the extraction's edges: a
    NaN in word 0 of row 1 and of column 2 ("nan"), zero rows and columns
    ("zero"), a row and a column above 2^126 ("huge"), else rows scaled by
    powers of ten."""
    import numpy as np

    v = rng.standard_normal(shape) * 10.0 ** rng.integers(-4, 4, shape)
    if kind == "zero":
        v[:, 0] = 0.0
        v[:, :, -1] = 0.0
    elif kind == "huge":
        v[:, -1] *= 3e38 / np.abs(v[:, -1]).max()
        v[:, :, 0] *= 1e38 / np.abs(v[:, :, 0]).max()
    ws = _split(v, nw)
    if kind == "nan":
        w0 = ws[0].clone()
        w0[:, 1 % shape[1], 0] = float("nan")
        w0[:, -1, 2 % shape[2]] = float("nan")
        ws = (w0,) + ws[1:]
    return ws


def _limbs(rng, shape, extreme=False):
    """int8 limbs on the card: drawn from [-65, 65], or all +-65."""
    import numpy as np
    import torch

    v = (rng.integers(0, 2, shape) * 130 - 65 if extreme
         else rng.integers(-65, 66, shape))
    return torch.from_numpy(v.astype(np.int8)).to("cuda")


def _compare(xs, ys):
    """(bit-identical?, max |x - y| where the bits differ) over paired
    tensors (NaNs with equal bits, as past a failed Cholesky pivot, agree)."""
    import torch

    same, err = True, 0.0
    for x, y in zip(xs, ys):
        if x.dtype == torch.float32:
            eq = x.view(torch.int32) == y.view(torch.int32)
        else:
            eq = x == y
        same &= bool(eq.all())
        if x.numel():
            d = torch.where(eq, 0.0, (x.double() - y.double()).abs())
            err = max(err, d.max().item())
    return same, err


def _flat(out):
    """A kernel's result (a tensor or nested tuples of them) as one flat
    tuple of tensors."""
    if isinstance(out, (tuple, list)):
        return tuple(t for o in out for t in _flat(o))
    return (out,)


class Kernels:
    """Phase 3's records: each kernel against its plain version on the card
    (bit identity), and at its timed main-path shapes its time, its plain
    version's time, its bound and, where one PyTorch call computes the same
    function, that call's time."""

    SRC = "clrs_tpu_torch/csrc/kernels.cu"
    SRC_OF = {"int8_gemm": "clrs_tpu_torch/csrc/int8_gemm.cu",
              "chol_batched": "clrs_tpu_torch/csrc/chol.cu",
              **{name: "clrs_tpu_torch/csrc/expmap.cu" for name in (
                  "ew_add", "ew_sub", "ew_mul", "ew_div", "ew_neg",
                  "ew_symmetrize")},
              **{name: "clrs_tpu_torch/csrc/exptree.cu" for name in (
                  "tree_sum", "tree_sum_fused")},
              **{name: "clrs_tpu_torch/csrc/expfuse.cu" for name in (
                  "ew_fma", "ew_fms", "ew_msub", "ew_mms", "ew_sub2",
                  "ew_select")},
              **{name: "clrs_tpu_torch/csrc/expf64.cu" for name in (
                  "expf64_sum", "expf64_max_abs", "expf64_split")},
              "eig_lowest": "clrs_tpu_torch/csrc/eig.cu",
              "eig_pairs": "clrs_tpu_torch/csrc/eig.cu",
              "eig_pairs_vec": "clrs_tpu_torch/csrc/eig.cu"}
    PL = "clrs_tpu/dd/pallas_linalg.py"

    def __init__(self):
        self.recs = {}
        self.compared = {}      # (group, shape key) -> kernel name

    def entry(self, name, replaces):
        return self.recs.setdefault(name, dict(
            name=name, route="cuda", source=self.SRC_OF.get(name, self.SRC),
            replaces=replaces,
            launches=0, max_abs_err=0.0, ms=None, plain_ms=None,
            bound_ms=None, bound_by=None, library_ms=None, compared=0))

    def check(self, name, replaces, kernel, plain, args, shape, cost=None,
              reps=5, plain_reps=3, library=None):
        """Run ``kernel(*args)`` and ``plain(*args)`` on the card and fail
        unless they agree bit for bit. With ``cost``, the (bytes,
        {unit: operations}) of this shape, also take the times and the
        bound. Each timed shape is kept under ``timings``; the kernel's own
        keys hold its first timed shape."""
        import torch

        r = self.entry(name, replaces)
        out = _flat(kernel(*args))
        same, err = _compare(out, _flat(plain(*args)))
        torch.cuda.synchronize()
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["compared"] += 1
        note = ""
        if cost is not None:
            t = dict(shape=shape, library_ms=None)
            t["bound_ms"], t["bound_by"] = bound(*cost)
            t["ms"] = time_ms(lambda: kernel(*args), reps)
            t["plain_ms"] = time_ms(lambda: plain(*args), plain_reps)
            if library is not None:
                t["library_ms"] = library()
            if "timings" not in r:
                r.update({k: v for k, v in t.items() if k != "shape"},
                         timed_shape=shape)
            r.setdefault("timings", []).append(t)
            note = (f" kernel {t['ms']:.4f} ms plain {t['plain_ms']:.4f} ms "
                    f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}) library "
                    f"{t['library_ms']}")
        print(f"  {name} {shape}: max_abs_err {err}{note}", flush=True)
        if not same:
            fail(f"{name} differs from its plain version at {shape}: "
                 f"max_abs_err {err}")


INT8_REPS = 50   # int8_gemm and torch._int_mm differ by under 1 us per call
# (B, M, K, N) of every int8_gemm call in the first iteration of
# delsarte(3,95), the split route's GEMMs there (torch_kernel_timing.py
# --kernel int8_gemm --d 95 --iters 1)
INT8_SHAPES_3_95 = ((1, 21, 191, 4032), (1, 21, 192, 21), (1, 1344, 64, 21),
                    (1, 1344, 128, 21), (1, 4011, 192, 21), (1, 4032, 1, 21),
                    (2, 672, 64, 2016), (4, 672, 64, 672), (4, 672, 64, 2016))


LIMB_REPS = 20   # the extraction, the limb GEMM, the cascade and the chains:
# microseconds a call
# (nw, B, m, k, n) of every limb_gemm call and (nw, B, d0, d1, side, layout)
# of every limb_extract call in the first iteration of delsarte(3,95)
# (torch_kernel_timing.py --kernel limb_gemm,limb_extract --d 95 --iters 1)
LIMB_GEMM_SHAPES_3_95 = (
    (5, 1, 128, 64, 128), (5, 1, 192, 191, 192), (5, 1, 64, 64, 64),
    (5, 2, 192, 96, 96), (5, 2, 64, 32, 96), (5, 2, 96, 192, 96),
    (5, 2, 96, 96, 96), (5, 4, 192, 96, 192), (5, 4, 192, 96, 96))
EXTRACT_SHAPES_3_95 = (
    (5, 1, 1, 1, "b", "gemm"), (5, 1, 1, 191, "a", "gemm"),
    (5, 1, 1, 192, "a", "gemm"), (5, 1, 128, 1, "b", "gemm"),
    (5, 1, 128, 64, "a", "limb"), (5, 1, 191, 192, "a", "gemm"),
    (5, 1, 191, 192, "b", "gemm"), (5, 1, 191, 192, "b", "limb"),
    (5, 1, 192, 1, "a", "gemm"), (5, 1, 192, 1, "b", "gemm"),
    (5, 1, 192, 191, "a", "limb"), (5, 1, 64, 1, "b", "gemm"),
    (5, 1, 64, 128, "a", "gemm"), (5, 1, 64, 128, "b", "limb"),
    (5, 1, 64, 64, "a", "gemm"), (5, 1, 64, 64, "a", "limb"),
    (5, 1, 64, 64, "b", "limb"), (5, 2, 32, 64, "a", "gemm"),
    (5, 2, 32, 96, "b", "limb"), (5, 2, 64, 32, "a", "limb"),
    (5, 2, 64, 96, "b", "gemm"), (5, 2, 96, 192, "a", "limb"),
    (5, 2, 96, 96, "a", "limb"), (5, 2, 96, 96, "b", "limb"),
    (5, 4, 192, 96, "a", "limb"), (5, 4, 32, 64, "a", "gemm"),
    (5, 4, 64, 32, "b", "gemm"), (5, 4, 64, 96, "b", "gemm"),
    (5, 4, 96, 96, "b", "limb"))


def _pad32(A, B):
    """One batch element of int8 operands [1, M, K] and [1, K, N], every
    dimension zero-padded to a multiple of 32 (the product's top-left
    M x N block is unchanged): the shapes torch._int_mm takes."""
    import torch.nn.functional as F

    M, K = A.shape[1:]
    N = B.shape[2]
    return (F.pad(A[0], (0, -K % 32, 0, -M % 32)),
            F.pad(B[0], (0, -N % 32, 0, -K % 32)))


def _int_mm_ms(A, B):
    """Time of torch._int_mm on the same int8 operands, padded by _pad32;
    None where the call is refused."""
    import torch

    M, N = A.shape[1], B.shape[2]
    a, b = _pad32(A, B)
    try:
        ref = torch._int_mm(a, b)[:M, :N]
        if not torch.equal(ref, (A[0].double() @ B[0].double()).int()):
            fail("torch._int_mm disagrees with the exact int8 product")
        return time_ms(lambda: torch._int_mm(a, b), INT8_REPS)
    except RuntimeError as e:
        print(f"  torch._int_mm refused {tuple(a.shape)}x{tuple(b.shape)}: "
              f"{str(e).splitlines()[0]}", flush=True)
        return None


def compare_kernels():
    """Phase 3: each kernel vs its plain version on the card. Returns the
    records (a Kernels; phase 12 adds to them) for the JSON summary."""
    import numpy as np
    import torch

    from clrs_tpu_torch.dd import kernels as K
    from clrs_tpu_torch.dd import limb_gemm as tg

    rng = np.random.default_rng(0)
    ks = Kernels()
    PL = Kernels.PL
    rep_ext = f"{PL}:667 (_extract_call)"
    # limb extraction: Schur-sized and panel-sized operands, both sides, the
    # limb-major layout of the fused route and the GEMM layouts of the split
    for nw, (B, d0, d1), timed in ((5, (2, 22, 22), False),
                                   (5, (4, 192, 64), True),
                                   (8, (2, 96, 96), False),
                                   (8, (4, 22, 11), False)):
        L, _ = K.limb_params(nw)
        w = _words(rng, (B, d0, d1), nw, scale_rows=True)
        for side in ("a", "b"):
            for layout in ("limb", "gemm"):
                t = timed and (side, layout) in (("a", "limb"), ("b", "gemm"))
                ks.check("limb_extract", rep_ext, K.limb_extract,
                         K.limb_extract_plain, (w, L, side, layout),
                         dict(nw=nw, B=B, d0=d0, d1=d1, side=side,
                              layout=layout),
                         cost_extract(nw, L, B, d0, d1, side) if t else None,
                         reps=LIMB_REPS)
    # untimed at the edges its exponent reduction and its tiles treat
    # apart: a NaN in word 0 of a row and of a column (e = 130, as amax
    # gives), zero rows and columns, values above 2^126, k = 1, k = 2^13
    # along a row (tiles that share it) and down a column, nw 5-8, and
    # transposed views (each word read through its strides)
    for nw, (B, d0, d1), kind in ((5, (2, 6, 9), "nan"),
                                  (8, (3, 5, 12), "nan"),
                                  (6, (3, 7, 5), "zero"),
                                  (7, (2, 5, 12), "huge"),
                                  (5, (3, 4, 1), "plain"),
                                  (8, (1, 3, 8192), "plain"),
                                  (6, (1, 8192, 5), "plain"),
                                  (5, (2, 96, 40), "transposed")):
        L, _ = K.limb_params(nw)
        if kind == "transposed":
            w = tuple(c.transpose(1, 2) for c in
                      _edge_words(rng, (B, d1, d0), nw, kind))
        else:
            w = _edge_words(rng, (B, d0, d1), nw, kind)
        for side in ("a", "b"):
            for layout in ("limb", "gemm"):
                ks.check("limb_extract", rep_ext, K.limb_extract,
                         K.limb_extract_plain, (w, L, side, layout),
                         dict(nw=nw, B=B, d0=d0, d1=d1, side=side,
                              layout=layout, kind=kind))
    for nw, B, d0, d1, side, layout in EXTRACT_SHAPES_3_95:
        L, _ = K.limb_params(nw)
        w = _words(rng, (B, d0, d1), nw, scale_rows=True)
        ks.check("limb_extract", rep_ext, K.limb_extract,
                 K.limb_extract_plain, (w, L, side, layout),
                 dict(nw=nw, B=B, d0=d0, d1=d1, side=side, layout=layout,
                      delsarte_3_95=True),
                 cost_extract(nw, L, B, d0, d1, side), reps=LIMB_REPS)
    # fused limb GEMM (operands extracted by the plain version)
    rep_lg = f"{PL}:552 (_limb_gemm_fused_call)"
    for nw, (B, m, k, n), timed in ((5, (4, 22, 22, 22), False),
                                    (5, (2, 192, 64, 192), True),
                                    (8, (2, 40, 33, 17), False)):
        L, ndiag = K.limb_params(nw)
        a = _words(rng, (B, m, k), nw, scale_rows=True)
        b = _words(rng, (B, k, n), nw)
        A3, ea = K.limb_extract_plain(a, L, "a")
        B3, eb = K.limb_extract_plain(b, L, "b")
        eab = (ea + eb).expand(B, m, n).contiguous()
        ks.check("limb_gemm", rep_lg, K.limb_gemm, K.limb_gemm_plain,
                 (A3, B3, eab, nw), dict(nw=nw, B=B, m=m, k=k, n=n),
                 cost_limb_gemm(nw, L, ndiag, B, m, k, n) if timed else None,
                 reps=LIMB_REPS)
    # untimed at the depths (k 1, 31, 32, 33 and 2^13 with every limb at
    # +-65: the largest diagonal sums), ragged m and n (17, 9, 1), A rows
    # that are not 4-byte aligned (k 1, 31, 33, 37), both tiles (16x16 from
    # 264 blocks of it), B 4 and nw 5-8 (each its own number of diagonal
    # fragments), and on a right operand from host_precompute (the pre_b
    # path)
    for nw, (B, m, k, n) in ((5, (1, 2, 1, 3)), (5, (1, 17, 31, 9)),
                             (6, (2, 33, 32, 17)), (7, (1, 9, 33, 1)),
                             (8, (1, 5, 8192, 3)), (5, (4, 40, 20, 24)),
                             (6, (4, 17, 64, 9)), (7, (2, 1, 40, 33)),
                             (8, (2, 40, 64, 48)), (6, (4, 160, 64, 160)),
                             (7, (4, 192, 32, 176)), (8, (4, 192, 37, 192))):
        L, _ = K.limb_params(nw)
        extreme = k in (1, 31, 32, 33, 8192)
        a3 = _limbs(rng, (B, L, m, k), extreme)
        b3 = _limbs(rng, (B, L, k, n), extreme)
        eab = torch.from_numpy(rng.integers(-8, 9, (B, m, n))
                               .astype(np.int32)).to("cuda")
        ks.check("limb_gemm", rep_lg, K.limb_gemm, K.limb_gemm_plain,
                 (a3, b3, eab, nw), dict(nw=nw, B=B, m=m, k=k, n=n,
                                         extreme=extreme))
    for nw, (m, k, n) in ((5, (64, 64, 192)), (8, (20, 37, 11))):
        L, _ = K.limb_params(nw)
        A3, ea = K.limb_extract_plain(_words(rng, (1, m, k), nw, True), L, "a")
        bv = rng.standard_normal((k, n))
        pre = tg.host_precompute(tuple(c[0].cpu().numpy() for c in
                                       _split(bv[None], nw)), nw, axis=0)
        B3, eb = (torch.from_numpy(x)[None].to("cuda") for x in pre)
        eab = (ea + eb).expand(1, m, n).contiguous()
        ks.check("limb_gemm", rep_lg, K.limb_gemm, K.limb_gemm_plain,
                 (A3, B3, eab, nw), dict(nw=nw, B=1, m=m, k=k, n=n,
                                         pre_b=True))
    for nw, B, m, k, n in LIMB_GEMM_SHAPES_3_95:
        L, ndiag = K.limb_params(nw)
        A3, ea = K.limb_extract_plain(_words(rng, (B, m, k), nw, True), L, "a")
        B3, eb = K.limb_extract_plain(_words(rng, (B, k, n), nw), L, "b")
        eab = (ea + eb).expand(B, m, n).contiguous()
        ks.check("limb_gemm", rep_lg, K.limb_gemm, K.limb_gemm_plain,
                 (A3, B3, eab, nw), dict(nw=nw, B=B, m=m, k=k, n=n,
                                         delsarte_3_95=True),
                 cost_limb_gemm(nw, L, ndiag, B, m, k, n), reps=LIMB_REPS)
    # the split route: int8 product C and the cascade from C, at a C within
    # the JAX route threshold (the Schur pairs of delsarte(3,10);
    # pl_cascade_tiles there) and above it with m, n no multiple of any tile
    # size (pl_cascade_tiles_grid there); then from diagonals
    for nw, (B, m, k, n), timed in ((5, (4, 22, 11, 22), True),
                                    (8, (4, 22, 11, 22), False),
                                    (5, (1, 100, 37, 130), True),
                                    (8, (1, 75, 29, 61), False)):
        L, ndiag = K.limb_params(nw)
        a = _words(rng, (B, m, k), nw, scale_rows=True)
        b = _words(rng, (B, k, n), nw)
        A2, ea = K.limb_extract_plain(a, L, "a", "gemm")
        B2, eb = K.limb_extract_plain(b, L, "b", "gemm")
        eab = (ea + eb).expand(B, m, n).contiguous()
        shape = dict(nw=nw, B=B, m=m, k=k, n=n,
                     C_MiB=round((L * m) * (L * n) * 4 / 2 ** 20, 3))
        ks.check("int8_gemm", "clrs_tpu/dd/limb_gemm.py:307 (XLA int8 "
                 "dot_general, not Pallas)", K.int8_gemm, K.int8_gemm_plain,
                 (A2, B2), shape)
        if timed:      # one batch element, the library call's inputs
            A1, B1 = A2[:1].contiguous(), B2[:1].contiguous()
            ks.check("int8_gemm", "", K.int8_gemm, K.int8_gemm_plain,
                     (A1, B1), dict(shape, B=1),
                     cost_int8_gemm(1, L * m, k, L * n), reps=INT8_REPS,
                     library=lambda: _int_mm_ms(A1, B1))
            # and on the library call's padded operands: what the ragged
            # pitches of the unpadded ones cost the kernel
            Ap, Bp = (t[None] for t in _pad32(A1, B1))
            ks.check("int8_gemm", "", K.int8_gemm, K.int8_gemm_plain,
                     (Ap, Bp), dict(shape, B=1, padded_to=32),
                     cost_int8_gemm(1, *Ap.shape[1:], Bp.shape[2]),
                     reps=INT8_REPS)
        C = K.int8_gemm_plain(A2, B2)
        ks.check("cascade_from_c", f"{PL}:420 (_cascade_tiles_call); "
                 f"{PL}:469 (_cascade_tiles_grid_call)", K.cascade_from_c,
                 K.cascade_from_c_plain, (C, eab, nw), shape,
                 cost_cascade(nw, L, ndiag, B, m, n, True) if timed else None,
                 reps=LIMB_REPS)
        diags = torch.stack(K._diags_from_c(C, L, m, n, ndiag), 1).contiguous()
        ks.check("cascade_from_diags", f"{PL}:370 (_cascade_call)",
                 K.cascade_from_diags, K.cascade_from_diags_plain,
                 (diags, eab, nw), shape,
                 cost_cascade(nw, L, ndiag, B, m, n, False) if timed else None,
                 reps=LIMB_REPS)
        # the split route against the fused route on the same operands
        same, err = _compare(tg.fx_matmul(a, b, route="split"),
                             tg.fx_matmul(a, b, route="fused"))
        print(f"  fx_matmul split vs fused {shape}: max_abs_err {err}",
              flush=True)
        if not same:
            fail(f"fx_matmul split and fused routes differ at {shape}")
    # the cascade untimed at the tilings and sizes it treats apart (one
    # element, m or n 1, B a few hundred, m and n multiples of no tile) and
    # with every limb at +-65 at k = 2^13 (the largest diagonal sums), nw 5-8
    for nw, (B, m, k, n), extreme in ((6, (1, 1, 3, 1), False),
                                      (7, (3, 1, 5, 17), False),
                                      (8, (2, 17, 4, 1), False),
                                      (5, (300, 3, 2, 5), False),
                                      (6, (2, 33, 9, 65), False),
                                      (5, (1, 33, 8192, 65), True),
                                      (8, (1, 27, 8192, 40), True)):
        L, ndiag = K.limb_params(nw)
        C = K.int8_gemm_plain(_limbs(rng, (B, L * m, k), extreme),
                              _limbs(rng, (B, k, L * n), extreme))
        eab = torch.from_numpy(rng.integers(-40, 41, (B, m, n))
                               .astype(np.int32)).to("cuda")
        shape = dict(nw=nw, B=B, m=m, k=k, n=n, extreme=extreme)
        ks.check("cascade_from_c", "", K.cascade_from_c,
                 K.cascade_from_c_plain, (C, eab, nw), shape)
        diags = torch.stack(K._diags_from_c(C, L, m, n, ndiag), 1).contiguous()
        ks.check("cascade_from_diags", "", K.cascade_from_diags,
                 K.cascade_from_diags_plain, (diags, eab, nw), shape)
    # int8_gemm untimed at the depths, widths and alignments its staging and
    # tiles treat apart (K of one, of a chunk and around it, and the deepest
    # exact K with every limb at +-65: the largest |C|; N = L n at n 1, the
    # narrow tile; ragged M and N; B 4; K and N multiples of 4 and 16, the
    # vector paths), then timed at the split-route shapes of delsarte(3,95)
    rep_int8 = ("clrs_tpu/dd/limb_gemm.py:307 (XLA int8 dot_general, not "
                "Pallas)")
    for (B, M, k, N), extreme in (((1, 21, 1, 22), True),
                                  ((1, 40, 31, 50), True),
                                  ((1, 64, 32, 64), True),
                                  ((2, 70, 33, 45), True),
                                  ((1, 40, 8192, 36), True),
                                  ((4, 462, 11, 21), False),
                                  ((1, 97, 20, 130), False),
                                  ((4, 100, 48, 260), False)):
        a, b = _limbs(rng, (B, M, k), extreme), _limbs(rng, (B, k, N), extreme)
        ks.check("int8_gemm", rep_int8, K.int8_gemm, K.int8_gemm_plain, (a, b),
                 dict(B=B, M=M, K=k, N=N, extreme=extreme))
    for B, M, k, N in INT8_SHAPES_3_95:
        a, b = _limbs(rng, (B, M, k)), _limbs(rng, (B, k, N))
        ks.check("int8_gemm", rep_int8, K.int8_gemm, K.int8_gemm_plain, (a, b),
                 dict(B=B, M=M, K=k, N=N, delsarte_3_95=True),
                 cost_int8_gemm(B, M, k, N), reps=INT8_REPS,
                 library=(lambda a=a, b=b: _int_mm_ms(a, b)) if B == 1 else None)
    # the three chains: the class shapes of delsarte(3,10) and (3,95)
    for nw, (L, n), timed in ((5, (2, 11), False), (5, (2, 96), True),
                              (8, (2, 11), False), (8, (2, 96), False)):
        x = _words(rng, (L, n, n), nw)
        d = _words(rng, (L, n, n), nw)
        mu = tuple(c.expand(L, 1, 1) for c in
                   _split(np.asarray([[[rng.random() * 1e3]]]), nw))
        alpha = tuple(c.expand(L, 1, 1) for c in
                      _split(np.asarray([[[0.9130357142857143]]]), 3))
        mask = torch.ones((L, n, n), device="cuda")
        mask[-1, -1, :] = 0.0
        mask[-1, :, -1] = 0.0
        shape = dict(nw=nw, L=L, n=n)
        add, mul, el = exp_add_ops(nw), exp_mul_ops(nw), L * n * n
        ks.check("plmap_add", "clrs_tpu/solver/step.py:1561 (pl_map, "
                 f"{PL}:738)", K.plmap_add, K.plmap_add_plain, (x, d), shape,
                 cost_plmap((x, d), nw, el, add) if timed else None,
                 reps=LIMB_REPS)
        ks.check("plmap_add", "", K.plmap_add, K.plmap_add_plain, (mu, x),
                 dict(shape, scalar_first=True))
        ks.check("plmap_axpy", "clrs_tpu/solver/step.py:1255 (pl_map, "
                 f"{PL}:738)", K.plmap_axpy, K.plmap_axpy_plain,
                 (x, d, alpha), shape,
                 cost_plmap((x, d, alpha), nw, el, 1 + mul + add)
                 if timed else None, reps=LIMB_REPS)
        ks.check("plmap_residual", "clrs_tpu/solver/step.py:1406 (pl_map, "
                 f"{PL}:738)", K.plmap_residual, K.plmap_residual_plain,
                 (mu, mask, x), dict(shape, corr=False))
        ks.check("plmap_residual", "", K.plmap_residual,
                 K.plmap_residual_plain, (mu, mask, x, d),
                 dict(shape, corr=True),
                 cost_plmap((mu, mask, x, d), nw, el, 2 * nw + 2 * add)
                 if timed else None, reps=LIMB_REPS)
    # untimed with the operand forms the kernels read apart (views of one
    # word-major stack, as the step's words lie; transposed and sliced
    # views; one matrix broadcast over L), L 1-4, n 1-96, nw 5-8
    for nw, (L, n), form in ((5, (2, 96), "stack"), (6, (1, 96), "transposed"),
                             (7, (4, 11), "sliced"), (8, (3, 96), "sliced"),
                             (5, (4, 1), "contiguous"), (8, (2, 11), "shared"),
                             (6, (3, 10), "stack"), (7, (1, 95), "transposed")):
        x, d = (_chain_words(rng, (L, n, n), nw, form, s) for s in (10, 1e-3))
        mu = tuple(c.expand(L, 1, 1) for c in
                   _split(np.asarray([[[rng.random() * 1e3]]]), nw))
        alpha = tuple(c.expand(L, 1, 1) for c in
                      _split(np.asarray([[[rng.random()]]]), 3))
        mask = torch.ones((L, n, n), device="cuda")
        mask[-1, -1, :] = 0.0
        if form == "transposed":
            mask = mask.transpose(1, 2)
        shape = dict(nw=nw, L=L, n=n, form=form)
        ks.check("plmap_add", "", K.plmap_add, K.plmap_add_plain, (x, d), shape)
        ks.check("plmap_axpy", "", K.plmap_axpy, K.plmap_axpy_plain,
                 (x, d, alpha), shape)
        for corr in ((), (d,)):
            ks.check("plmap_residual", "", K.plmap_residual,
                     K.plmap_residual_plain, (mu, mask, x) + corr,
                     dict(shape, corr=bool(corr)))
    # Cholesky: X|Y blocks, Schur-sized and a blocked diagonal block of
    # chol(S) (B 1, n 64; two of them at B 2), timed; then untimed at the
    # sizes where its chain, its shared layout and its global-memory path
    # (nw 8, n 95) differ, with members that fail: a negative diagonal entry
    # ("diag") or a pivot that turns negative halfway ("mid")
    rep_chol = f"{PL}:153 (_chol_call)"
    for nw, (B, n), timed, bad in ((5, (4, 11), False, "diag"),
                                   (5, (2, 64), True, None),
                                   (5, (1, 64), True, None),
                                   (5, (1, 95), False, None),
                                   (8, (2, 22), False, None),
                                   (5, (3, 1), False, None),
                                   (5, (2, 2), False, None),
                                   (5, (1, 63), False, None),
                                   (5, (2, 65), False, "mid"),
                                   (5, (2, 95), False, "mid"),
                                   (8, (1, 1), False, None),
                                   (8, (1, 2), False, None),
                                   (8, (1, 63), False, None),
                                   (8, (2, 64), False, "mid"),
                                   (8, (1, 65), False, None),
                                   (8, (2, 95), False, "mid")):
        a = _spd(rng, B, n, nw) if bad != "mid" else _indefinite(rng, B, n, nw)
        if bad == "diag":
            a = (a[0].clone(),) + a[1:]
            a[0][1, 3, 3] = -50.0
        ks.check("chol_batched", rep_chol, K.chol_batched, K.chol_plain, (a,),
                 dict(nw=nw, B=B, n=n, failing=bad),
                 cost_chol(nw, B, n) if timed else None, reps=10, plain_reps=1)
    # triangular solves, each form a kernel of its own: timed at the main
    # path's nw-5 shapes (B 2, n 64, m 64 as in earlier runs; m 1, the KKT
    # solves on chol(S)'s diagonal blocks, step.py:999-1004; m 96, the
    # step-length solves on chol(X|Y), step.py:770-771, and X^-1 through
    # b_solve_cholesky, step.py:879), then compared at trees that are not
    # powers of two, ragged column tiles (m 211 at B 4, m 95 at B 2), nw 8 at
    # n 95 (the largest unblocked size) and at n 120 (L read from global
    # memory: its triangle does not fit in shared memory)
    rep_tri = {False: f"{PL}:217 (_tril_call)", True: f"{PL}:272 (_tril_t_call)"}
    for nw, (B, n, m), timed in ((5, (2, 64, 64), (False, True)),
                                  (5, (1, 64, 1), (False, True)),
                                  (5, (4, 64, 96), (False,)),
                                  (5, (2, 64, 96), (True,)),
                                  (5, (4, 11, 11), ()),
                                  (5, (1, 22, 1), ()),
                                  (5, (2, 11, 1), ()),
                                  (5, (4, 22, 211), ()),
                                  (8, (1, 95, 1), ()),
                                  (8, (2, 95, 95), ()),
                                  (8, (1, 120, 3), ())):
        lw, _ = K.chol_plain(_spd(rng, B, n, nw))
        bw = _words(rng, (B, n, m), nw)
        for trans in (False, True):
            t = trans in timed
            ks.check(K.TRI_FORMS[trans], rep_tri[trans], K.tri_solve_batched,
                     K.tri_solve_plain, (lw, bw, trans),
                     dict(nw=nw, B=B, n=n, m=m),
                     cost_tri(nw, B, n, m, trans) if t else None,
                     reps=20, plain_reps=1)
    return ks


def compare_product_word_counts(ks):
    """Phase 3 at the word counts of the certified step-length route
    (clrs_tpu/solver/step.py:1096-1143): limb_extract on operands of 1-4
    words to a limb count L apart from theirs (10, 21, 31: the L of an
    nw 2, 5, 8 product), cascade<2, true> and limb_gemm_fused<2>, each
    against its plain version bit for bit at the edges phase 3 uses, and
    timed at the route's shapes at delsarte(3,10) (classes of n 11, 10)
    and (3,95) (n 96, 95; V^T V on the split route) and at one n-128 class
    (V^T V on the fused route, from n = 126 on)."""
    import numpy as np
    import torch

    from clrs_tpu_torch.dd import kernels as K
    from clrs_tpu_torch.dd import limb_gemm as tg

    rng = np.random.default_rng(11)
    PL = Kernels.PL
    for L in (10, 21, 31):
        for nw, (B, d0, d1), kind in ((1, (2, 6, 9), "nan"),
                                      (1, (3, 7, 5), "zero"),
                                      (1, (2, 5, 12), "huge"),
                                      (1, (3, 4, 1), "plain"),
                                      (1, (1, 3, 8192), "plain"),
                                      (1, (1, 8192, 5), "plain"),
                                      (1, (2, 96, 40), "transposed"),
                                      (2, (2, 11, 11), "plain"),
                                      (3, (2, 17, 9), "nan"),
                                      (4, (1, 40, 33), "plain")):
            if kind == "transposed":
                w = tuple(c.transpose(1, 2) for c in
                          _edge_words(rng, (B, d1, d0), nw, kind))
            else:
                w = _edge_words(rng, (B, d0, d1), nw, kind)
            for side in ("a", "b"):
                for layout in ("limb", "gemm"):
                    ks.check("limb_extract", "", K.limb_extract,
                             K.limb_extract_plain, (w, L, side, layout),
                             dict(nw=nw, L=L, B=B, d0=d0, d1=d1, side=side,
                                  layout=layout, kind=kind))
    # timed at the route's shapes: E's right operand V^T (L 21, the
    # fused route at n 96) and V^T V's operands (L 10, the split route at
    # n 96 and 11)
    for (B, d0, d1), L, side, layout in (((2, 96, 96), 21, "b", "limb"),
                                         ((2, 96, 96), 10, "a", "gemm"),
                                         ((2, 96, 96), 10, "b", "gemm"),
                                         ((2, 11, 11), 10, "a", "gemm"),
                                         ((2, 11, 11), 21, "b", "gemm")):
        w = _words(rng, (B, d0, d1), 1)
        ks.check("limb_extract", "", K.limb_extract, K.limb_extract_plain,
                 (w, L, side, layout), dict(nw=1, L=L, B=B, d0=d0, d1=d1,
                                            side=side, layout=layout,
                                            certified=True),
                 cost_extract(1, L, B, d0, d1, side), reps=LIMB_REPS)
    L, nd = K.limb_params(2)
    # cascade<2, true>: the route's V^T V at n 96 and 11 (timed), then at
    # one element, m or n 1, B 300, ragged tiles and limbs +-65 at k 2^13
    for (B, m, k, n), timed, extreme in (((2, 96, 96, 96), True, False),
                                         ((2, 11, 11, 11), True, False),
                                         ((2, 10, 10, 10), False, False),
                                         ((1, 1, 3, 1), False, False),
                                         ((3, 1, 5, 17), False, False),
                                         ((300, 3, 2, 5), False, False),
                                         ((2, 33, 9, 65), False, False),
                                         ((1, 33, 8192, 65), False, True)):
        C = K.int8_gemm_plain(_limbs(rng, (B, L * m, k), extreme),
                              _limbs(rng, (B, k, L * n), extreme))
        eab = torch.from_numpy(rng.integers(-40, 41, (B, m, n))
                               .astype(np.int32)).to("cuda")
        ks.check("cascade_from_c", "", K.cascade_from_c,
                 K.cascade_from_c_plain, (C, eab, 2),
                 dict(nw=2, B=B, m=m, k=k, n=n, extreme=extreme,
                      certified=True),
                 cost_cascade(2, L, nd, B, m, n, True) if timed else None,
                 reps=LIMB_REPS)
    # limb_gemm_fused<2>: V^T V of an n-128 class (timed), then at the
    # depths, ragged m and n, unaligned A rows and both tiles
    for (B, m, k, n), timed in (((2, 128, 128, 128), True),
                                ((1, 2, 1, 3), False), ((1, 17, 31, 9), False),
                                ((2, 33, 32, 17), False),
                                ((1, 5, 8192, 3), False),
                                ((4, 160, 64, 160), False),
                                ((2, 130, 130, 130), False)):
        extreme = k in (1, 31, 32, 8192)
        if timed:
            V = _words(rng, (B, k, n), 1)
            A3, ea = K.limb_extract_plain(tuple(c.transpose(1, 2) for c in V),
                                          L, "a")
            B3, eb = K.limb_extract_plain(V, L, "b")
            eab = (ea + eb).expand(B, m, n).contiguous()
        else:
            A3, B3 = (_limbs(rng, (B, L, m, k), extreme),
                      _limbs(rng, (B, L, k, n), extreme))
            eab = torch.from_numpy(rng.integers(-8, 9, (B, m, n))
                                   .astype(np.int32)).to("cuda")
        ks.check("limb_gemm", "", K.limb_gemm, K.limb_gemm_plain,
                 (A3, B3, eab, 2), dict(nw=2, B=B, m=m, k=k, n=n,
                                        extreme=extreme, certified=True),
                 cost_limb_gemm(2, L, nd, B, m, k, n) if timed else None,
                 reps=LIMB_REPS)
    # the two GEMMs of the route through fx_matmul, split against fused
    for nw_a, nw, n in ((5, None, 96), (8, None, 40), (1, 2, 96),
                        (1, 2, 128)):
        a = _words(rng, (2, n, n), nw_a)
        b = _words(rng, (2, n, n), 1)
        same, err = _compare(tg.fx_matmul(a, b, nw=nw, route="split"),
                             tg.fx_matmul(a, b, nw=nw, route="fused"))
        print(f"  fx_matmul split vs fused ({nw_a}-word by 1-word, nw "
              f"{nw or nw_a}, n {n}): max_abs_err {err}", flush=True)
        if not same:
            fail(f"fx_matmul split and fused routes differ at nw {nw_a} by "
                 f"1 word, n {n}")


# the expansion arithmetic of the step: each f32 add, subtract, multiply,
# divide, negation, symmetrization and tree sum one launch, each product-sum
# chain of the step (acc +- sum(x s y), a + b c, a - b c, a b - c,
# a b - c d, a - b - c s) one launch, and the commit's select
EXPANSION = ("ew_add", "ew_sub", "ew_mul", "ew_div", "ew_neg",
             "ew_symmetrize", "tree_sum", "tree_sum_fused", "ew_fma",
             "ew_fms", "ew_msub", "ew_mms", "ew_sub2", "ew_select")
EXPANSION_GROUPS = ("expmap", "tree_sum", "expfuse", "tree_fused", "select")
# replaces: the XLA fusions of the jitted TPU step (not Pallas)
EXPANSION_REPLACES = {
    "ew_symmetrize": "clrs_tpu/dd/linalg.py:209 (dd_symmetrize over expops, "
                     "XLA-fused in the jitted step clrs_tpu/solver/step.py:"
                     "1621; not Pallas)",
    "tree_sum": "clrs_tpu/dd/linalg.py:110-127 (dd_sum over expops.exp_add, "
                "XLA-fused in the jitted step clrs_tpu/solver/step.py:1621; "
                "not Pallas)",
    "tree_sum_fused": "clrs_tpu/dd/linalg.py:110-127 with the products "
                      "and the accumulate around it (dd_add(acc, dd_sum("
                      "dd_mul(x, y)))), XLA-fused in the jitted step "
                      "clrs_tpu/solver/step.py:1621; not Pallas",
    "ew_select": "clrs_tpu/solver/step.py:1661-1666 (the commit's "
                 "jnp.where per state leaf, XLA-fused in the jitted chunk "
                 "loop; not Pallas)"}
for _name in EXPANSION[:5]:
    EXPANSION_REPLACES[_name] = (
        "clrs_tpu/dd/core.py:448-499 (expops." + _name.replace("ew_", "exp_")
        + ", XLA-fused in the jitted step clrs_tpu/solver/step.py:1621; "
        "not Pallas)")
for _name in ("ew_fma", "ew_fms", "ew_msub", "ew_mms", "ew_sub2"):
    EXPANSION_REPLACES[_name] = (
        "clrs_tpu/dd/core.py:448-499 (a chain of expops products and sums, "
        "XLA-fused in the jitted step clrs_tpu/solver/step.py:1621; not "
        "Pallas)")


def _record_iteration(problem):
    """{group: {shape key: calls}} of the expansion kernels in one eager
    f32 nw-5 chunk iteration (the step and the commit) of ``problem`` on
    the card (torch_kernel_timing.py's ``record``)."""
    import torch_kernel_timing as T
    from clrs_tpu_torch.solver import step as TS
    from clrs_tpu_torch.solver.ipm import _to_host

    ds = device_sdp(problem)
    state = TS.initial_state(ds, 100.0, 100.0)
    info = TS.zero_info(_to_host(TS.make_assess(ds)(state)), ds.device)
    seen = {}

    def nest(gs):
        if not gs:
            run = TS.make_run_chunk(ds, duality_gap_threshold=1e-15,
                                    **STEP_KW)
            run(state, False, info, 1)
            return
        seen[gs[0]] = T.record(gs[0], lambda: nest(gs[1:]))

    capture, TS._CAPTURE = TS._CAPTURE, False      # one eager iteration
    try:
        nest(list(EXPANSION_GROUPS))
    finally:
        TS._CAPTURE = capture
    return seen


def _with_nw(group, key, nw):
    return (key[0], nw) + key[2:] if group in ("expmap", "expfuse") \
        else (nw,) + key[1:]


def _key_numel(group, key):
    """The largest operand of a recorded expansion shape."""
    shapes = (key[2:] if group == "expmap" else key[2] if group == "expfuse"
              else key[1:2] if group == "tree_sum" else key[1:3]
              if group == "tree_fused" else key[1])
    return max((_numel(sh) for sh in shapes if sh is not None), default=0)


EXPANSION_COST = {"expmap": cost_expmap, "tree_sum": cost_tree_sum,
                  "expfuse": cost_expfuse, "tree_fused": cost_tree_fused,
                  "select": cost_select}


def compare_expansion_kernels(ks, problem_3_10, problem_3_95):
    """Phase 3, the step's expansion arithmetic (csrc/expmap.cu,
    exptree.cu, expfuse.cu): every expmap<NW, OP>, tree_sum<NW, PRO>,
    expfuse<NW, FORM> and expselect<NW> shape of one delsarte(3,10) and
    one delsarte(3,95) chunk iteration (recorded on the way to the
    wrappers), at nw 5 and 8, bit for bit against the plain versions, the
    nw-5 (3,95) shapes timed; then the edges: numel 0, (), stride-0
    broadcast views, transposed operands, odd n, the block, cluster and
    level routes of the tree sum (compare_fused_edges)."""
    import numpy as np
    import torch

    import torch_kernel_timing as T
    from clrs_tpu_torch.dd import kernels as K

    rng = np.random.default_rng(13)
    me = sys.modules[__name__]
    t0 = time.time()
    seen = {}
    for label, problem in (("3,10", problem_3_10), ("3,95", problem_3_95)):
        for group, keys in _record_iteration(problem).items():
            for key, calls in keys.items():
                seen.setdefault((group, key), {})[label] = calls
    print(f"  expansion shapes of one iteration: {len(seen)} "
          f"(recorded in {time.time() - t0:.1f} s)", flush=True)
    def size(item):      # the largest shapes first: each kernel's summary
        (group, key), _ = item          # line takes its first timed shape
        return -_key_numel(group, key), repr(item)

    for (group, key), calls in sorted(seen.items(), key=size):
        for nw in (5, 8):
            k = _with_nw(group, key, nw)
            name, kernel, plain, args = T.inputs(group, k, rng, me, K)
            timed = nw == 5 and "3,95" in calls
            cost = EXPANSION_COST[group](*k) if timed else None
            ks.check(name, EXPANSION_REPLACES[name], kernel, plain, args,
                     dict(zip(T.FIELDS[group], k), calls_per_iteration=calls),
                     cost, reps=LIMB_REPS, plain_reps=2)
            ks.compared[group, k] = name
    # the edges, untimed
    for nw in (5, 8):
        x = _exp_words(rng, (2, 22, 1), nw)
        y = _exp_words(rng, (2, 22, 11), nw)
        xt = tuple(c.transpose(1, 2) for c in _exp_words(rng, (2, 11, 11), nw))
        yt = tuple(c.transpose(1, 2) for c in _exp_words(rng, (2, 11, 11), nw))
        cases = {"stride-0 broadcast": (tuple(c.expand(2, 22, 11) for c in x),
                                        y),
                 "transposed": (xt, yt),
                 "scalar": (_exp_words(rng, (), nw), _exp_words(rng, (), nw)),
                 "scalar by row": (_exp_words(rng, (), nw),
                                   _exp_words(rng, (1, 21), nw)),
                 "numel 0": (_exp_words(rng, (2, 0, 5), nw),
                             _exp_words(rng, (1, 5), nw))}
        for kind, (a, b) in cases.items():
            for op in ("add", "sub", "mul", "div"):
                name = f"ew_{op}"
                ks.check(name, EXPANSION_REPLACES[name], getattr(K, name),
                         getattr(K, name + "_plain"), (a, b),
                         dict(nw=nw, kind=kind))
            ks.check("ew_neg", EXPANSION_REPLACES["ew_neg"], K.ew_neg,
                     K.ew_neg_plain, (a,), dict(nw=nw, kind=kind))
        for kind, a in (("transposed", xt),
                        ("stride-0 broadcast",
                         tuple(c[:1].expand(3, 11, 11) for c in xt)),
                        ("numel 0", _exp_words(rng, (0, 4, 4), nw))):
            ks.check("ew_symmetrize", EXPANSION_REPLACES["ew_symmetrize"],
                     K.ew_symmetrize, K.ew_symmetrize_plain, (a,),
                     dict(nw=nw, kind=kind))
        for shape, axis in (((18432,), 0), ((13, 4), 0), ((2, 7, 3), 1),
                            ((1, 1, 1), 0), ((0, 4), 0), ((3, 0), 0),
                            ((12001, 2), 0), ((9001, 1), 0), ((5, 2301), 1),
                            ((400001, 1), 0)):
            a = _exp_words(rng, shape, nw)
            if shape == (13, 4):
                a = tuple(c.t().contiguous().t() for c in a)
            route, _ = K.tree_sum_plan(shape[axis], nw, 1)
            # timed at the sum a sharded (3,95) dot runs after its gather
            # (the one-process path fuses every sum with its product)
            cost = (cost_tree_sum(nw, shape, axis)
                    if nw == 5 and shape == (18432,) else None)
            ks.check("tree_sum", EXPANSION_REPLACES["tree_sum"], K.tree_sum,
                     K.tree_sum_plain, (a, axis),
                     dict(nw=nw, shape=shape, axis=axis, route=route), cost,
                     reps=LIMB_REPS, plain_reps=2)
        compare_fused_edges(ks, rng, nw, K)
    torch.cuda.synchronize()
    print(f"  expansion kernels compared in {time.time() - t0:.1f} s",
          flush=True)


def compare_fused_edges(ks, rng, nw, K):
    """Phase 3's edges of the fused kernels, untimed: each form on
    stride-0 broadcast, transposed, scalar and empty operands with a mask
    and sub2's scale; the tree sum with the product, a scale on x or on
    the product and either accumulate on the block route (3 columns of a
    transposed view, n 1, 2, 95 and 243), the cluster route (18,432
    entries at nw 5, 32,768 at nw 5 and 8: the (3,95) dot and the
    (3,127) one) and the level route (400,001 entries); the select with a
    false commit."""
    import torch

    x = _exp_words(rng, (2, 22, 1), nw)
    y = _exp_words(rng, (2, 22, 11), nw)
    xt = tuple(c.transpose(1, 2) for c in _exp_words(rng, (2, 11, 11), nw))
    cases = {"stride-0 broadcast": ([tuple(c.expand(2, 22, 11) for c in x),
                                     y, x, y], (2, 22, 11)),
             "transposed": ([xt, xt, _exp_words(rng, (2, 11, 11), nw), xt],
                            (2, 11, 11)),
             "scalar": ([_exp_words(rng, (), nw) for _ in range(4)], ()),
             "numel 0": ([_exp_words(rng, (2, 0, 5), nw),
                          _exp_words(rng, (1, 5), nw)] * 2, None)}
    for kind, (ops, ms) in cases.items():
        mask = None if ms is None else torch.from_numpy(
            rng.integers(0, 2, ms).astype("float32")).to("cuda")
        for form in ("fma", "fms", "msub", "mms"):
            name = f"ew_{form}"
            n = 4 if form == "mms" else 3
            ks.check(name, EXPANSION_REPLACES[name], getattr(K, name),
                     getattr(K, name + "_plain"), (*ops[:n], mask),
                     dict(nw=nw, kind=kind))
        ks.check("ew_sub2", EXPANSION_REPLACES["ew_sub2"], K.ew_sub2,
                 K.ew_sub2_plain, (*ops[:3], -1.0, mask),
                 dict(nw=nw, kind=kind))
    for n, cols in ((1, 3), (2, 3), (95, 3), (243, 3), (18432, 1),
                    (32768, 1), (400001, 1)):
        if n == 18432 and nw != 5:
            continue
        xw = tuple(c.t() for c in _exp_words(rng, (cols, n), nw))
        yw = _exp_words(rng, (n, 1), nw)
        acc = _exp_words(rng, (cols,), nw)
        sc = torch.from_numpy(rng.integers(0, 2, (n, cols)).astype(
            "float32")).to("cuda")
        route, _ = K.tree_sum_plan(n, nw, cols)
        for sub, scale_on in ((False, None), (True, "x"), (False, "product")):
            ks.check("tree_sum_fused", EXPANSION_REPLACES["tree_sum_fused"],
                     K.tree_sum_fused, K.tree_sum_fused_plain,
                     (xw, yw, 0, acc, sub, None if scale_on is None else sc,
                      scale_on),
                     dict(nw=nw, n=n, columns=cols, route=route, sub=sub,
                          scale_on=scale_on))
    src = [_exp_words(rng, (2, 96, 96), nw), _exp_words(rng, (1, 191), nw)]
    dst = [_exp_words(rng, (2, 96, 96), nw), _exp_words(rng, (1, 191), nw)]
    dk = [tuple(c.clone() for c in d) for d in dst]
    cond = torch.zeros((), dtype=torch.bool, device="cuda")
    ks.check("ew_select", EXPANSION_REPLACES["ew_select"],
             lambda c, s, a, b: K.ew_select(c, zip(s, a)),
             lambda c, s, a, b: K.ew_select_plain(c, zip(s, b)),
             (cond, src, dk, dst), dict(nw=nw, kind="false commit"))
    if not all(_compare(a, b)[0] for a, b in zip(dk, dst)):
        fail("ew_select moved words on a false commit")


# ---------------------------------------------------------------------------
# phase 3, the step-length eigensolver (csrc/eig.cu): eig_lowest (the f64
# route's lowest eigenvalue) and eig_pairs (the certified route's f32
# Jacobi eigenpairs)
# ---------------------------------------------------------------------------

EIG_REPLACES = {
    "eig_lowest": "clrs_tpu/solver/step.py:1163 (jnp.linalg.eigvalsh(A64) "
                  "in the jitted step off the TPU; not Pallas)",
    "eig_pairs": "clrs_tpu/solver/step.py:1123 (jnp.linalg.eigh(A32), XLA's "
                 "Jacobi eigensolver in the jitted TPU step; not Pallas)",
    "eig_pairs_vec": "clrs_tpu/solver/step.py:1123 (the eigenvectors of "
                     "jnp.linalg.eigh(A32): eig_pairs' rotations replayed "
                     "on V = I; not Pallas)"}
EIG_REPS = 20
# (B, n) timed beside cuSOLVER besides the recorded shapes: delsarte(3,127)'s
# and a batch of two, where cuSOLVER's eigh was quickest (kernel and library
# only: the plain versions take seconds there)
EIG_EXTRA_TIMED = ((4, 128), (2, 128))
# kernels a wrapper launches inside itself: compared with it
INNER = {"eig_pairs": ("eig_pairs_vec",)}


def _record_eig(problem, nw, dtype, verified):
    """{kernel group: {(B, n): calls}} of the eigensolver wrappers in one
    eager chunk iteration of ``problem`` on the card, on the default or the
    certified route."""
    import torch_kernel_timing as T
    from clrs_tpu_torch.solver import step as TS
    from clrs_tpu_torch.solver.ipm import _to_host

    ds = device_sdp(problem, nw=nw, dtype=dtype)
    state = TS.initial_state(ds, 100.0, 100.0)
    info = TS.zero_info(_to_host(TS.make_assess(ds)(state)), ds.device)
    seen = {}

    def nest(gs):
        if not gs:
            run = TS.make_run_chunk(ds, duality_gap_threshold=1e-15,
                                    **STEP_KW)
            run(state, False, info, 1)
            return
        seen[gs[0]] = T.record(gs[0], lambda: nest(gs[1:]))

    capture, TS._CAPTURE = TS._CAPTURE, False      # one eager iteration
    TS._STEPLEN_VERIFIED = verified
    try:
        nest(["eig_lowest", "eig_pairs"])
    finally:
        TS._CAPTURE, TS._STEPLEN_VERIFIED = capture, None
    return seen


def _eig_edge(rng, kind, B, n, dtype):
    """B symmetric n x n members on the card: random, diagonal, a lowest
    eigenvalue of multiplicity 3 in a random basis, or random with member
    1 zero (the step's bad member)."""
    import numpy as np
    import torch

    a = rng.standard_normal((B, n, n))
    a = a + np.swapaxes(a, 1, 2)
    if kind == "diagonal":
        a = np.stack([np.diag(np.diag(m)) for m in a])
    elif kind == "repeated":
        out = []
        for m in a:
            q, _ = np.linalg.qr(m + 2 * n * np.eye(n))
            lam = np.sort(rng.standard_normal(n))
            lam[:min(n, 3)] = lam[0]
            out.append((q * lam) @ q.T)
        a = np.stack(out)
        a = 0.5 * (a + np.swapaxes(a, 1, 2))
    elif kind == "zero":
        a[1] = 0.0
    return torch.tensor(a, dtype=dtype, device="cuda")


def _eig_vs_library(name, A, out):
    """The kernel's eigenvalues against cuSOLVER's on the same members:
    (max |lambda_min - eigvalsh's|, within 8 n 2^-53 ||A||_F?, the least
    allowance) for eig_lowest; (max |lambda - float64 eigvalsh's| over
    1 + |lambda|, True, None) for eig_pairs."""
    import torch

    n = A.shape[-1]
    with GUARD.allowed():
        if name == "eig_lowest":
            ref = torch.linalg.eigvalsh(A)[:, 0]
            err = (out - ref).abs()
            tol = 8 * n * 2.0 ** -53 * torch.linalg.matrix_norm(A)
            return err.max().item(), bool((err <= tol).all()), \
                tol.min().item()
        ref = torch.linalg.eigvalsh(A.double())
        err = ((out[0].double() - ref).abs() / (1 + ref.abs())).max().item()
        return err, True, None


def compare_eig_kernels(ks, problem_3_10, problem_3_95):
    """Phase 3, the step-length eigensolver: eig_lowest and eig_pairs bit
    for bit against their plain versions at every shape one eager
    delsarte(3,10) and delsarte(3,95) chunk iteration gives them (the
    default route at f32 nw 5 and f64 nw 2: eig_lowest; the certified
    route at f32 nw 5: eig_pairs, and its replay eig_pairs_vec on the
    sweep kernel's rotation logs), on random symmetric members; timed at
    the nw-5 (3,95) shape beside the plain version, cuSOLVER
    (torch.linalg.eigvalsh, eigh) and the bound, eig_pairs' two launches
    apart with the members' sweep counts; then at n 1 and 2, a diagonal
    batch, a batch with a zero member, a lowest eigenvalue of multiplicity
    3, B 1, n 137 and 200 (eig_lowest's global-memory route; eig_pairs
    keeps A in shared memory to n 234); the kernels and cuSOLVER alone at
    EIG_EXTRA_TIMED. eig_lowest's lambda_min is held within 8 n 2^-53
    ||A||_F of cuSOLVER's eigvalsh at each shape."""
    import numpy as np
    import torch

    import torch_kernel_timing as T
    from clrs_tpu_torch.dd import kernels as K

    f32, f64 = torch.float32, torch.float64
    shapes = {}
    for label, problem in (("delsarte(3,10)", problem_3_10),
                           ("delsarte(3,95)", problem_3_95)):
        for route, nw, dt, verified in (("f32 nw 5", 5, None, None),
                                        ("f64 nw 2", 2, f64, None),
                                        ("certified f32 nw 5", 5, None,
                                         True)):
            for group, keys in _record_eig(problem, nw, dt, verified).items():
                for key in keys:
                    shapes.setdefault((group, key), []).append(
                        f"{label} {route}")
    print(f"  eigensolver shapes (kernel, (B, n)): {shapes}", flush=True)
    rng = np.random.default_rng(15)
    for (name, key), where in sorted(shapes.items()):
        A = T.eig_input(name, key, rng)
        kernel, plain = getattr(K, name), getattr(K, name + "_plain")
        cost = library = None
        if any(w.startswith("delsarte(3,95)") and "nw 5" in w
               for w in where):
            cost = (cost_eig_lowest if name == "eig_lowest"
                    else cost_eig_pairs)(*key)
            lib = T.library_eig(name)

            def library(lib=lib, A=A):
                with GUARD.allowed():
                    return time_ms(lambda: lib(A), EIG_REPS)

        ks.check(name, EIG_REPLACES[name], kernel, plain, (A,),
                 dict(B=key[0], n=key[1], at=where), cost, reps=EIG_REPS,
                 plain_reps=1, library=library)
        ks.compared[name, key] = name
        if name == "eig_pairs":
            _check_replay(ks, A, dict(B=key[0], n=key[1], at=where),
                          cost is not None)
        err, ok, tol = _eig_vs_library(name, A, kernel(A))
        print(f"  {name} {key}: against cuSOLVER {err:.3e}"
              + (f" (allowance {tol:.3e})" if tol is not None else ""),
              flush=True)
        if not ok:
            fail(f"{name} {key}: lambda_min is not within 8 n 2^-53 ||A||_F "
                 f"of cuSOLVER's eigvalsh")
    edges = (("random", 3, 1), ("random", 3, 2), ("diagonal", 3, 11),
             ("zero", 4, 96), ("repeated", 2, 33), ("random", 1, 96),
             ("random", 2, 137), ("random", 2, 200))
    for name, dt in (("eig_lowest", f64), ("eig_pairs", f32)):
        kernel, plain = getattr(K, name), getattr(K, name + "_plain")
        for kind, B, n in edges:
            if name == "eig_lowest" and n == 137:
                continue
            A = _eig_edge(rng, kind, B, n, dt)
            ks.check(name, EIG_REPLACES[name], kernel, plain, (A,),
                     dict(B=B, n=n, kind=kind))
            if name == "eig_pairs":
                _check_replay(ks, A, dict(B=B, n=n, kind=kind), False)
            _, ok, _ = _eig_vs_library(name, A, kernel(A))
            if not ok:
                fail(f"{name} {kind} B {B} n {n}: lambda_min is not within "
                     f"8 n 2^-53 ||A||_F of cuSOLVER's eigvalsh")
    for key in EIG_EXTRA_TIMED:
        for name in ("eig_lowest", "eig_pairs"):
            A = T.eig_input(name, key, rng)
            _time_eig(ks, name, A, T.library_eig(name))
    print(f"  eigensolver scratch (doubles a member in global memory): "
          f"eig_lowest n 200: {_scratch(0, 200)}, n 96: {_scratch(0, 96)}; "
          f"eig_pairs (rotation log, A past n 234) n 240: {_scratch(1, 240)}, "
          f"n 96: {_scratch(1, 96)}", flush=True)


def _check_replay(ks, A, shape, timed):
    """eig_pairs_vec against its plain version on the rotation logs that
    the sweep kernel leaves for A (eig_pairs' second launch); where timed,
    the sweep kernel's own time and the members' sweep counts besides."""
    from clrs_tpu_torch.dd import kernels as K

    B, n = A.shape[0], A.shape[-1]
    _, log = K.eig_pairs_sweeps(A)
    sweeps = log[:, K.eig_pairs_log_layout(n)[2]].long().tolist()
    ks.check("eig_pairs_vec", EIG_REPLACES["eig_pairs_vec"], K.eig_pairs_vec,
             K.eig_pairs_vec_plain, (log, n), dict(shape, sweeps=sweeps),
             cost_eig_pairs_vec(B, n) if timed else None,
             reps=EIG_REPS, plain_reps=1)
    if timed:
        ms = time_ms(lambda: K.eig_pairs_sweeps(A), EIG_REPS)
        print(f"  eig_pairs ({B}, {n}): the sweep kernel alone {ms:.4f} ms, "
              f"sweeps a member {sweeps}", flush=True)


def _time_eig(ks, name, A, lib):
    """The kernel (for eig_pairs also its two launches apart) and cuSOLVER
    on A, kept under the record's timings with the bound; no plain
    version."""
    from clrs_tpu_torch.dd import kernels as K

    B, n = A.shape[0], A.shape[-1]
    cost = cost_eig_lowest(B, n) if name == "eig_lowest" else \
        cost_eig_pairs(B, n)
    t = dict(shape=dict(B=B, n=n, timed_only=True), plain_ms=None)
    t["bound_ms"], t["bound_by"] = bound(*cost)
    t["ms"] = time_ms(lambda: getattr(K, name)(A), EIG_REPS)
    with GUARD.allowed():
        t["library_ms"] = time_ms(lambda: lib(A), EIG_REPS)
    ks.recs[name].setdefault("timings", []).append(t)
    note = ""
    if name == "eig_pairs":
        _, log = K.eig_pairs_sweeps(A)
        sweeps = log[:, K.eig_pairs_log_layout(n)[2]].long().tolist()
        v = dict(shape=dict(B=B, n=n, sweeps=sweeps, timed_only=True),
                 plain_ms=None, library_ms=None,
                 ms=time_ms(lambda: K.eig_pairs_vec(log, n), EIG_REPS))
        v["bound_ms"], v["bound_by"] = bound(*cost_eig_pairs_vec(B, n))
        ks.recs["eig_pairs_vec"].setdefault("timings", []).append(v)
        sweep_ms = time_ms(lambda: K.eig_pairs_sweeps(A), EIG_REPS)
        note = (f" (sweep kernel {sweep_ms:.4f} ms, replay {v['ms']:.4f} ms, "
                f"sweeps a member {sweeps})")
    print(f"  {name} ({B}, {n}): kernel {t['ms']:.4f} ms{note}, cuSOLVER "
          f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
          f"({t['bound_by']})", flush=True)


def _scratch(kind, n):
    from clrs_tpu_torch.dd.build import library

    return library().clrs_eig_scratch(kind, n)


# kernels each solve must launch: the split route, the chain kernels and
# the expansion arithmetic at delsarte(3,10); at delsarte(3,95) the fused
# limb GEMM as well (its Schur pairings exceed the JAX route threshold).
# cascade<FROM_DIAGS> has no caller in either package (phase 3 holds it
# against its plain version).
# The plain tree_sum runs only where a sharded axis is gathered between a
# product and its sum (phase 13): every tree sum of a one-process step is
# a tree_sum_fused (whose kernel, tree_sum<NW, PRO>, is tree_sum's too).
# the f64 boundary of the expansion arithmetic: each conversion of an
# expansion to f64 (a sum, a max |.|) and of an f64 scalar to words one launch
EXPF64 = ("expf64_sum", "expf64_max_abs", "expf64_split")
PATH_3_10 = ("eig_lowest", "limb_extract", "int8_gemm", "cascade_from_c",
             "chol_batched",
             "tri_solve_batched<false>", "tri_solve_batched<true>",
             "plmap_add", "plmap_axpy", "plmap_residual") + tuple(
                 n for n in EXPANSION if n != "tree_sum") + EXPF64
PATH_3_95 = PATH_3_10 + ("limb_gemm",)
# the certified step-length route: f32 eigenpairs (eig_pairs), certified by
# the limb GEMMs, in place of the lowest eigenvalue
PATH_CERT_3_10 = tuple(n for n in PATH_3_10 if n != "eig_lowest") + (
    "eig_pairs", "eig_pairs_vec")
PATH_CERT_3_95 = PATH_CERT_3_10 + ("limb_gemm",)
# ew_msub, ew_mms and ew_fms fuse chains of the scalar pack (the 1x1
# blocks), which a problem without 1x1 blocks never runs: GW max-cut,
# theta(C5), the POVM, min_f(2), multi_cluster_test_problem
SCALAR_PACK_FORMS = ("ew_msub", "ew_mms", "ew_fms")
PATH_NO_PACK = tuple(n for n in PATH_3_10 if n not in SCALAR_PACK_FORMS)


class CusolverGuard:
    """torch.linalg's eigensolvers wrapped to count their calls on CUDA
    tensors (cuSOLVER) outside :meth:`allowed` (the yardstick timings and
    reference values of this script): a card solve makes none, its
    step-length eigensolver is the port's kernels. Installed in this
    process and in each rank process of phase 13."""

    NAMES = ("eigvalsh", "eigh", "eigvals", "eig")

    def __init__(self):
        self.calls, self.sites, self._allow, self._orig = 0, [], 0, None

    def install(self):
        import torch

        if self._orig is not None:
            return
        self._orig = {n: getattr(torch.linalg, n) for n in self.NAMES}
        for n, fn in self._orig.items():
            setattr(torch.linalg, n, self._wrap(n, fn))

    def _wrap(self, name, fn):
        def guarded(A, *a, **kw):
            if getattr(A, "is_cuda", False) and not self._allow:
                import traceback

                self.calls += 1
                self.sites.append(f"torch.linalg.{name} at " + " < ".join(
                    f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno}"
                    for f in traceback.extract_stack()[-4:-1][::-1]))
            return fn(A, *a, **kw)

        return guarded

    def allowed(self):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            self._allow += 1
            try:
                yield
            finally:
                self._allow -= 1

        return ctx()

    def check(self, label):
        if self.calls:
            fail(f"{label}: cuSOLVER ran on the card {self.calls} times "
                 f"({self.sites[:3]})")


GUARD = CusolverGuard()


def check_counts(label, counts, required, n_it):
    """Fail unless every required kernel launched, no plain version ran and
    no torch.linalg eigensolver ran on the card; print the launches per
    iteration."""
    from clrs_tpu_torch.dd import kernels as K

    GUARD.check(label)
    plain = {f.__name__ for f in K._PLAIN}
    per_it = {k: round(v / max(n_it, 1), 2) for k, v in counts.items()
              if k not in plain}
    print(f"{label}: launches per iteration {per_it}", flush=True)
    for name in required:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched by the {label} solve")
    for f in K._PLAIN:
        if counts[f.__name__] != 0:
            fail(f"plain version {f.__name__} ran in the {label} solve")


ITERATIONS_3_10 = 28
STEP_KW = dict(gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
               dual_error_threshold=1e-12, primal_error_threshold=1e-12)


def solve_delsarte_3_10(problem, sync_every=1):
    """Phase 4: the main path, counted: solvesdp through the step's CUDA
    graphs, chunks of ``sync_every`` iterations. Returns the kernels'
    counts."""
    import torch

    import clrs_tpu_torch as ct
    from clrs_tpu_torch.dd import kernels as K

    iters = []
    K.reset_counts()
    status, dualsol, primalsol, t, code = ct.solvesdp(
        problem, omega_p=100, omega_d=100, sync_every=sync_every,
        verbose=False, callback=lambda it, info: iters.append(it),
        **{k: STEP_KW[k] for k in ("dual_error_threshold",
                                   "primal_error_threshold")})
    torch.cuda.synchronize()
    counts = K.counts()
    obj = float(ct.objvalue(problem, primalsol))
    n_it = iters[-1] if iters else 0
    label = f"delsarte(3,10) sync_every={sync_every}"
    print(f"{label}: code {code} status {status!r} objective {obj!r} |err| "
          f"{abs(obj - DELSARTE_3_10):.3e} iterations {n_it} in "
          f"{len(iters)} chunks, solve {t:.3f} s = "
          f"{t / max(n_it, 1):.4f} s/iteration", flush=True)
    if code != 0 or not ct.optimal(status):
        fail(f"{label} ended with code {code}, status {status!r}")
    if not abs(obj - DELSARTE_3_10) < 1e-9:
        fail(f"{label} objective {obj!r} is not within 1e-9 of "
             f"{DELSARTE_3_10!r}")
    if n_it != ITERATIONS_3_10:
        fail(f"{label} took {n_it} iterations, not {ITERATIONS_3_10}")
    check_counts(label, counts, PATH_3_10, n_it)
    SOLVES_3_10[sync_every] = (code, n_it, obj)
    return counts


SOLVES_3_10 = {}   # sync_every -> (code, iterations, objective) of phase 4


def delsarte_3_95(problem):
    """Phase 5: three iterations at Schur scale (P = 192: blocked
    Cholesky and solves, the fused route for the Schur pairings) through
    solvesdp and the step's CUDA graphs, counted. Returns the kernels'
    counts and the three iterations' infos."""
    import math

    import torch

    import clrs_tpu_torch as ct
    from clrs_tpu_torch.dd import kernels as K

    rows = []
    marks = []

    def cb(it, info):
        torch.cuda.synchronize()
        marks.append(time.time())
        rows.append(info)

    K.reset_counts()
    status, _, _, t, code = ct.solvesdp(
        problem, omega_p=100, omega_d=100, maxiterations=3, verbose=False,
        callback=cb, **{k: STEP_KW[k] for k in ("dual_error_threshold",
                                                "primal_error_threshold")})
    torch.cuda.synchronize()
    counts = K.counts()
    later = [1e3 * (b - a) for a, b in zip(marks[:-1], marks[1:])]
    print(f"delsarte(3,95): code {code}; iterations {len(rows)}; loop "
          f"{1e3 * t / max(len(rows), 1):.1f} ms/iteration with the capture "
          f"(iterations 2-3: {[round(v, 1) for v in later]} ms); mu "
          f"{[r['mu'] for r in rows]}; alpha_d {[r['alpha_d'] for r in rows]}"
          f"; alpha_p {[r['alpha_p'] for r in rows]}", flush=True)
    if len(rows) != 3 or code != 2:
        fail(f"delsarte(3,95) stopped after {len(rows)} iterations, code "
             f"{code}")
    for r in rows:
        if not (r["ok"] and math.isfinite(r["mu"]) and r["alpha_d"] > 0
                and r["alpha_p"] > 0):
            fail(f"delsarte(3,95) iteration failed: {r}")
    check_counts("delsarte(3,95)", counts, PATH_3_95, len(rows))
    return counts, rows


_COMPILED = {}     # id(problem) -> (problem, its preprocessed SDP)
_DEVICE_SDPS = {}  # (id(problem), nw, dtype) -> DeviceSDP


def device_sdp(problem, nw=5, dtype=None):
    """The DeviceSDP that solvesdp builds for ``problem`` on the card (f32
    words unless ``dtype`` says otherwise). The host compile of a problem
    and the DeviceSDP of each word count and dtype are made once a run
    (both are read, never written, by the steps) and shared by the phases
    that drive it."""
    import clrs_tpu_torch as ct
    from clrs_tpu_torch.compile.preprocess import preprocess_sdp
    from clrs_tpu_torch.model.checks import remove_empty_blocks
    from clrs_tpu_torch.solver.step import DeviceSDP

    key = (id(problem), nw, dtype)
    if key not in _DEVICE_SDPS:
        if id(problem) not in _COMPILED:
            sdp = ct.ClusteredLowRankSDP(problem)
            remove_empty_blocks(sdp, verbose=False)
            _COMPILED[id(problem)] = (problem,
                                      preprocess_sdp(sdp, verbose=False)[0])
        _DEVICE_SDPS[key] = DeviceSDP(
            _COMPILED[id(problem)][1], nw=nw, device="cuda",
            **({} if dtype is None else {"dtype": dtype}))
    return _DEVICE_SDPS[key]


def drive(ds, mode, n):
    """1 + ``n`` iterations from omega 100 I by the eager step
    (make_step_body) or through the graphs (make_run_chunk, chunks of
    one), each ending in the one host read of its info that solvesdp
    makes. The first iteration warms up (and, for the graphs, captures);
    the next n are timed, synchronised. Peak device memory is
    torch.cuda.max_memory_allocated over the run, and the same above what
    the process held before it (the DeviceSDP's constants among that).
    Returns (stats, the infos, a function that runs one more
    iteration)."""
    import torch

    from clrs_tpu_torch.dd import kernels as K
    from clrs_tpu_torch.solver.ipm import _to_host
    from clrs_tpu_torch.solver.step import (initial_state, make_assess,
                                            make_run_chunk, make_step_body,
                                            zero_info)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    state = initial_state(ds, 100.0, 100.0)
    if mode == "eager":
        step = make_step_body(ds, **STEP_KW)
        carry = [state, False]

        def one():
            carry[0], info = step(*carry)
            h = _to_host(info)
            carry[1] = h["pd_feas"]
            return h
    else:
        run = make_run_chunk(ds, duality_gap_threshold=1e-15, **STEP_KW)
        carry = [state, False, zero_info(_to_host(make_assess(ds)(state)),
                                         ds.device)]

        def one():
            out = run(*carry, 1)
            carry[:] = out[:3]
            return _to_host(out[2], it_done=out[3], code=out[4])
    rows = [one()]
    torch.cuda.synchronize()
    split = run.loop["split"] if mode == "graph" else None
    calls0 = split.host_calls if split else 0
    K.reset_counts()
    t0 = time.perf_counter()
    for _ in range(n):
        rows.append(one())
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / n
    plain = {f.__name__ for f in K._PLAIN}
    stats = dict(mode=mode, wall_ms=wall,
                 port_launches=sum(v for k, v in K.counts().items()
                                   if k not in plain and "<" not in k) / n,
                 peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
                 peak_above_held_mib=(torch.cuda.max_memory_allocated()
                                      - held) / 2 ** 20)
    if split:
        stats.update(capture_s=split.capture_seconds,
                     warmup_s=split.warmup_seconds,
                     host_calls=(split.host_calls - calls0) / n)
    return stats, rows, one


def profile_one(one):
    """One more iteration under torch.profiler: (host launch calls: the
    CUDA runtime and driver calls that launch a kernel or a graph or copy
    memory; device kernels; their summed device ms, one stream)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one()
        torch.cuda.synchronize()
    host = dev = 0
    busy = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev += 1
            busy += e.time_range.elapsed_us() / 1e3
        elif e.name.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                                "cudaMemcpy", "cudaMemset")):
            host += 1
    return host, dev, busy


# ---------------------------------------------------------------------------
# phases 7-11: the f64 substrate (f64 words, slice GEMMs over one cuBLAS
# DGEMM each, PyTorch expansion ops; no kernel of csrc/ runs on it)
# ---------------------------------------------------------------------------

F64_NWS = (2, 4, 5)
F64_DGEMM_OPS_PER_S = 67e12   # f64 tensor cores (NVIDIA's H100 SXM data sheet)
# clrs_tpu.solvesdp(delsarte(3,10), substrate="f64") on the CPU with the
# arguments of solve_delsarte_3_10: pdOpt, code 0, 13.15831434739031 in 28
# iterations (the JAX package's f64 solve)
ITERATIONS_3_10_F64 = 28
# min_f(2) at the reference's literal defaults (prec 256: 5 f64 words), the
# JAX package's CPU solve: pdOpt, code 0, gap 5.1e-16 (PARITY.md:111-123)
MIN_F_2 = -2.112913881423605


def _f64_words(rng, shape, nw, positive=False):
    """nw f64 words on the CPU: half the elements a normalised expansion,
    half words of independent magnitudes, all between 1e-150 and 1e150."""
    import numpy as np
    import torch

    mag = lambda: 10.0 ** rng.uniform(-150, 150, shape)  # noqa: E731
    sign = 1.0 if positive else rng.choice([-1.0, 1.0], shape)
    ws = [sign * rng.uniform(1, 2, shape) * mag()]
    wild = rng.random(shape) < 0.5
    for _ in range(1, nw):
        tame = ws[-1] * 2.0 ** -rng.integers(53, 60, shape) \
            * rng.uniform(-1, 1, shape)
        ws.append(np.where(wild, rng.uniform(-1, 1, shape) * mag(), tame))
    return tuple(torch.from_numpy(w) for w in ws)


def _same_f64(xs, ys):
    """Bit-identical f64 word tuples (card against CPU), NaN as NaN."""
    import torch

    for x, y in zip(xs, ys):
        x, y = x.cpu(), y.cpu()
        nan = torch.isnan(x)
        if not torch.equal(nan, torch.isnan(y)) or not torch.equal(
                torch.where(nan, 0.0, x).view(torch.int64),
                torch.where(nan, 0.0, y).view(torch.int64)):
            return False
    return len(xs) == len(ys)


def _cuda(ws):
    return tuple(w.to("cuda") for w in ws)


def compare_f64_ops():
    """Phase 7: every f64 op on the card against the same op on the CPU
    (CUDA f64 keeps subnormals; the CPU runs unflushed), bit for bit, at
    nw 2, 4 and 5, 2^15 elements with magnitudes 1e-150..1e150 mixed in
    one expansion."""
    import numpy as np
    import torch

    from clrs_tpu_torch.dd import f64ops as F

    ops = {"add": lambda x, y, p, a: F.dd_add(x, y),
           "sub": lambda x, y, p, a: F.dd_sub(x, y),
           "mul": lambda x, y, p, a: F.dd_mul(x, y),
           "div": lambda x, y, p, a: F.dd_div(x, y),
           "mul_f64": lambda x, y, p, a: F.dd_mul_f64(x, a),
           "add_f64": lambda x, y, p, a: F.dd_add_f64(x, a),
           "rsqrt": lambda x, y, p, a: F.dd_rsqrt(p),
           "sqrt": lambda x, y, p, a: F.dd_sqrt(p),
           "qd_add": lambda x, y, p, a: F.qd_add(x, y),
           "qd_mul": lambda x, y, p, a: F.qd_mul(x, y),
           "qd_mul_f64": lambda x, y, p, a: F.qd_mul_f64(x, a),
           "abs": lambda x, y, p, a: F.dd_abs(x),
           "max": lambda x, y, p, a: F.dd_max(x, y),
           "min": lambda x, y, p, a: F.dd_min(x, y),
           "lt": lambda x, y, p, a: (F.dd_lt(x, y).double(),)}
    for nw in F64_NWS:
        rng = np.random.default_rng(80 + nw)
        n = 1 << 15
        args = (_f64_words(rng, n, nw), _f64_words(rng, n, nw),
                _f64_words(rng, n, nw, positive=True),
                _f64_words(rng, n, 1)[0])
        card = (_cuda(args[0]), _cuda(args[1]), _cuda(args[2]),
                _cuda((args[3],))[0])
        bad = [k for k, f in ops.items()
               if not _same_f64(f(*args), f(*card))]
        torch.cuda.synchronize()
        print(f"f64 ops nw {nw}, card against CPU: {len(ops) - len(bad)} "
              f"of {len(ops)} bit-identical", flush=True)
        if bad:
            fail(f"f64 ops {bad} at nw {nw} differ between card and CPU")


def compare_slice_matmul(shapes):
    """Phase 7 (and after phase 9, at the largest depth of a delsarte(3,95)
    iteration): slice_matmul on the card against the CPU, bit for bit, at
    each (batch, m, k, n, nw) of ``shapes``."""
    import numpy as np

    from clrs_tpu_torch.dd.slice_gemm import slice_matmul

    for (B, m, k, n, nw) in shapes:
        rng = np.random.default_rng(k + 7 * nw)
        a = _f64_words(rng, (B, m, k), nw)
        b = _f64_words(rng, (B, k, n), nw)
        same = _same_f64(slice_matmul(a, b),
                         slice_matmul(_cuda(a), _cuda(b)))
        print(f"slice_matmul (B {B}, {m}x{k}x{n}, nw {nw}), card against "
              f"CPU: {'bit-identical' if same else 'DIFFERENT'}", flush=True)
        if not same:
            fail(f"slice_matmul differs between card and CPU at "
                 f"{(B, m, k, n, nw)}")


def time_slice_matmul(card, shape):
    """slice_matmul's time at ``shape`` (batch, m, k, n, nw) on the card,
    called eagerly and replayed from a CUDA graph (as on the main path),
    the time of its one DGEMM on slice-stacked operands of the same shape,
    and the DGEMM's bound (f64 tensor-core FLOPs or bytes at 3.35 TB/s)."""
    import numpy as np
    import torch

    from clrs_tpu_torch.dd.slice_gemm import slice_matmul, slice_params

    B, m, k, n, nw = shape
    rng = np.random.default_rng(1)
    a = _cuda(_f64_words(rng, (B, m, k), nw))
    b = _cuda(_f64_words(rng, (B, k, n), nw))
    _, nsl, _ = slice_params(k, nw)
    A = torch.randn((B, nsl * m, k), dtype=torch.float64, device="cuda")
    Bm = torch.randn((B, k, nsl * n), dtype=torch.float64, device="cuda")
    total = time_ms(lambda: slice_matmul(a, b), reps=10)
    gemm = time_ms(lambda: torch.matmul(A, Bm), reps=10)
    # as on the main path: one call replayed from a CUDA graph
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        slice_matmul(a, b)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        slice_matmul(a, b)
    replay = time_ms(g.replay, reps=10)
    flops = 2.0 * B * nsl * m * k * nsl * n
    nbytes = 8.0 * B * (nsl * m * k + k * nsl * n + nsl * m * nsl * n)
    t_ops, t_bytes = flops / F64_DGEMM_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"slice_matmul at the largest delsarte(3,95) f64 shape (B {B}, "
          f"{m}x{k}x{n}, nw {nw}, {nsl} slices): {total:.4f} ms a call "
          f"eagerly, {replay:.4f} ms replayed from a graph; its DGEMM ({B} "
          f"x {nsl * m}x{k}x{nsl * n}) {gemm:.4f} ms = {gemm / replay:.3f} "
          f"of the replay, bound {1e3 * max(t_ops, t_bytes):.6f} ms ({by})"
          f" [{card}]", flush=True)


def check_no_kernels(label):
    """The f64 path runs no kernel of csrc/ but the step-length eigensolver
    (eig_lowest, which it must run), no plain version but the f64
    boundary's (f64 words take them: nothing converts) and no torch.linalg
    eigensolver on the card."""
    from clrs_tpu_torch.dd import kernels as K

    GUARD.check(label)
    counts = K.counts()
    own = {"eig_lowest", "expf64_sum_plain", "expf64_max_abs_plain"}
    ran = {k: v for k, v in counts.items() if v and k not in own}
    if ran:
        fail(f"{label} ran f32 kernels or plain versions: {ran}")
    if not counts["eig_lowest"]:
        fail(f"{label} did not launch eig_lowest")


def solve_delsarte_3_10_f64(problem):
    """Phase 8: delsarte(3,10) at substrate="f64" (nw 2) through solvesdp
    on the default device at sync_every 1 (the step's CUDA graphs)."""
    import torch

    import clrs_tpu_torch as ct
    from clrs_tpu_torch.dd import kernels as K

    iters = []
    K.reset_counts()
    t0 = time.time()
    status, dualsol, primalsol, t, code = ct.solvesdp(
        problem, substrate="f64", omega_p=100, omega_d=100, sync_every=1,
        verbose=False, callback=lambda it, info: iters.append(it),
        **{k: STEP_KW[k] for k in ("dual_error_threshold",
                                   "primal_error_threshold")})
    torch.cuda.synchronize()
    obj = float(ct.objvalue(problem, primalsol))
    n_it = iters[-1] if iters else 0
    label = "delsarte(3,10) f64"
    print(f"{label}: code {code} status {status!r} objective {obj!r} |err| "
          f"{abs(obj - DELSARTE_3_10):.3e} iterations {n_it} (the JAX f64 "
          f"solve: {ITERATIONS_3_10_F64}), solve {t:.3f} s with the capture,"
          f" {time.time() - t0:.1f} s in all", flush=True)
    if code != 0 or not ct.optimal(status):
        fail(f"{label} ended with code {code}, status {status!r}")
    if not abs(obj - DELSARTE_3_10) < 1e-9:
        fail(f"{label} objective {obj!r} is not within 1e-9")
    if n_it != ITERATIONS_3_10_F64:
        fail(f"{label} took {n_it} iterations, not {ITERATIONS_3_10_F64}")
    check_no_kernels(label)


def delsarte_3_95_f64(problem, rows_f32):
    """Phase 9: three iterations of delsarte(3,95) at f64 nw 2 through
    solvesdp (blocked f64 factorizations at P = 192): ok, finite mu,
    alpha > 0, and mu, alpha_d, alpha_p within rel 1e-12 of phase 5's f32
    values (both substrates carry at least 105 bits). Returns the
    (batch, m, k, n, nw) of every slice GEMM of the run."""
    import math

    import torch

    import clrs_tpu_torch as ct
    from clrs_tpu_torch.dd import kernels as K
    from clrs_tpu_torch.dd import linalg as dl

    shapes = set()
    inner = dl.slice_matmul

    def recording(a, b, nw=None):
        shapes.add((int(a[0].shape[0]), int(a[0].shape[-2]),
                    int(a[0].shape[-1]), int(b[0].shape[-1]),
                    nw or len(a)))
        return inner(a, b, nw)

    rows = []
    K.reset_counts()
    dl.slice_matmul = recording
    try:
        status, _, _, t, code = ct.solvesdp(
            problem, substrate="f64", omega_p=100, omega_d=100,
            maxiterations=3, verbose=False,
            callback=lambda it, info: rows.append(info),
            **{k: STEP_KW[k] for k in ("dual_error_threshold",
                                       "primal_error_threshold")})
    finally:
        dl.slice_matmul = inner
    torch.cuda.synchronize()
    keys = ("mu", "alpha_d", "alpha_p")
    print(f"delsarte(3,95) f64: code {code}; iterations {len(rows)}; "
          f"{t:.1f} s with the capture; " + "; ".join(
              f"{k} {[r[k] for r in rows]}" for k in keys), flush=True)
    if len(rows) != 3 or code != 2:
        fail(f"delsarte(3,95) f64 stopped after {len(rows)} iterations, "
             f"code {code}")
    for r, r32 in zip(rows, rows_f32):
        if not (r["ok"] and math.isfinite(r["mu"]) and r["alpha_d"] > 0
                and r["alpha_p"] > 0):
            fail(f"delsarte(3,95) f64 iteration failed: {r}")
        for k in keys:
            if not abs(r[k] - r32[k]) <= 1e-12 * abs(r32[k]):
                fail(f"delsarte(3,95) f64 {k} {r[k]!r} is not within rel "
                     f"1e-12 of the f32 {r32[k]!r}")
    print("delsarte(3,95) f64: mu, alpha_d and alpha_p within rel 1e-12 of "
          "phase 5's f32 values", flush=True)
    check_no_kernels("delsarte(3,95) f64")
    return sorted(shapes)


def min_f_literal_defaults():
    """Phase 10: min_f(2) at the reference's literal solvesdp defaults
    (prec 256, so 5 f64 words; gap 1e-15; errors 1e-30; omega 1e10) on
    the default device: pdOpt, code 0, the objective within 1e-9 of the
    JAX package's, the final gap below 1e-15."""
    import torch

    import clrs_tpu_torch as ct
    from clrs_tpu_torch.examples import min_f

    last = []
    t0 = time.time()
    problem, status, _, primalsol, code = min_f(
        2, substrate="f64", prec=256, verbose=False,
        callback=lambda it, info: last.append((it, info)))
    torch.cuda.synchronize()
    obj = float(ct.objvalue(problem, primalsol))
    it, info = last[-1] if last else (0, {"dual_gap": float("nan")})
    print(f"min_f(2) literal defaults, f64 nw 5: code {code} status "
          f"{status!r} objective {obj!r} |err| {abs(obj - MIN_F_2):.3e} "
          f"gap {info['dual_gap']!r} iterations {it}, "
          f"{time.time() - t0:.1f} s", flush=True)
    if code != 0 or not ct.optimal(status):
        fail(f"min_f(2) ended with code {code}, status {status!r}")
    if not abs(obj - MIN_F_2) < 1e-9 or not info["dual_gap"] < 1e-15:
        fail(f"min_f(2): objective {obj!r}, gap {info['dual_gap']!r}")


def graph_vs_eager_f64(card, problem_3_10, problem_3_95):
    """Phase 11: the f64 step's graphs against its eager form:
    delsarte(3,10)'s first step word for word; then phase 6's rows at
    both problems: wall ms per iteration, capture and instantiation
    seconds, host calls and peak device memory, in turns eager, graph,
    graph, eager at delsarte(3,10) and graph, eager at delsarte(3,95)
    (whose eager iteration takes seconds); and one profiled graph
    iteration at each (device kernels, their busy ms and share of the
    unprofiled wall time, host launch calls), delsarte(3,95) last: its
    hundreds of thousands of records come after every other profile of
    the process."""
    import torch

    from clrs_tpu_torch.solver.step import (initial_state, make_step,
                                            make_step_body)

    ds10 = device_sdp(problem_3_10, nw=2, dtype=torch.float64)
    s0 = initial_state(ds10, 100.0, 100.0)
    eager = make_step_body(ds10, **STEP_KW)(s0, False)
    graph = make_step(ds10, **STEP_KW)(s0, False)
    differ, n = _tree_differ(eager, graph)
    print(f"delsarte(3,10) f64 first step, graph against eager: {differ} of "
          f"{n} word arrays and info entries differ", flush=True)
    if differ:
        fail("the f64 graph step differs from the eager step")
    del graph
    ds95 = device_sdp(problem_3_95, nw=2, dtype=torch.float64)
    print(card, flush=True)
    runs = (("delsarte(3,10) f64", ds10, GRAPH_PASSES, 5),
            ("delsarte(3,95) f64", ds95, ("graph", "eager"), 2))
    for label, ds, passes, n_it in runs:
        for mode in passes:
            stats, _, one = drive(ds, mode, n_it if mode == "graph" else
                                  max(1, n_it // 2))
            print(f"{label} {mode}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in stats.items()), flush=True)
            if mode == "graph":
                graph_one, wall = one, stats["wall_ms"]
        host, dev, busy = profile_one(graph_one)
        print(f"{label} graph, one profiled iteration: host launch calls "
              f"{host}, device kernels " + (
                  f"{dev}, busy {busy:.3f} ms = {busy / wall:.3f} of the "
                  f"unprofiled wall {wall:.3f} ms" if dev else
                  "not measured (no device records)"), flush=True)


def _tree_differ(a, b):
    """(arrays of two states or infos whose bits differ, arrays)."""
    import torch

    from clrs_tpu_torch.solver.step import _tree_map

    leaves = ([], [])
    for out, acc in zip((a, b), leaves):
        _tree_map(acc.append, out)
    as_int = {torch.float32: torch.int32, torch.float64: torch.int64}
    differ = sum(not torch.equal(x.view(as_int.get(x.dtype, x.dtype)),
                                 y.view(as_int.get(y.dtype, y.dtype)))
                 for x, y in zip(*leaves))
    return differ + abs(len(leaves[0]) - len(leaves[1])), len(leaves[0])


GRAPH_PASSES = ("eager", "graph", "graph", "eager")


def graph_vs_eager(card, problem_3_10, problem_3_95, rows_3_95):
    """Phase 6: the graphs against the eager step. delsarte(3,10)'s first
    step word for word (make_step against make_step_body) and its solve at
    sync_every 4; delsarte(3,95)'s three mu, alpha_d and alpha_p of phase 5
    against the eager step's; then, at both problems, in turns eager,
    graph, graph, eager: wall ms per iteration over 5 iterations, capture
    and instantiation seconds, host calls per iteration, the port's kernel
    launches per iteration and peak device memory; and one profiled
    iteration of each mode at delsarte(3,10): host launch calls and device
    kernels."""
    from clrs_tpu_torch.solver.step import (initial_state, make_step,
                                            make_step_body)

    ds10 = device_sdp(problem_3_10)
    s0 = initial_state(ds10, 100.0, 100.0)
    eager = make_step_body(ds10, **STEP_KW)(s0, False)
    graph = make_step(ds10, **STEP_KW)(s0, False)
    differ, n = _tree_differ(eager, graph)
    print(f"delsarte(3,10) first step, graph against eager: {differ} of "
          f"{n} word arrays and info entries differ", flush=True)
    if differ:
        fail("the graph step differs from the eager step at delsarte(3,10)")

    solve_delsarte_3_10(problem_3_10, sync_every=4)

    ds95 = device_sdp(problem_3_95)
    print(card, flush=True)
    ones = {}
    for label, ds in (("delsarte(3,10)", ds10), ("delsarte(3,95)", ds95)):
        for mode in GRAPH_PASSES:
            stats, rows, ones[label, mode] = drive(ds, mode, 5)
            print(f"{label} {mode}: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in stats.items()), flush=True)
            if mode == "graph" and stats["host_calls"] > 2:
                fail(f"{label}: {stats['host_calls']} host calls per graph "
                     "iteration, more than one replay and one flag copy")
            if ds is ds95:
                got = [tuple(r[k] for k in ("mu", "alpha_d", "alpha_p"))
                       for r in rows[:3]]
                want = [tuple(r[k] for k in ("mu", "alpha_d", "alpha_p"))
                        for r in rows_3_95]
                if got != want:
                    fail(f"delsarte(3,95) {mode}: mu, alpha_d, alpha_p "
                         f"{got} differ from phase 5's {want}")
    print("delsarte(3,95): the eager and graph runs' mu, alpha_d and "
          "alpha_p equal phase 5's to the last digit", flush=True)
    for mode in ("eager", "graph"):
        host, dev, _ = profile_one(ones["delsarte(3,10)", mode])
        print(f"delsarte(3,10) {mode}, one profiled iteration: host launch "
              f"calls {host}, device kernels "
              f"{dev if dev else 'not measured (no device records)'}",
              flush=True)


# ---------------------------------------------------------------------------
# phase 12: the exact-certificate path (model -> solve on the card -> round
# to an exact solution on the host), the reference's rounding oracles, each
# solved with the settings of its reference test
# ---------------------------------------------------------------------------

L3 = [[2, -1, -1], [-1, 2, -1], [-1, -1, 2]]
SDPA_FIXTURE = "tests/fixtures/example.dat-s"


class CertParts:
    """One oracle's solve and rounding: wall seconds of each, the solve's
    iterations (from solvesdp's callback) and the kernels it launched
    (counts set to 0 just before, read just after)."""

    def __init__(self):
        self.seconds = {}
        self.marks = []
        self.counts = None

    def callback(self, it, info):
        self.marks.append((it, time.time()))

    def _lap(self, name, fn):
        import torch

        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        self.seconds[name] = time.time() - t0
        return out

    def solve(self, fn):
        from clrs_tpu_torch.dd import kernels as K

        K.reset_counts()
        out = self._lap("solve", fn)
        self.counts = K.counts()
        return out

    def round(self, fn):
        return self._lap("round", fn)

    def per_iteration(self):
        """Seconds per iteration after the first (which captures)."""
        if len(self.marks) < 2:
            return float("nan")
        (i0, t0), (i1, t1) = self.marks[0], self.marks[-1]
        return (t1 - t0) / max(i1 - i0, 1)


def _cert_gw(kw, parts):
    """GW max-cut of the 3-cycle (tests/test_rounding.py:15): 9/4 exact,
    X[0,1] = -1/2."""
    import clrs_tpu_torch as ct
    from clrs_tpu_torch.examples import goemans_williamson

    problem, _, ds, ps, code = parts.solve(lambda: goemans_williamson(
        L3, omega_p=100.0, omega_d=100.0, eps=1e-18, verbose=False,
        dual_error_threshold=1e-15, primal_error_threshold=1e-15, **kw))
    ok, esol = parts.round(lambda: ct.exact_solution(problem, ds, ps,
                                                     verbose=False))
    v = ct.objvalue(problem, esol)
    x01 = ct.matrixvar(esol, "X")[0, 1]
    return code, (ok and v == Fraction(9, 4) and x01 == Fraction(-1, 2),
                  f"exact {v}, X[0,1] {x01}")


def _cert_delsarte(n, d, costheta, want, field, kw, parts):
    """delsarte_exact solved, then rounded with delsarte_round's monomial
    basis (tests/test_rounding.py:30, :62, :82)."""
    from decimal import Decimal

    import clrs_tpu_torch as ct
    from clrs_tpu_torch.examples import delsarte_exact

    if field:
        FF = ct.NumberField([-5, 0, 1], "z", approx_root=Decimal(5).sqrt())
        costheta = costheta(FF.gen())
        g = Decimal(5).sqrt()
        opts = dict(eps=1e-20, dual_error_threshold=1e-16,
                    primal_error_threshold=1e-16)
        settings = ct.RoundingSettings(kernel_errbound=1e-8)
    else:
        FF, g = ct.QQ, 1
        opts = dict(dual_error_threshold=1e-15, primal_error_threshold=1e-15)
        settings = ct.RoundingSettings()
    _, problem, ds, ps, code = parts.solve(lambda: delsarte_exact(
        n, d, costheta, FF=FF, g=g, omega_p=100.0, omega_d=100.0,
        verbose=False, **opts, **kw))
    _, x = ct.polynomial_ring("x")
    ok, esol = parts.round(lambda: ct.exact_solution(
        problem, ds, ps, FF=FF, g=g, settings=settings,
        monomial_bases=[[x ** k for k in range(2 * d + 1)]], verbose=False))
    v = ct.objvalue(problem, esol)
    return code, (ok and v == want, f"exact {v}")


def _cert_model(name, kw, parts):
    """theta(C5) or the POVM through the frontend Model, find_field and
    exact_solution (tests/test_frontend.py:18, :32)."""
    import math

    import clrs_tpu_torch as ct
    from clrs_tpu_torch import examples

    m = parts.solve(lambda: getattr(examples, name)(maxiterations=250, **kw))
    v = float(m.objective_value())

    def rnd():
        FF, g = ct.frontend.find_field(m)
        return (FF,) + ct.frontend.exact_solution(m, FF=FF, g=g,
                                                  verbose=False)
    FF, ok, prob, esol = parts.round(rnd)
    ev = ct.objvalue(prob, esol)
    if name == "lovasz_theta_c5":
        good = abs(v - math.sqrt(5)) < 1e-12 and ev * ev == 5
    else:
        d = ev - Fraction(1, 2)
        good = (abs(v - (0.5 + math.sqrt(2) / 4)) < 1e-12
                and d * d == Fraction(1, 8))
    return m.errorcode, (good and ok and FF.degree == 2,
                         f"value {v!r}, field degree {FF.degree}, exact {ev}")


def _cert_three_point(kw, parts):
    """three_point_spherical_codes(4, 1/6, -1, 4) (tests/test_rounding.py
    :179): code 0, 10 within 1e-8, exact 10."""
    import clrs_tpu_torch as ct
    from clrs_tpu_torch.examples import three_point_spherical_codes

    problem, _, ds, ps, code = parts.solve(
        lambda: three_point_spherical_codes(
            4, Fraction(1, 6), -1, 4, verbose=False, omega_p=1000.0,
            omega_d=1000.0, duality_gap_threshold=1e-18,
            dual_error_threshold=1e-15, primal_error_threshold=1e-15, **kw))
    v = float(ct.objvalue(problem, ps))
    ok, esol = parts.round(lambda: ct.exact_solution(
        problem, ds, ps, verbose=False,
        settings=ct.RoundingSettings(kernel_errbound=1e-8)))
    ev = ct.objvalue(problem, esol)
    return code, (code == 0 and abs(v - 10) < 1e-8 and ok and ev == 10,
                  f"value {v!r}, exact {ev}")


CERT_ORACLES = (
    ("GW max-cut C3", _cert_gw),
    ("delsarte_round(8,3,1/2)",
     lambda kw, p: _cert_delsarte(8, 3, Fraction(1, 2), 240, False, kw, p)),
    ("delsarte Q(sqrt5) (3,2,1/z)",
     lambda kw, p: _cert_delsarte(3, 2, lambda z: z.inverse(), 12, True, kw,
                                  p)),
    ("delsarte Q(sqrt5) (4,9,1/(z-1))",
     lambda kw, p: _cert_delsarte(4, 9, lambda z: (z - 1).inverse(), 120,
                                  True, kw, p)),
    ("theta(C5) Model",
     lambda kw, p: _cert_model("lovasz_theta_c5", kw, p)),
    ("POVM Model", lambda kw, p: _cert_model("povm", kw, p)),
    ("three-point(4,1/6,-1,4)", _cert_three_point),
)
# kernels each phase-12 solve must launch: PATH_3_10, and at three-point
# the fused limb GEMM as well (its Schur pairings exceed the route
# threshold, as at delsarte(3,95))
CERT_PATH = {"three-point(4,1/6,-1,4)": PATH_3_95,
             "GW max-cut C3": PATH_NO_PACK, "theta(C5) Model": PATH_NO_PACK,
             "POVM Model": PATH_NO_PACK}


def certificate_path(card, ks):
    """Phase 12: each rounding oracle solved on the card at the f32
    default (through the step's CUDA graphs) and rounded on the host;
    then the SDPA fixture solved on the card and on the CPU; then every
    kernel against its plain version at the shapes those solves gave it
    (into ``ks``, phase 3's records). Fails unless every oracle gives its
    exact value, each solve launched every kernel of its path and no
    plain version, the two SDPA objectives agree to 1e-12 and every
    kernel matches its plain version. Returns {label: the kernels' counts
    of its solve}."""
    from pathlib import Path

    import clrs_tpu_torch as ct
    from clrs_tpu_torch.exact import modp

    route = {"native": 0, "python": 0}
    inner = modp._rref_native

    def counted(a, p):
        out = inner(a, p)
        route["native" if out is not None else "python"] += 1
        return out

    def n_it(parts):
        return parts.marks[-1][0] if parts.marks else 0

    def oracles():
        for label, oracle in CERT_ORACLES:
            route.update(native=0, python=0)
            parts = CertParts()
            code, (good, note) = oracle(dict(callback=parts.callback), parts)
            check_counts(label, parts.counts, CERT_PATH.get(label, PATH_3_10),
                         n_it(parts))
            runs[f"certificate {label}"] = parts.counts
            print(f"{label} [f32]: code {code}, iterations {n_it(parts)}, "
                  f"solve {parts.seconds['solve']:.2f} s "
                  f"({parts.per_iteration():.4f} s/iteration after the "
                  f"first), rounding {parts.seconds['round']:.2f} s, rref "
                  f"native {route['native']} python {route['python']}; "
                  f"{note}", flush=True)
            if not good:
                fail(f"{label} did not give its exact value: {note}")
        parts = CertParts()
        out = parts.solve(lambda: ct.solvesdp(
            sdpa, callback=parts.callback, **sdpa_kw))
        check_counts("SDPA example.dat-s", parts.counts, PATH_3_10,
                     n_it(parts))
        runs["certificate SDPA"] = parts.counts
        return parts, out

    print(card, flush=True)
    runs = {}
    sdpa = ct.sdpa_sparse_to_problem(
        str(Path(__file__).resolve().parent / SDPA_FIXTURE))
    sdpa_kw = dict(omega_p=100., omega_d=100., dual_error_threshold=1e-12,
                   primal_error_threshold=1e-12, verbose=False)
    modp._rref_native = counted
    try:
        (parts, (_, _, ps, _, code)), seen = recorded(oracles)
    finally:
        modp._rref_native = inner

    _, _, ps_cpu, _, code_cpu = ct.solvesdp(sdpa, device="cpu", **sdpa_kw)
    v, v_cpu = (float(ct.objvalue(sdpa, s)) for s in (ps, ps_cpu))
    print(f"SDPA example.dat-s: code {code} (CPU {code_cpu}), objective "
          f"{v!r}, CPU {v_cpu!r}, |diff| {abs(v - v_cpu):.3e}, iterations "
          f"{n_it(parts)}, solve {parts.seconds['solve']:.2f} s", flush=True)
    if code != 0 or code_cpu != 0 or not abs(v - v_cpu) <= 1e-12:
        fail("the SDPA fixture's card solve is not within 1e-12 of its CPU "
             "solve")
    compare_path_shapes(ks, seen, runs)
    return runs


def recorded(run):
    """``run()`` with the calls of every kernel of the path recorded on
    their way to its wrapper (torch_kernel_timing.py's ``record``; at a
    graph's capture, so every shape of every solve is seen once). Returns
    run()'s result and {kernel group: {shape key: calls}}."""
    import torch_kernel_timing as T

    seen, out = {}, []

    def nest(groups):
        if not groups:
            out.append(run())
            return
        seen[groups[0]] = T.record(groups[0], lambda: nest(groups[1:]))

    nest(list(T.RECORDED))
    return out[0], seen


def compare_path_shapes(ks, seen, runs, phase=12):
    """Each kernel against its plain version on the card, bit for bit, at
    every shape that the phase's solves gave its wrapper (``seen``, from
    :func:`recorded`), on random inputs of that shape
    (torch_kernel_timing.py's ``inputs``); a shape an earlier phase of this
    run compared is not compared again. Fails on any difference and on a
    kernel that launched in those solves with no shape recorded."""
    import numpy as np

    import torch_kernel_timing as T
    from clrs_tpu_torch.dd import kernels as K

    rng = np.random.default_rng(12)
    me = sys.modules[__name__]
    names, again = {}, 0
    for group, keys in seen.items():
        for key in sorted(keys, key=repr):
            name = ks.compared.get((group, key))
            if name is None:
                name, kernel, plain, args = T.inputs(group, key, rng, me, K)
                ks.check(name, "", kernel, plain, args,
                         dict(zip(T.FIELDS[group], key), certificate=True))
                ks.compared[group, key] = name
            else:
                again += 1
            for covered in (name,) + INNER.get(name, ()):
                names[covered] = names.get(covered, 0) + 1
    print(f"phase {phase} shapes compared with the plain versions: {names} "
          f"({again} of them compared earlier in this run)", flush=True)
    for name in ks.recs:
        if any(c[name] for c in runs.values()) and not names.get(name):
            fail(f"{name} launched in phase {phase} but no shape of it was "
                 "recorded")


# ---------------------------------------------------------------------------
# phase 14: the certified step-length route (clrs_tpu_torch.solver.step.
# _STEPLEN_VERIFIED = True, the JAX package's TPU route): f32 eigenpairs
# from the eig_pairs kernel, certified in the same graph with exact limb
# GEMMs at the word counts the route gives the kernels
# ---------------------------------------------------------------------------

# the band of the certified bound below the f64 eigvalsh lambda_min of the
# same member, relative to 1 + |lambda|: no higher than 1e-12 (the bound is
# a lower bound; 1e-12 for the f64 eigensolver's own error), and no lower
# than 1e-4, the JAX package's test's tolerance (tests/test_expops.py:
# 187-188) for LAPACK's f32 eigenpairs, which leave 1e-5 at
# delsarte(3,95)'s n 96. The route's pairs on the card are the eig_pairs
# kernel's (Jacobi, V kept in f64); cuSOLVER's f32 pairs left 3.0-3.3e-4
# (PERF.md). The certification of the same pairs is bit for bit the CPU's.
BAND_ABOVE, BAND_BELOW = 1e-12, 1e-4
ROUTES = (("eigvalsh", None), ("certified", True), ("certified", True),
          ("eigvalsh", None))


def _solve_line(label, parts, code, extra=""):
    """Print one solve's line: code, iterations, seconds, launches."""
    from clrs_tpu_torch.dd import kernels as K

    n_it = parts.marks[-1][0] if parts.marks else 0
    plain = {f.__name__ for f in K._PLAIN}
    launches = sum(v for k, v in parts.counts.items()
                   if k not in plain and "<" not in k)
    print(f"{label}: code {code}, iterations {n_it}, solve "
          f"{parts.seconds['solve']:.2f} s, "
          f"{parts.seconds['solve'] / max(n_it, 1):.4f} s/iteration "
          f"({parts.per_iteration():.4f} after the first), kernel launches "
          f"{launches}{extra}", flush=True)
    return n_it


def certified_route(card, problem_3_10, problem_3_95, runs):
    """Phase 14 (b): with _STEPLEN_VERIFIED = True, delsarte(3,10) solved
    at the f32 default through the graphs (code 0, Optimal, within 1e-9 of
    the oracle, every kernel of PATH_3_10 launched); three iterations of
    delsarte(3,95) eagerly with every certified bound held to the band
    below the f64 eigvalsh lambda_min of the same member, then through the
    graphs (mu/alpha within rel 1e-12 of the eager run's, PATH_3_95
    launched); the JAX package's test_verified_steplen_reaches_1e15_gap
    (delsarte(3,4), prec 212: nw 8, thresholds 1e-20: code 0, pdOpt); then
    graph wall ms per iteration on both routes at both problems, in turns.
    Adds each solve's counts to ``runs``."""
    import math

    import torch

    import clrs_tpu_torch as ct
    from clrs_tpu_torch.dd import kernels as K
    from clrs_tpu_torch.examples import delsarte
    from clrs_tpu_torch.solver import step as TS

    TS._STEPLEN_VERIFIED = True
    try:
        parts = CertParts()
        status, _, ps, _, code = parts.solve(lambda: ct.solvesdp(
            problem_3_10, omega_p=100, omega_d=100, verbose=False,
            callback=parts.callback,
            **{k: STEP_KW[k] for k in ("dual_error_threshold",
                                       "primal_error_threshold")}))
        obj = float(ct.objvalue(problem_3_10, ps))
        label = "certified delsarte(3,10)"
        n_it = _solve_line(label, parts, code, f", objective {obj!r} |err| "
                           f"{abs(obj - DELSARTE_3_10):.3e}")
        if code != 0 or not ct.optimal(status) or \
                not abs(obj - DELSARTE_3_10) < 1e-9:
            fail(f"{label}: code {code}, status {status!r}, objective {obj!r}")
        check_counts(label, parts.counts, PATH_CERT_3_10, n_it)
        runs[label] = parts.counts

        ds95 = device_sdp(problem_3_95)
        band, inner = [], TS._eig_lo_certified

        def recording(W2, lam, V):
            lo = inner(W2, lam, V)
            A, bad = TS._eig_input(W2)
            with GUARD.allowed():       # the reference, cuSOLVER's
                band.append((lo, torch.linalg.eigvalsh(A)[:, 0], bad))
            return lo

        TS._eig_lo_certified = recording
        try:
            _, rows_e, _ = drive(ds95, "eager", 2)
        finally:
            TS._eig_lo_certified = inner
        lo = torch.cat([b[0] for b in band])
        ref = torch.cat([b[1] for b in band])
        ok = ~torch.cat([b[2] for b in band])
        scale = 1.0 + ref.abs()
        above = ((lo - ref) / scale)[ok].max().item()
        below = ((ref - lo) / scale)[ok].max().item()
        print(f"certified delsarte(3,95), 3 eager iterations: {int(ok.sum())}"
              f" finite members of {lo.numel()}; certified bound - eigvalsh "
              f"lambda_min over 1 + |lambda|: at most {above:.3e} above, "
              f"{below:.3e} below; mu {[r['mu'] for r in rows_e]}; alpha_d "
              f"{[r['alpha_d'] for r in rows_e]}; alpha_p "
              f"{[r['alpha_p'] for r in rows_e]}", flush=True)
        if not (above <= BAND_ABOVE and below <= BAND_BELOW):
            fail("a certified bound at delsarte(3,95) lies outside "
                 f"[-{BAND_BELOW}, {BAND_ABOVE}] (1 + |lambda|) of eigvalsh's")
        _, rows_g, _ = drive(ds95, "graph", 2)
        runs["certified delsarte(3,95)"] = counts = K.counts()
        check_counts("certified delsarte(3,95) graph", counts,
                     PATH_CERT_3_95, 2)
        for re_, rg in zip(rows_e, rows_g):
            for k in ("mu", "alpha_d", "alpha_p"):
                if not math.isclose(re_[k], rg[k], rel_tol=1e-12):
                    fail(f"certified delsarte(3,95) graph {k} {rg[k]!r} is "
                         f"not within rel 1e-12 of the eager {re_[k]!r}")
        same = all(re_[k] == rg[k] for re_, rg in zip(rows_e, rows_g)
                   for k in ("mu", "alpha_d", "alpha_p"))
        print(f"certified delsarte(3,95) graph: mu/alpha equal the eager "
              f"run's {'to the last digit' if same else 'within rel 1e-12'}",
              flush=True)

        parts = CertParts()
        _, status, _, _, code = parts.solve(lambda: delsarte(
            3, 4, Fraction(1, 2), verbose=False, substrate="f32", prec=212,
            omega_p=100.0, omega_d=100.0, dual_error_threshold=1e-20,
            primal_error_threshold=1e-20, callback=parts.callback))
        label = "certified delsarte(3,4) f32 nw 8, thresholds 1e-20"
        n_it = _solve_line(label, parts, code, f", status {status!r}")
        if code != 0 or str(status) != "pdOpt":
            fail(f"{label}: code {code}, status {status!r}")
        check_counts(label, parts.counts, PATH_CERT_3_10, n_it)
        runs["certified delsarte(3,4) nw 8"] = parts.counts
    finally:
        TS._STEPLEN_VERIFIED = None

    print(card, flush=True)
    ds10 = device_sdp(problem_3_10)
    for label, ds in (("delsarte(3,10)", ds10), ("delsarte(3,95)", ds95)):
        for route, flag in ROUTES:
            TS._STEPLEN_VERIFIED = flag
            try:
                stats, _, _ = drive(ds, "graph", 5)
            finally:
                TS._STEPLEN_VERIFIED = None
            print(f"{label} graph, {route} route: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in stats.items()), flush=True)


# ---------------------------------------------------------------------------
# phase 15: the solve-level oracles of tests/test_solver_examples.py on the
# card, with their settings (the default step-length route)
# ---------------------------------------------------------------------------

MIN_F_2_F32 = -2.1129138814          # tests/test_solver_examples.py:52
COHNELKIES_8_3 = 0.3255058828303     # tests/test_solver_examples.py:66


def _oracles():
    """(label, solve(kw), value, tolerance, code and Optimal required) per
    f32 oracle of tests/test_solver_examples.py."""
    from clrs_tpu_torch.examples import cohnelkies, min_f

    tight = dict(omega_p=100.0, omega_d=100.0, verbose=False)
    return (
        ("min_f(2) f32 nw 5", lambda kw: min_f(
            2, dual_error_threshold=1e-12, primal_error_threshold=1e-12,
            **tight, **kw), MIN_F_2_F32, 1e-6, True),
        ("cohnelkies(8,3) f32 nw 5", lambda kw: cohnelkies(
            8, 3, dual_error_threshold=1e-10, primal_error_threshold=1e-10,
            **tight, **kw), COHNELKIES_8_3, 1e-8, False),
        ("cohnelkies(8,3) f32 nw 8", lambda kw: cohnelkies(
            8, 3, prec=212, substrate="f32", duality_gap_threshold=1e-11,
            dual_error_threshold=1e-10, primal_error_threshold=1e-10,
            **tight, **kw), COHNELKIES_8_3, 1e-8, True),
    )


def solve_oracles(card, runs):
    """Phase 15 (c): each oracle solved on the card with its test's
    settings: its value within the test's tolerance, code 0 and Optimal
    where the test asks for them; one line each (code, iterations, solve
    s, s per iteration, the port's kernel launches); each launches every
    kernel of PATH_3_10 and no plain version. Adds each solve's counts to
    ``runs``. The two oracles at d 15 (f64, nw 4) take minutes each on the
    card: tests/test_torch_gpu_examples.py runs them."""
    import clrs_tpu_torch as ct
    from clrs_tpu_torch.dd import kernels as K

    print(card, flush=True)
    for label, solve, want, tol, strict in _oracles():
        parts = CertParts()
        problem, status, _, ps, code = parts.solve(
            lambda: solve(dict(callback=parts.callback)))
        v = float(ct.objvalue(problem, ps))
        n_it = _solve_line(label, parts, code, f", status {status!r}, "
                           f"objective {v!r} |err| {abs(v - want):.3e}")
        if not abs(v - want) < tol:
            fail(f"{label}: objective {v!r} not within {tol} of {want!r}")
        if strict and (code != 0 or not ct.optimal(status)):
            fail(f"{label}: code {code}, status {status!r}")
        check_counts(label, parts.counts, PATH_NO_PACK if
                     label.startswith("min_f") else PATH_3_10, n_it)
        runs[label] = parts.counts
    K.reset_counts()


# ---------------------------------------------------------------------------
# phase 16: solver/timing.py on the card
# ---------------------------------------------------------------------------

def phase_tables(card, problem_3_10, problem_3_95):
    """Phase 16 (d): phase_breakdown at delsarte(3,95) from its initial
    state, f32 (nw 5) and f64 (nw 2), one table each (ms per call over 3
    calls after one, CUDA events); then solvesdp(testing=True) on
    delsarte(3,10) for three iterations prints its timing line and table."""
    import contextlib
    import io

    import torch

    import clrs_tpu_torch as ct
    from clrs_tpu_torch.solver.step import initial_state
    from clrs_tpu_torch.solver.timing import phase_breakdown

    print(card, flush=True)
    for label, ds in (("f32 nw 5", device_sdp(problem_3_95)),
                      ("f64 nw 2", device_sdp(problem_3_95, nw=2,
                                              dtype=torch.float64))):
        bd = phase_breakdown(ds, initial_state(ds, 100.0, 100.0))
        total = sum(bd.values())
        print(f"phase_breakdown delsarte(3,95) {label}: " + "; ".join(
            f"{k} {1e3 * v:.3f} ms ({100 * v / total:.1f}%)"
            for k, v in bd.items()) + f"; sum {1e3 * total:.3f} ms",
              flush=True)
        if not all(v > 0 for v in bd.values()):
            fail(f"phase_breakdown {label}: a phase took no time: {bd}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ct.solvesdp(problem_3_10, omega_p=100, omega_d=100, verbose=False,
                    maxiterations=3, testing=True)
    text = out.getvalue()
    print("solvesdp(testing=True), delsarte(3,10), 3 iterations:\n" + text,
          end="", flush=True)
    if not text.startswith("timing: ") or "sum of phases" not in text:
        fail("solvesdp(testing=True) printed no timing table")


# ---------------------------------------------------------------------------
# phase 13: sharded solves (clrs_tpu_torch.parallel) on the card: one NCCL
# rank in this process, then 2 and 4 gloo rank processes on the one card
# (gloo has no CUDA all-gather: the words are staged through host memory,
# so their times measure that transport, not a sharded solve's speed)
# ---------------------------------------------------------------------------

def bench_phase(problem_3_10):
    """Phase 17: torch_bench.bench_problem at delsarte(3,10) on both
    substrates, then solvesdp(substrate=None) against phase 4's solve."""
    import torch

    import clrs_tpu_torch as ct
    import torch_bench

    n_iters, reps = 4, 3
    for substrate, nw, kind, mfu in (
            ("f32", 5, "int8", "mfu_vs_h100_int8_peak"),
            ("f64", 2, "f64", "mfu_vs_h100_fp64_tc_peak")):
        r = torch_bench.bench_problem(problem_3_10, n_iters=n_iters, nw=nw,
                                      substrate=substrate, reps=reps,
                                      report_mfu=True)
        print(f"bench delsarte(3,10) {substrate} nw {nw}: "
              f"{r['iterations_per_s']:.2f} it/s (min "
              f"{r['iterations_per_s_min']:.2f}, max "
              f"{r['iterations_per_s_max']:.2f}), {r['committed']} "
              f"iterations committed, capture {r['capture_s']:.2f} s, "
              f"{kind} ops/iteration {r[kind + '_ops_per_iter']}, {mfu} "
              f"{r[mfu]:.3e}", flush=True)
        if r["committed"] != n_iters * reps:
            fail(f"bench {substrate}: {r['committed']} iterations committed"
                 f", not {n_iters * reps}")
        if not r[kind + "_ops_per_iter"] > 0 or not 0 < r[mfu] <= 1:
            fail(f"bench {substrate}: ops {r[kind + '_ops_per_iter']}, "
                 f"{mfu} {r[mfu]}")
    iters = []
    status, _, primalsol, t, code = ct.solvesdp(
        problem_3_10, substrate=None, omega_p=100, omega_d=100,
        verbose=False, callback=lambda it, info: iters.append(it),
        **{k: STEP_KW[k] for k in ("dual_error_threshold",
                                   "primal_error_threshold")})
    torch.cuda.synchronize()
    got = (code, iters[-1] if iters else 0,
           float(ct.objvalue(problem_3_10, primalsol)))
    print(f"delsarte(3,10) substrate=None: code, iterations, objective "
          f"{got}; phase 4 {SOLVES_3_10[1]}", flush=True)
    if got != SOLVES_3_10[1]:
        fail(f"substrate=None on the card gave {got}, phase 4 "
             f"{SOLVES_3_10[1]}")


PHASE13_DIR = "build/phase13"
RANK_TIMEOUT_S = 600


def axes_of(sdp, n):
    """What solvesdp(mesh of n ranks) distributes for ``sdp``: its row-panel
    groups, then the shard axes of the rest (parallel.api's row_plan and
    shard_plan on a host DeviceSDP of f64 words with the solve's padding,
    which needs no limb precompute)."""
    import copy

    import torch

    from clrs_tpu_torch.compile.preprocess import preprocess_sdp
    from clrs_tpu_torch.model.checks import remove_empty_blocks
    from clrs_tpu_torch.parallel import api, bigcluster
    from clrs_tpu_torch.solver.step import DeviceSDP

    sdp = copy.deepcopy(sdp)
    remove_empty_blocks(sdp, verbose=False)
    sdp, _ = preprocess_sdp(sdp, verbose=False)
    ds = DeviceSDP(sdp, nw=2, device="cpu", dtype=torch.float64,
                   mesh_divisor=n)
    parts = []
    for cl, on in zip(ds.clusters, api.row_plan(ds, n)):
        cl.row_shard = on
        if on:
            parts.append(f"row panels (P {cl.nrows}, {cl.nrows // n} rows a "
                         f"rank, nb {bigcluster.row_nb(cl.nrows, n)})")
    for sj, sb, ks in api.shard_plan(ds, n):
        parts += ["cluster [J]"] * sj + ["class [J*Lc]"] * any(ks) \
            + ["scalar pack [Bs]"] * sb
    return ", ".join(dict.fromkeys(parts)) or "none"


def sharded_solve(label, sdp, problem, world, kw):
    """One sharded solve in this rank: solvesdp(sdp, mesh=make_mesh(world),
    **kw) on the card, eager on every rank, with the kernels' launches
    counted (set to 0 just before, read just after), the wrappers' shapes
    recorded and the collectives counted. Returns a dict of plain data."""
    import torch

    import clrs_tpu_torch as ct
    from clrs_tpu_torch.dd import kernels as K
    from clrs_tpu_torch.parallel import comm, make_mesh

    mesh = make_mesh(world)
    rows = []

    def cb(it, info):
        rows.append((it, info["mu"], info["alpha_d"], info["alpha_p"]))

    K.reset_counts()
    comm.reset_counts()
    (st, _, ps, t, code), seen = recorded(lambda: ct.solvesdp(
        sdp, mesh=mesh, callback=cb, verbose=False, omega_p=100,
        omega_d=100, **{k: STEP_KW[k] for k in ("dual_error_threshold",
                                                "primal_error_threshold")},
        **kw))
    torch.cuda.synchronize()
    return dict(label=label, backend=comm.backend(), world=world, code=code,
                status=type(st).__name__, its=rows[-1][0] if rows else 0,
                rows=[r[1:] for r in rows], seconds=t,
                obj=None if problem is None
                else float(ct.objvalue(problem, ps)),
                counts=K.counts(), comm=comm.counts(), seen=seen,
                cusolver=GUARD.calls)


def _rank_main(rank, world, store, jobs, out_dir):
    """A gloo rank process of phase 13: its jobs in turn (sharded_solve's
    arguments), its results pickled to ``out_dir``."""
    import datetime
    import pickle

    import torch.distributed as dist

    GUARD.install()
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        out = [sharded_solve(*job) for job in jobs]
    finally:
        dist.destroy_process_group()
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def _fresh(path):
    import shutil
    from pathlib import Path

    path = Path(__file__).resolve().parent / path
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def gloo_ranks(world, jobs):
    """``jobs`` in ``world`` gloo rank processes on the card (spawned, one
    FileStore under build/); returns each rank's results, rank by rank.
    A rank that fails fails the phase."""
    import pickle

    import torch.multiprocessing as mp

    d = _fresh(f"{PHASE13_DIR}/gloo{world}")
    try:
        mp.spawn(_rank_main, args=(world, str(d / "store"), jobs, str(d)),
                 nprocs=world, join=True)
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        fail(f"a gloo rank of {world} failed: {e}")
    out = []
    for r in range(world):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def nccl_rank(jobs):
    """``jobs`` on one NCCL rank in this process (world size 1, a FileStore
    under build/)."""
    import datetime

    import torch
    import torch.distributed as dist

    d = _fresh(f"{PHASE13_DIR}/nccl1")
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(d / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S),
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        return [[sharded_solve(*job) for job in jobs]]
    finally:
        dist.destroy_process_group()


def sharded_path(card, problem_3_10, problem_3_95, rows_3_95, ks):
    """Phase 13: sharded solves on the card through solvesdp(mesh=...).
    13a: one NCCL rank, delsarte(3,95) by row panels, 3 iterations. 13b: 2
    gloo ranks (delsarte(3,95) by row panels, 3 iterations; delsarte(3,10)
    solved, by row panels too: P = 22 gives 11 rows a rank), then 4
    (delsarte(3,95) again; multi_cluster_test_problem(16, 8) solved on its
    cluster and class axes; 4 iterations of delsarte(3,10) on its class
    and scalar-pack axes, since 22 rows do not divide by 4). Each problem
    is compiled once here and handed to the ranks. Fails unless every rank
    ends as it should (mu/alpha within rel 1e-8 of phase 5's on row panels
    and within 1e-12 of the one-process card solve's on the class and
    scalar-pack axes; the full solves' codes, the one-process iterations
    and objectives), every rank launched every kernel of its path and no
    plain version, and every kernel equals its plain version at every
    shape the ranks gave it. Returns {label: launches summed over the
    ranks}."""
    import clrs_tpu_torch as ct
    from clrs_tpu_torch.parallel import multi_cluster_test_problem

    print(card, flush=True)
    t0 = time.time()
    sdp_95 = ct.ClusteredLowRankSDP(problem_3_95)
    sdp_10 = ct.ClusteredLowRankSDP(problem_3_10)
    multi = multi_cluster_test_problem(16, 8)
    sdp_multi = ct.ClusteredLowRankSDP(multi)
    kw = dict(omega_p=100, omega_d=100, verbose=False,
              **{k: STEP_KW[k] for k in ("dual_error_threshold",
                                         "primal_error_threshold")})
    its_multi, rows_10 = [], []
    _, _, ps, _, code_multi = ct.solvesdp(
        sdp_multi, callback=lambda it, info: its_multi.append(it), **kw)
    obj_multi = float(ct.objvalue(multi, ps))
    ct.solvesdp(sdp_10, maxiterations=4, callback=lambda it, info:
                rows_10.append(info), **kw)
    print(f"phase 13: problems compiled, multi_cluster_test_problem(16, 8) "
          f"solved (code {code_multi}, iterations {its_multi[-1]}, "
          f"objective {obj_multi!r}) and 4 iterations of delsarte(3,10) run "
          f"in one process in {time.time() - t0:.1f} s", flush=True)
    if code_multi != 0:
        fail(f"multi_cluster_test_problem(16, 8) ended with code "
             f"{code_multi} in one process")

    def mu_alpha(rows):
        return [(q["mu"], q["alpha_d"], q["alpha_p"]) for q in rows]

    row95 = ("delsarte(3,95) row panels", sdp_95, None)
    four = ("delsarte(3,10), 4 iterations", sdp_10, None)
    want = {row95[0]: dict(path=PATH_3_95, code=2, rows=mu_alpha(rows_3_95),
                           tol=1e-8),
            four[0]: dict(path=PATH_3_10, code=2, rows=mu_alpha(rows_10),
                          tol=1e-12),
            "delsarte(3,10)": dict(path=PATH_3_10, code=0, obj=DELSARTE_3_10,
                                   tol=1e-10),
            "multi_cluster_test_problem(16, 8)": dict(
                path=PATH_NO_PACK, code=0, obj=obj_multi, tol=1e-12,
                its=its_multi[-1], rel=True)}
    three = dict(maxiterations=3)
    runs, seen_all = {}, {}
    plan = (("13a", 1, nccl_rank, [row95 + (1, three)]),
            ("13b", 2, None, [row95 + (2, three),
                              ("delsarte(3,10)", sdp_10, problem_3_10, 2,
                               {})]),
            ("13b", 4, None, [row95 + (4, three),
                              ("multi_cluster_test_problem(16, 8)",
                               sdp_multi, multi, 4, {}),
                              four + (4, dict(maxiterations=4))]))
    for part, world, run, jobs in plan:
        t1 = time.time()
        ranks = run(jobs) if run else gloo_ranks(world, jobs)
        wall = time.time() - t1
        for j, (label, sdp, problem, _, _) in enumerate(jobs):
            res = [r[j] for r in ranks]
            w = want[label]
            axes = axes_of(sdp, world)
            for rank, r in enumerate(res):
                its = max(r["its"], 1)
                tag = f"{part} {label} {r['backend']} rank {rank}/{world}"
                if "obj" in w:
                    tol = w["tol"] * (max(1.0, abs(w["obj"]))
                                      if w.get("rel") else 1.0)
                    end = (f"objective {r['obj']!r}, |diff| "
                           f"{abs(r['obj'] - w['obj']):.3e}")
                    good = abs(r["obj"] - w["obj"]) <= tol
                else:
                    rel = [abs(a - b) / max(1.0, abs(b))
                           for g, q in zip(r["rows"], w["rows"])
                           for a, b in zip(g, q)]
                    end = (f"mu, alpha_d, alpha_p {r['rows']}, largest rel "
                           f"diff to the one-process solve's "
                           f"{max(rel, default=0.0):.3e}")
                    good = (len(r["rows"]) == len(w["rows"])
                            and max(rel) <= w["tol"])
                print(f"{tag}: axes {axes}; graphs: off (mesh); code "
                      f"{r['code']} {r['status']}, iterations {r['its']}, "
                      f"{r['seconds'] / its:.4f} s/iteration, words moved "
                      f"{r['comm']['words'] / its:.0f} and collectives "
                      f"{r['comm']['collectives'] / its:.1f} per iteration; "
                      f"{end}", flush=True)
                check_counts(tag, r["counts"], w["path"], its)
                if r["cusolver"]:
                    fail(f"{tag}: cuSOLVER ran on the card {r['cusolver']} "
                         "times")
                if r["code"] != w["code"]:
                    fail(f"{tag} ended with code {r['code']}")
                if "its" in w and r["its"] != w["its"]:
                    fail(f"{tag} took {r['its']} iterations, not the "
                         f"one-process {w['its']}")
                if not good:
                    fail(f"{tag}: {end} is not within its tolerance")
                for group, keys in r["seen"].items():
                    seen_all.setdefault(group, {}).update(keys)
            runs[f"phase 13 {label} ({world} {res[0]['backend']})"] = {
                k: sum(r["counts"][k] for r in res) for k in res[0]["counts"]}
        print(f"phase {part}, {world} rank(s): {wall:.1f} s", flush=True)
    compare_path_shapes(ks, seen_all, runs, phase=13)
    return runs


def main():
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    try:
        from clrs_tpu_torch.dd import build
    except ImportError as e:
        fail(f"run from the repository root: {e}")
    GUARD.install()
    card = card_line()
    print(card, flush=True)
    start = time.time()

    def lap(phases):
        print(f"phases {phases} done at {time.time() - start:.1f} s",
              flush=True)

    t0 = time.time()
    build.library()
    print(f"build: {time.time() - t0:.1f} s (nvcc "
          f"{build.build_seconds if build.build_seconds is not None else 'reused'})",
          flush=True)

    from clrs_tpu_torch.examples import delsarte_problem

    problem_3_10 = delsarte_problem(3, 10, Fraction(1, 2))
    t0 = time.time()
    problem_3_95 = delsarte_problem(3, 95, Fraction(1, 2))
    print(f"delsarte(3,95): host build {time.time() - t0:.1f} s", flush=True)

    print("kernels vs plain versions:", flush=True)
    ks = compare_kernels()
    compare_product_word_counts(ks)
    compare_expansion_kernels(ks, problem_3_10, problem_3_95)
    compare_eig_kernels(ks, problem_3_10, problem_3_95)
    torch.cuda.synchronize()
    lap("1-3")

    counts_3_10 = solve_delsarte_3_10(problem_3_10)
    counts_3_95, rows_3_95 = delsarte_3_95(problem_3_95)
    runs = {"delsarte(3,10)": counts_3_10, "delsarte(3,95)": counts_3_95}
    graph_vs_eager(card, problem_3_10, problem_3_95, rows_3_95)
    lap("4-6")

    compare_f64_ops()
    compare_slice_matmul([(2, 9, k, 7, nw) for k in (1, 22, 192)
                          for nw in F64_NWS])
    solve_delsarte_3_10_f64(problem_3_10)
    lap("7-8")
    shapes = delsarte_3_95_f64(problem_3_95, rows_3_95)
    print(f"delsarte(3,95) f64: slice GEMM shapes (B, m, k, n, nw) {shapes}",
          flush=True)
    deepest = max(shapes, key=lambda sh: (sh[2], sh[0] * sh[1] * sh[3]))
    largest = max(shapes, key=lambda sh: sh[0] * sh[1] * sh[2] * sh[3])
    compare_slice_matmul(sorted({deepest, largest}))
    time_slice_matmul(card, largest)
    lap("9")
    min_f_literal_defaults()
    lap("10")
    graph_vs_eager_f64(card, problem_3_10, problem_3_95)
    lap("11")
    runs.update(certificate_path(card, ks))
    lap("12")
    runs.update(sharded_path(card, problem_3_10, problem_3_95, rows_3_95,
                             ks))
    lap("13")
    new = {}

    def phases_14_16():
        certified_route(card, problem_3_10, problem_3_95, new)
        lap("14")
        solve_oracles(card, new)
        lap("15")
        phase_tables(card, problem_3_10, problem_3_95)
        lap("16")

    _, seen = recorded(phases_14_16)
    compare_path_shapes(ks, seen, new, phase="14-16")
    runs.update(new)
    lap("14-16 shapes")
    bench_phase(problem_3_10)
    lap("17")
    for name, r in ks.recs.items():
        r["launches_by_run"] = {k: c[name] for k, c in runs.items()}
        r["launches"] = sum(r["launches_by_run"].values())

    print(card, flush=True)
    print(json.dumps({"kernels": list(ks.recs.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
