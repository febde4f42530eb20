"""Shared helpers of the port's tests (tests/test_torch_*.py).

The problem functions take the API module (``clrs_tpu`` or
``clrs_tpu_torch``): a clrs_tpu Problem is not an instance of the port's
Problem class, so both packages build their own from the same function.
This module imports nothing of JAX.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch


def split_words(v, nw):
    """f64 values -> nw f32 word arrays by successive rounding."""
    h = np.asarray(v, np.float64)
    ws = []
    for _ in range(nw):
        w = h.astype(np.float32)
        ws.append(w)
        h = h - w.astype(np.float64)
    return ws


def spd_words(B, n, nw, seed):
    """nw f32 words of B random symmetric positive definite n x n matrices."""
    a = np.random.default_rng(seed).standard_normal((B, n, n))
    return split_words(a @ a.transpose(0, 2, 1) + n * np.eye(n), nw)


@pytest.fixture
def xla_subnormals():
    """Run the port in XLA:CPU's flush-to-zero mode: XLA:CPU flushes f32
    and f64 subnormals, eager PyTorch keeps them (as the CUDA kernels do),
    so comparisons of the op sequence with the JAX package flush on both
    sides. The flush mode is the calling thread's, so the port runs on that
    one thread meanwhile: a worker thread started now (by ATen or MKL)
    would inherit the flush mode and keep it for every later test of the
    process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)


def delsarte(api, d):
    """delsarte(3, d, 1/2) (examples/delsarte.py:15-35): SOS blocks of
    sizes d+1 and d, and 2d 1x1 blocks (the scalar pack)."""
    costheta = Fraction(1, 2)
    obj = api.Objective(0, {}, {"M": 1})
    R, x = api.polynomial_ring("x")
    samples = api.sample_points_chebyshev(2 * d, -1, costheta)
    basis = api.basis_chebyshev(2 * d, x)
    sosbasis, samples = api.approximatefekete(basis, samples)
    gp = api.basis_gegenbauer(2 * d, 3, x)
    psd1 = {("a", k): [[gp[k]]] for k in range(1, 2 * d + 1)}
    psd1[("SOS", 1)] = api.LowRankMatPol([1], [sosbasis[: d + 1]])
    psd1[("SOS", 2)] = api.LowRankMatPol([(1 + x) * (costheta - x)],
                                         [sosbasis[:d]])
    psd2 = {("a", k): [[1]] for k in range(1, 2 * d + 1)}
    psd2["slack"] = [[1]]
    return api.Problem(api.Minimize(obj), [
        api.Constraint(-1, psd1, {}, samples),
        api.Constraint(-1, psd2, {"M": -1})])


def dense2(api):
    """max <I/2, X> s.t. X11 = 1, X22 = 2: one dense 2x2 block."""
    half = Fraction(1, 2)
    obj = api.Objective(0, {"X": [[half, 0], [0, half]]}, {})
    return api.Problem(api.Maximize(obj), [
        api.Constraint(1, {"X": [[1, 0], [0, 0]]}),
        api.Constraint(2, {"X": [[0, 0], [0, 1]]})])


def polyopt(api):
    """max lambda s.t. x^2 + 1 - lambda is SOS on [-1, 1] samples
    (examples/polyopt.py); oracle 1."""
    R, x = api.polynomial_ring("x")
    sosbasis = api.basis_chebyshev(1, x)
    samples = api.sample_points_chebyshev(2, -1, 1)
    c = {("sos", 1): api.LowRankMatPol([1], [sosbasis[:2]])}
    return api.Problem(api.Maximize(api.Objective(0, {}, {"lambda": 1})),
                       [api.Constraint(x ** 2 + 1, c, {"lambda": 1},
                                       samples)])


# the info entries a chunk's result is compared on (the contract of
# tests/test_torch_step.py::test_slice_matches_jax_f64_steps)
CHUNK_INFO = ("mu", "d_obj", "p_obj", "alpha_d", "alpha_p")


def chunk_rows(step_mod, ds, run, zero_info, start, nmaxs):
    """Run ``run`` (a make_run_chunk of either package, from the step
    module ``step_mod``) from initial_state(ds, *start) for chunks of
    ``nmaxs`` iterations in turn; per chunk, ((it_done, code, done,
    pd_feas), the CHUNK_INFO values)."""
    state = step_mod.initial_state(ds, *start)
    info0 = {k: float(v) for k, v in step_mod.make_assess(ds)(state).items()}
    carry = (state, False, zero_info(info0))
    rows = []
    for n in nmaxs:
        state, pd, info, it, code, done = run(*carry, n)
        carry = (state, pd, info)
        rows.append(((int(it), int(code), bool(done), bool(pd)),
                     tuple(float(info[k]) for k in CHUNK_INFO)))
    return rows


def assert_chunks_match_jax(step_j, dj, run_j, chunk_kw, start, nmaxs,
                            endings):
    """The port's make_run_chunk (polyopt, f32 nw=5, the CPU) against the
    JAX package's ``run_j`` on ``dj`` (its polyopt DeviceSDP, from its step
    module ``step_j``): the JAX chunks end as ``endings`` [(it_done, code,
    done)] say, the port's (it_done, code, done, pd_feas) equal them, and
    the CHUNK_INFO values agree at rel 1e-13, abs 1e-18."""
    import clrs_tpu_torch as ct
    from clrs_tpu_torch.solver import step as TS

    rows_j = chunk_rows(step_j, dj, run_j, step_j.zero_info, start, nmaxs)
    dt = TS.DeviceSDP(ct.ClusteredLowRankSDP(polyopt(ct)), nw=5,
                      device="cpu")
    rows_t = chunk_rows(TS, dt, TS.make_run_chunk(dt, **chunk_kw),
                        lambda i: TS.zero_info(i, "cpu"), start, nmaxs)
    assert [r[0][:3] for r in rows_j] == endings
    for (flags_j, info_j), (flags_t, info_t) in zip(rows_j, rows_t):
        assert flags_t == flags_j
        for a, b in zip(info_j, info_t):
            assert b == pytest.approx(a, rel=1e-13, abs=1e-18), \
                (info_j, info_t)


def poison_x(state):
    """Put a NaN at (0, 1) and (1, 0) of word 0 of X's first class, in
    place: chol(X) then fails at its second pivot and leaves NaNs in the
    factor, so the step-length matrices are not finite. Returns state."""
    w0 = state["X"][0][0][0]
    w0[:, 0, 1] = float("nan")
    w0[:, 1, 0] = float("nan")
    return state


def solution_data(sol):
    """A DualSolution or PrimalSolution of either package -> the plain data
    that clrs_tpu_torch.state.solution_from_data takes (read through the
    classes' attributes, so the JAX package's pass as well)."""
    def key(k):
        if type(k).__name__ == "Block":
            return ("block", k.l, k.r, k.s)
        return ("name", k)

    def entry(v):
        if hasattr(v, "hi"):
            return (float(v.hi), float(v.lo))
        return Fraction(v)

    mats = [(key(k), [[entry(v) for v in row] for row in np.asarray(m)])
            for k, m in sol.matrixvars.items()]
    if hasattr(sol, "x"):
        return {"kind": "dual", "matrixvars": mats,
                "x": [[entry(v) for v in xs] for xs in sol.x]}
    return {"kind": "primal", "matrixvars": mats,
            "freevars": [(n, entry(v)) for n, v in sol.freevars.items()]}


def _exact(v):
    """A number, a polynomial (its terms), a sampled polynomial (its
    evaluations) or a field element (its coefficients) as plain exact
    data."""
    if hasattr(v, "terms"):
        return {e: _exact(c) for e, c in v.terms.items()}
    if hasattr(v, "evaluations"):
        return [_exact(c) for c in v.evaluations]
    if hasattr(v, "coeffs"):
        return [Fraction(c) for c in v.coeffs]
    return Fraction(v)


def _exact_matrix(m):
    if hasattr(m, "lam"):      # a LowRankMatPol: its values and vectors
        return ("low rank", [_exact(x) for x in m.lam],
                [[_exact(x) for x in v] for v in m.vs],
                [[_exact(x) for x in w] for w in m.ws])
    if hasattr(m, "to_dense"):
        m = m.to_dense()
    a = np.asarray(m, dtype=object)
    return [[_exact(v) for v in row] for row in a.reshape(a.shape[0], -1)]


def _key(k):
    """A block name, a Block of either package as a plain tuple."""
    return ("block", k.l, k.r, k.s) if type(k).__name__ == "Block" else k


def problem_data(problem):
    """A Problem of either package as plain exact data: the sense, then
    the objective and each constraint as (constant, {name: matrix of
    Fractions}, {free name: Fraction}, samples)."""
    def part(c):
        return (_exact(c.constant),
                {_key(k): _exact_matrix(m) for k, m in c.matrixcoeff.items()},
                {k: _exact(v) for k, v in c.freecoeff.items()},
                [[_exact(x) for x in np.atleast_1d(np.asarray(s, object))]
                 for s in getattr(c, "samples", [])])

    return (problem.maximize, part(problem.objective),
            [part(c) for c in problem.constraints])


def built_problem(module, build, *args, **kwargs):
    """The Problem that ``build`` (an example of either package that builds
    a problem and hands it to ``module.solvesdp``) builds, with the solve
    stopped there."""
    class Built(Exception):
        pass

    def stop(problem, *a, **kw):
        raise Built(problem)

    inner = module.solvesdp
    module.solvesdp = stop
    try:
        build(*args, **kwargs)
    except Built as e:
        return e.args[0]
    finally:
        module.solvesdp = inner
    raise AssertionError(f"{build.__name__} did not call solvesdp")


def exact_entries(sol):
    """An exact solution's entries by key, field elements as their
    coefficient lists, comparable across the packages' classes."""
    out = {_key(k): [[_exact(v) for v in row] for row in np.asarray(m)]
           for k, m in sol.matrixvars.items()}
    if hasattr(sol, "freevars"):
        out["free"] = {k: _exact(v) for k, v in sol.freevars.items()}
    return out


# ---------------------------------------------------------------------------
# rank processes of the sharded tests (tests/test_torch_parallel_*.py):
# spawned by torch.multiprocessing, one thread each, on a gloo FileStore;
# they import nothing of JAX and hand their words back as numpy arrays
# ---------------------------------------------------------------------------

STEP_KW = dict(gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
               dual_error_threshold=1e-12, primal_error_threshold=1e-12)


def _rank_main(rank, world, tmp, job, args, flush):
    import datetime
    import pickle

    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.set_flush_denormal(flush)
    # a collective that one rank misses fails after this, not after gloo's
    # default half hour
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{tmp}/store", world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        out = globals()[job](*args)
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def run_ranks(tmp_path, world, job, *args, flush=False):
    """Run ``job(*args)`` (a function of this module) in ``world`` gloo rank
    processes; returns each rank's result, rank by rank. ``flush`` sets
    XLA:CPU's flush of subnormals in the ranks (their one thread)."""
    import pickle

    import torch.multiprocessing as mp

    mp.spawn(_rank_main, args=(world, str(tmp_path), job, args, flush),
             nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def state_words(state):
    """A state's words as a flat list of numpy arrays, leaf by leaf."""
    out = [c.detach().cpu().numpy() for c in state["y"]]
    for key in ("x", "Xs", "Ys"):
        for ws in state[key]:
            out += [c.detach().cpu().numpy() for c in ws]
    for key in ("X", "Y"):
        for cls in state[key]:
            for ws in cls:
                out += [c.detach().cpu().numpy() for c in ws]
    return out


def steps(sdp, nw, dtype, mesh_divisor, row, world, n=1, device="cpu"):
    """``n`` eager steps of ``sdp`` from omega 100 I on ``device``: over a
    mesh of ``world`` ranks (row panels if ``row``, else the cluster,
    class and scalar-pack axes) when ``world``, else in one process.
    Returns (each step's info, the words of the whole last state, gathered
    from every rank)."""
    from clrs_tpu_torch.parallel import api
    from clrs_tpu_torch.solver import step as TS

    ds = TS.DeviceSDP(sdp, nw=nw, device=device, dtype=dtype,
                      mesh_divisor=mesh_divisor)
    state = TS.initial_state(ds, 100.0, 100.0)
    if world:
        mesh = api.make_mesh(world)
        if row:
            assert api.enable_row_sharding(ds, mesh) == 1
        else:
            assert api.shard_device_sdp(ds, mesh) >= 1
        state = api.shard_state(ds, state, mesh)
    step = TS.make_step_body(ds, **STEP_KW)
    infos, feas = [], False
    for _ in range(n):
        state, info = step(state, feas)
        infos.append({k: float(v) for k, v in info.items()})
        feas = bool(info["pd_feas"])
    return infos, state_words(api.gather_state(ds, state))


def solve_on_mesh(problem, world, kw):
    """``solvesdp(problem, mesh=make_mesh(world), device="cpu", **kw)`` (no
    mesh when ``world`` is 0): (code, status name, iterations, objective)."""
    import clrs_tpu_torch as ct
    from clrs_tpu_torch.parallel import make_mesh

    its = []
    st, dsol, psol, t, code = ct.solvesdp(
        problem, mesh=make_mesh(world) if world else None, device="cpu",
        callback=lambda it, info: its.append(it), **kw)
    return (code, type(st).__name__, its[-1] if its else 0,
            float(ct.objvalue(problem, psol)))


def dist_linalg(S, L, B, nb):
    """The port's row-panel functions on this rank's rows
    (clrs_tpu_torch.parallel.bigcluster, f32 words on the CPU): the factor
    of S (gathered) and its ok flag, and L X = B and L^T X = B given the
    factor L; S, L [P, P] and B [P, m] are word lists, replicated."""
    from clrs_tpu_torch.parallel import bigcluster as bc
    from clrs_tpu_torch.parallel.api import make_mesh
    from clrs_tpu_torch.parallel.comm import Comm

    world = torch.distributed.get_world_size()
    cm = Comm(make_mesh(world))
    P = S[0].shape[0]
    t = lambda ws: tuple(torch.from_numpy(np.array(w)) for w in ws)  # noqa
    L_loc, ok = bc.dist_cholesky(cm.local_rows(t(S)), P, cm, nb)
    Lj = cm.local_rows(t(L))
    out = [cm.all_gather(L_loc, 0),
           bc.dist_solve_tril(Lj, t(B), P, cm, nb),
           bc.dist_solve_tril_t(Lj, t(B), P, cm, nb)]
    return bool(ok), [[c.numpy() for c in ws] for ws in out]


def save_on_rank_1(*args):
    """A SaveSettings callback that only rank 1 answers yes to."""
    return torch.distributed.get_rank() == 1


# ---------------------------------------------------------------------------
# the expansion kernels' launch arguments, emulated on CPU memory as the
# CUDA kernels read and write it (csrc/exptree.cu, csrc/expfuse.cu)
# ---------------------------------------------------------------------------

def raw_memory(ptr, offsets):
    """float32 array over the memory a kernel reads at ``ptr`` + offsets
    (elements)."""
    import ctypes

    size = int(np.max(offsets)) + 1 if np.size(offsets) else 1
    return np.ctypeslib.as_array((ctypes.c_float * size).from_address(ptr))


def index_offsets(dims, st):
    """Element offsets of every index of ``dims`` (row-major, last dim
    fastest: the kernels' unravel order) under strides ``st``."""
    if not dims:
        return np.zeros((1,), np.int64)
    ix = np.indices(dims).reshape(len(dims), -1)
    return np.asarray(st, np.int64) @ ix


def _slot_strides(strides, slot, nd, maxd=6):
    base = (slot + 1) * maxd - nd
    return tuple(strides[base:base + nd])


def _read(ptr, off):
    return torch.from_numpy(raw_memory(ptr, off)[off].copy())


def emulate_tree_launch(ln, nw, rng):
    """Run one clrs_tree_sum launch (a kernels.TreeLaunch) on CPU memory as
    csrc/exptree.cu does: entries read through the views (the product and
    the scale on load), level 1 on load, the block, cluster or level
    route's levels with each level's adds in a shuffled order (and, on the
    cluster route, block by block in a shuffled block order), the epilogue,
    the stores through dst's strides."""
    from clrs_tpu_torch.dd import kernels as K
    from clrs_tpu_torch.dd import ops as O

    nd, ne, M, n = ln.nd, ln.ne, ln.M, ln.n
    dims = tuple(ln.dims[:nd])
    cd, ed = dims[:nd - ne], dims[nd - ne:]
    assert int(np.prod(cd)) == M
    assert (int(np.prod(ed)) == n) if ne else n <= 1
    MW = K._MAX_NW

    def offs(st):
        co = index_offsets(cd, st[:nd - ne])
        eo = index_offsets(ed, st[nd - ne:]) if ne else np.zeros(1, np.int64)
        return co, eo

    def group(j, e):
        out = []
        for k in range(nw):
            co, eo = offs(_slot_strides(ln.strides, j * MW + k, nd))
            out.append(_read(ln.ptrs[j * MW + k],
                             co[:, None] + eo[np.asarray(e, np.int64)][None]))
        return tuple(out)

    def scale(e):
        if ln.scale is None:
            return ln.scale_c
        co, eo = offs(tuple(ln.scale_st[6 - nd:]))
        return _read(ln.scale.data_ptr(),
                     co[:, None] + eo[np.asarray(e, np.int64)][None])

    def P(e):
        x = group(0, e)
        if ln.scale_on == 1:
            x = tuple(c * scale(e) for c in x)
        if ln.pro == 0:
            return x
        p = O.exp_mul(x, group(1, e))
        if ln.scale_on == 2:
            p = tuple(c * scale(e) for c in p)
        return p

    def level1(idx):
        """Level-1 entries idx, in idx's order."""
        idx = np.asarray(idx, np.int64)
        is_pair = idx < n // 2
        pair, mid = idx[is_pair], idx[~is_pair]
        out = [torch.zeros((M, len(idx))) for _ in range(nw)]
        if pair.size:
            s = O.exp_add(P(pair), P(pair + (n + 1) // 2))
            for o, c in zip(out, s):
                o[:, torch.from_numpy(is_pair)] = c
        if mid.size:
            for o, c in zip(out, P(mid)):
                o[:, torch.from_numpy(~is_pair)] = c
        return out

    def finish(r, e=0):
        if ln.epi:
            acc = group(2, [0])
            r = (O.exp_add if ln.epi == 1 else O.exp_sub)(
                acc, tuple(c.reshape(M, 1) for c in r))
        dmem = raw_memory(ln.dst.data_ptr(), np.array([ln.dst.numel() - 1]))
        for k, w in enumerate(r):
            off = k * ln.ws + np.arange(M) * ln.cs + e * ln.es
            dmem[off] = w.reshape(M).numpy()

    def levels(E, m, stop, blocks=None):
        while m > stop:
            h, half = m // 2, (m + 1) // 2
            order = rng.permutation(h)
            if blocks is not None:       # block by block, in no order
                S = blocks
                order = np.concatenate([
                    rng.permutation(np.arange(b * S, min(b * S + S, h)))
                    for b in rng.permutation(-(-h // S))])
            for chunk in np.array_split(order, max(1, h // 7)):
                if chunk.size:
                    s = O.exp_add(tuple(c[:, chunk] for c in E),
                                  tuple(c[:, chunk + half] for c in E))
                    for c, sc in zip(E, s):
                        c[:, chunk] = sc
            m = half
        return m

    h1 = (n + 1) // 2
    if ln.level == 0:
        if ln.G == 1:
            assert ln.C >= 1 and ln.S == 0
        else:
            assert ln.C == 1 and ln.S == -(-h1 // ln.G) and ln.S > 0
        if h1 == 0:
            finish(tuple(torch.zeros(M) for _ in range(nw)))
            return
        E = level1(np.arange(h1))
        m = h1
        if ln.G > 1:
            m = levels(E, m, ln.S, blocks=ln.S)
        levels(E, m, 1)
        finish(tuple(c[:, 0] for c in E))
        return
    assert n >= 2
    dmem = raw_memory(ln.dst.data_ptr(), np.array([ln.dst.numel() - 1]))
    for chunk in np.array_split(rng.permutation(h1), max(1, h1 // 8)):
        if not chunk.size:
            continue
        v = level1(chunk)
        if n == 2:
            finish(tuple(c[:, 0] for c in v))
            continue
        for k, w in enumerate(v):
            off = (k * ln.ws + np.arange(M)[:, None] * ln.cs
                   + chunk[None, :] * ln.es)
            dmem[off] = w.numpy()


def emulate_fuse_launch(pack, form, nops, nw, scale=None, sc_op=-1,
                        mask=None):
    """Run one clrs_expfuse launch on CPU memory from ew_fuse_pack's
    arguments: every operand, the scale and the mask gathered through
    their pointers and strides, the form's plain op sequence, the words
    stored through the output's pointers and strides."""
    from clrs_tpu_torch.dd import kernels as K
    from clrs_tpu_torch.dd import ops as O

    (shape, numel, words, ptrs, strides, shared, sc_st, mk_st, outp, out_st,
     dims, nd) = pack
    d = tuple(dims[:nd])
    assert int(np.prod(d)) == numel
    MW = K._MAX_NW
    a = []
    for j in range(nops):
        a.append(tuple(_read(ptrs[j * MW + k], index_offsets(
            d, _slot_strides(strides, j * MW + k, nd))) for k in range(nw)))
    if sc_op >= 0:
        s = (_read(scale.data_ptr(), index_offsets(d, tuple(sc_st[6 - nd:])))
             if isinstance(scale, torch.Tensor) else scale)
        a[sc_op] = tuple(c * s for c in a[sc_op])
    r = {"fma": lambda: O.exp_add(a[0], O.exp_mul(a[1], a[2])),
         "fms": lambda: O.exp_sub(a[0], O.exp_mul(a[1], a[2])),
         "msub": lambda: O.exp_sub(O.exp_mul(a[0], a[1]), a[2]),
         "mms": lambda: O.exp_sub(O.exp_mul(a[0], a[1]),
                                  O.exp_mul(a[2], a[3])),
         "sub2": lambda: O.exp_sub(O.exp_sub(a[0], a[1]), a[2])}[form]()
    if mask is not None:
        m = _read(mask.data_ptr(), index_offsets(d, tuple(mk_st[6 - nd:])))
        r = tuple(c * m for c in r)
    off = index_offsets(d, tuple(out_st[6 - nd:]))
    for k, w in enumerate(r):
        raw_memory(outp[k], off)[off] = w.numpy()
    return words


def unfused_forms():
    """{wrapper name: the same function as a composition of the port's
    plain expansion ops (clrs_tpu_torch.dd.ops) and PyTorch word scales}:
    the fused forms as the step computed them before they were fused."""
    from clrs_tpu_torch.dd import kernels as K
    from clrs_tpu_torch.dd import ops as O

    def masked(r, m):
        return r if m is None else tuple(c * m for c in r)

    def tree(x, y, axis, acc=None, sub=False, scale=None, scale_on=None):
        if scale_on == "x":
            x = tuple(c * scale for c in x)
        p = O.exp_mul(x, y) if y is not None else x
        if scale_on == "product":
            p = tuple(c * scale for c in p)
        p, axis = K.flatten_sum_axes(p, axis)
        s = K.pairwise_sum(p, axis, O.exp_add)
        if acc is None:
            return s
        return O.exp_sub(acc, s) if sub else O.exp_add(acc, s)

    def select(cond, pairs):
        pairs = list(pairs)
        for src, dst in pairs:
            for d, c in zip(dst, src):
                d.copy_(torch.where(cond, c, d))
        return [dst for _, dst in pairs]

    return {
        "ew_fma": lambda a, b, c, mask=None: masked(
            O.exp_add(a, O.exp_mul(b, c)), mask),
        "ew_fms": lambda a, b, c, mask=None: masked(
            O.exp_sub(a, O.exp_mul(b, c)), mask),
        "ew_msub": lambda a, b, c, mask=None: masked(
            O.exp_sub(O.exp_mul(a, b), c), mask),
        "ew_mms": lambda a, b, c, d, mask=None: masked(
            O.exp_sub(O.exp_mul(a, b), O.exp_mul(c, d)), mask),
        "ew_sub2": lambda a, b, c, c_scale=None, mask=None: masked(
            O.exp_sub(O.exp_sub(a, b), c if c_scale is None
                      else tuple(w * c_scale for w in c)), mask),
        "tree_sum_fused": tree,
        "ew_select": select,
    }
