"""The port's chunked solve loop on the CPU, without JAX.

- ``solvesdp(sync_every=3)`` ends as ``sync_every=1`` does: the same
  iterations, code and objective.
- A step whose Cholesky fails gives code 1, never an exception, from the
  eager step, ``make_run_chunk`` and ``solvesdp``, with an eigensolver that
  raises on a non-finite input as PyTorch does on the card (it reads
  cuSOLVER's ``info``); the CPU's LAPACK route returns quietly.
- The head and the tail of a step, the parts captured in CUDA graphs on
  the card, read no device value on the host and copy no host data to the
  device (a TorchFunctionMode: the CPU's proxy for capture safety).
- A replayed segment adds the launches its capture counted, and the
  capture itself adds none.
"""

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

import clrs_tpu_torch as ct
from clrs_tpu_torch.dd import kernels as K
from clrs_tpu_torch.solver import graph as G
from clrs_tpu_torch.solver import step as TS
from torch_helpers import delsarte, poison_x, polyopt, spd_words

STEP_KW = dict(gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
               dual_error_threshold=1e-12, primal_error_threshold=1e-12)


def _solve(sync_every, **kw):
    problem = polyopt(ct)
    its = []
    status, _, primalsol, _, code = ct.solvesdp(
        problem, device="cpu", verbose=False, sync_every=sync_every,
        callback=lambda it, info: its.append(it), **kw)
    return its, code, status, float(ct.objvalue(problem, primalsol))


def test_solvesdp_sync_every_ends_as_single_steps():
    """Eight iterations: the chunks of three end in the middle of the
    third; the callback runs once per chunk with the committed count."""
    kw = dict(omega_p=100.0, omega_d=100.0, duality_gap_threshold=1e-3,
              dual_error_threshold=1e-12, primal_error_threshold=1e-12)
    its1, code1, status1, obj1 = _solve(1, **kw)
    its3, code3, status3, obj3 = _solve(3, **kw)
    assert its1 == list(range(1, 9))
    assert its3 == [3, 6, 8]
    assert (code3, type(status3), obj3) == (code1, type(status1), obj1)
    assert code1 == 0 and ct.optimal(status1)


def _strict_eigvalsh(monkeypatch):
    """torch.linalg.eigvalsh that raises for a non-finite input, as the
    card's does through cuSOLVER's info."""
    eigvalsh = torch.linalg.eigvalsh
    seen = []

    def strict(A):
        seen.append(tuple(A.shape))
        if not torch.isfinite(A).all():
            raise torch.linalg.LinAlgError("non-finite eigensolver input")
        return eigvalsh(A)

    monkeypatch.setattr(torch.linalg, "eigvalsh", strict)
    return seen


def test_failing_cholesky_gives_code_1(monkeypatch):
    """A NaN in X: the eager step and make_run_chunk give ok False and
    code 1, and the eigensolver saw the NaN members zeroed. X = -I (a
    failing pivot, finite factors): code 1 from make_run_chunk and
    solvesdp."""
    seen = _strict_eigvalsh(monkeypatch)
    ds = TS.DeviceSDP(ct.ClusteredLowRankSDP(polyopt(ct)), nw=5,
                      device="cpu")
    head, tail = TS.make_step_parts(ds, **STEP_KW)
    state = poison_x(TS.initial_state(ds, 1.0, 1.0))
    mid, mats = head(state, torch.zeros((), dtype=torch.bool))
    assert [b.tolist() for b in mid["bads"]] == [[True, False]]   # X, Y
    _, info = tail(state, mid, TS.eig_lowest(mats))
    assert not bool(info["ok"]) and not bool(info["ok_X"])
    _, info = TS.make_step_body(ds, **STEP_KW)(state, False)
    assert not bool(info["ok"])
    run = TS.make_run_chunk(ds, duality_gap_threshold=1e-15, **STEP_KW)
    for start in (state, TS.initial_state(ds, -1.0, 100.0)):
        out = run(start, False, TS.zero_info(None, "cpu"), 3)
        assert (int(out[3]), int(out[4]), bool(out[5])) == (0, 1, True)
    _, _, _, _, code = ct.solvesdp(polyopt(ct), device="cpu", verbose=False,
                                   omega_p=-1.0, omega_d=100.0)
    assert code == 1
    assert len(seen) == 5


HOST_READS = frozenset({"__bool__", "__float__", "__int__", "__index__",
                        "item", "tolist", "cpu", "numpy", "tensor",
                        "as_tensor", "from_numpy", "eigvalsh", "eigh",
                        "nonzero"})


class _NoHostReads(TorchFunctionMode):
    """Raises on a call that reads a device value on the host or copies
    host data to the device, outside the kernels' plain versions (which
    stand in for the CUDA kernels on the CPU)."""

    def __init__(self):
        super().__init__()
        self.plain = 0
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if not self.plain and name in HOST_READS:
            raise AssertionError(f"host read or copy in a segment: {name}")
        self.calls += 1
        return func(*args, **(kwargs or {}))


def _guard_plain(monkeypatch, mode):
    for f in K._PLAIN:
        def inside(*a, _f=f, **kw):
            mode.plain += 1
            try:
                return _f(*a, **kw)
            finally:
                mode.plain -= 1
        monkeypatch.setattr(K, f.__name__, inside)


def test_segments_read_nothing_on_the_host(monkeypatch):
    """The step's head and tail, and the chunk loop's head and tail (with
    its commit and code ladder), on delsarte(3,3): the scalar pack, a
    non-scalar size class, the split GEMMs and the chain kernels' plain
    versions."""
    ds = TS.DeviceSDP(ct.ClusteredLowRankSDP(delsarte(ct, 3)), nw=5,
                      device="cpu")
    mode = _NoHostReads()
    _guard_plain(monkeypatch, mode)
    head, tail = TS.make_step_parts(ds, **STEP_KW)
    state = TS.initial_state(ds, 100.0, 100.0)
    pd = torch.zeros((), dtype=torch.bool)
    with mode:
        mid, mats = head(state, pd)
    lows = TS.eig_lowest(mats)
    with mode:
        tail(state, mid, lows)
    run = TS.make_run_chunk(ds, duality_gap_threshold=1e-15, **STEP_KW)
    out = run(state, False, TS.zero_info(None, "cpu"), 1)
    split = run.loop["split"]
    for part in ("_head", "_tail"):
        fn = getattr(split, part)

        def guarded(*a, _fn=fn):
            with mode:
                return _fn(*a)
        setattr(split, part, guarded)
    calls = mode.calls
    out = run(*out[:3], 2)
    assert int(out[3]) == 2 and mode.calls > calls


def test_segment_replays_count_their_captured_launches():
    """record() takes the counts a capture added back out; each replay of
    the Segment adds them again (a stand-in graph on the CPU)."""
    K.reset_counts()
    A = tuple(torch.from_numpy(w) for w in spd_words(2, 4, 5, 0))
    b = tuple(torch.from_numpy(w) for w in spd_words(2, 4, 5, 1))
    (Lw, ok), added = G.record(lambda: K.chol_batched(A))
    assert added == {"chol_plain": 1}
    _, added2 = G.record(lambda: K.tri_solve_batched(Lw, b, trans=True))
    assert added2 == {"tri_solve_plain": 1}
    assert all(v == 0 for v in K.counts().values())

    class Graph:
        replays = 0

        def replay(self):
            self.replays += 1

    seg = G.Segment(Graph(), dict(added, **{"tri_solve_batched<true>": 2,
                                            "tri_solve_batched": 2}))
    for _ in range(3):
        seg.replay()
    c = K.counts()
    assert seg.graph.replays == 3
    assert (c["chol_plain"], c["tri_solve_batched"],
            c["tri_solve_batched<true>"], c["tri_solve_batched<false>"]) \
        == (3, 6, 6, 0)
    K.add_counts(seg.launches, -3)
    assert all(v == 0 for v in K.counts().values())
    assert np.all(ok.numpy())
