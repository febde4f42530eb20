"""One instance set up as ``clrs_tpu_torch.solvesdp`` sets it up, and whole
solves of it driven as ``solvesdp``'s loop drives ``make_run_chunk`` with
``sync_every=1``: one ``run`` (one graph replay on the card) and one host
read of ``it_done``, ``code`` and the info an iteration, and the host's
termination tests (``clrs_tpu_torch/solver/ipm.py::solvesdp``, copied:
``terminate``, the iteration and complementary-gap limits, codes 1-4).
"""

from __future__ import annotations

import contextlib
import inspect
import time

import torch

# solvesdp's keywords that a configuration's "solve" may set
SETTINGS = ("maxiterations", "beta_infeasible", "beta_feasible", "gamma",
            "omega_p", "omega_d", "duality_gap_threshold",
            "dual_error_threshold", "primal_error_threshold",
            "max_complementary_gap", "step_length_threshold")


def _solvesdp_defaults() -> dict:
    from clrs_tpu_torch import solvesdp
    return {k: p.default
            for k, p in inspect.signature(solvesdp).parameters.items()}


def solve_settings(config: dict) -> dict:
    """solvesdp's own defaults of :data:`SETTINGS` (read from its
    signature), then the configuration's settings."""
    defaults = _solvesdp_defaults()
    out = {k: defaults[k] for k in SETTINGS}
    for k, v in config.get("solve", {}).items():
        if k not in out:
            raise KeyError(f"unknown solve setting {k!r}")
        out[k] = float(v) if k != "maxiterations" else int(v)
    return out


def default_words() -> int:
    """The f32 words of a solve at solvesdp's default precision."""
    from clrs_tpu_torch.solver.ipm import word_count
    return word_count(_solvesdp_defaults()["prec"])


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def leaves(tree):
    """The tensors of a state tree, depth first, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def rebuild(tree, flat, pos=0):
    """A tree of ``tree``'s structure whose leaves are views of ``flat``
    (the concatenation :meth:`Instance.keep` makes). Returns (tree, pos)."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out[k], pos = rebuild(tree[k], flat, pos)
        return out, pos
    if isinstance(tree, (list, tuple)):
        vals = []
        for v in tree:
            r, pos = rebuild(v, flat, pos)
            vals.append(r)
        return type(tree)(vals), pos
    n = tree.numel()
    return flat[pos:pos + n].view(tree.shape), pos + n


class Instance:
    """Set-up steps 1-7 for one problem: build, ``ClusteredLowRankSDP``,
    ``remove_empty_blocks`` and ``preprocess_sdp``, ``DeviceSDP`` at ``nw``
    words, ``make_run_chunk``, the start and its first info, one warm
    solve (which captures the step's graph on the card)."""

    def __init__(self, build, settings, nw, device, spans=False):
        from clrs_tpu_torch.compile.preprocess import preprocess_sdp
        from clrs_tpu_torch.compile.sdp import ClusteredLowRankSDP
        from clrs_tpu_torch.model.checks import remove_empty_blocks
        from clrs_tpu_torch.solver.ipm import _to_host
        from clrs_tpu_torch.solver.step import (F32, DeviceSDP,
                                                initial_state, make_assess,
                                                make_run_chunk, zero_info)
        self.s = s = settings
        self._to_host = _to_host
        self._span = (torch.profiler.record_function if spans
                      else lambda name: contextlib.nullcontext())
        t0 = time.perf_counter()
        problem = build()
        sdp = ClusteredLowRankSDP(problem)
        remove_empty_blocks(sdp, verbose=False)
        self.sdp, self.post = preprocess_sdp(sdp, verbose=False)
        self.ds = DeviceSDP(self.sdp, nw=nw, device=device, dtype=F32)
        _sync(device)
        self.host_build_s = time.perf_counter() - t0
        self.run = make_run_chunk(
            self.ds, duality_gap_threshold=s["duality_gap_threshold"],
            need_dual_feasible=False, need_primal_feasible=False,
            step_length_threshold=s["step_length_threshold"],
            max_complementary_gap=s["max_complementary_gap"],
            gamma=s["gamma"], beta_feasible=s["beta_feasible"],
            beta_infeasible=s["beta_infeasible"],
            dual_error_threshold=s["dual_error_threshold"],
            primal_error_threshold=s["primal_error_threshold"],
            safe_step=True, correctoronly=False)
        self.start = initial_state(self.ds, s["omega_p"], s["omega_d"])
        self.info0 = _to_host(make_assess(self.ds)(self.start))
        self.info_dev0 = zero_info(self.info0, self.ds.device)
        self.pd0 = (self.info0["dual_error"] < s["dual_error_threshold"]
                    and self.info0["primal_error"]
                    < s["primal_error_threshold"])
        self.solve()                      # captures the graph on the card
        split = self.run.loop["split"]
        self.capture_s = (split.warmup_seconds + split.capture_seconds
                          if hasattr(split, "capture_seconds") else None)
        self.carry = self.run.loop["carry"][0]
        self._flat = [t.reshape(-1) for t in leaves(self.carry)]

    def _terminate(self, dual_error, primal_error, dual_gap):
        s = self.s
        return (dual_error < s["dual_error_threshold"]
                and primal_error < s["primal_error_threshold"]
                and dual_gap < s["duality_gap_threshold"])

    def solve(self):
        """One whole solve from the start: (iterations committed, code,
        converged). Code 2: the iteration limit; 1, 3, 4 as solvesdp."""
        s, span = self.s, self._span
        info = self.info0
        mu, dual_error = info["mu"], info["dual_error"]
        primal_error, dual_gap = info["primal_error"], info["dual_gap"]
        state, feas, info_dev = self.start, self.pd0, self.info_dev0
        it, code = 1, 0
        while not self._terminate(dual_error, primal_error, dual_gap):
            if it > s["maxiterations"]:
                code = 2
                break
            if mu > s["max_complementary_gap"]:
                code = 3
                break
            with span("bench.replay"):
                state, feas, info_dev, itd, c, _ = self.run(
                    state, feas, info_dev, 1)
            with span("bench.host_read"):
                h = self._to_host(info_dev, it_done=itd, code=c)
            itd, c = int(h.pop("it_done")), int(h.pop("code"))
            if itd:
                it += itd
                mu, dual_error = h["mu"], h["dual_error"]
                primal_error, dual_gap = h["primal_error"], h["dual_gap"]
            if c in (1, 3, 4):
                code = c
                break
            if itd == 0:
                break
        converged = self._terminate(dual_error, primal_error, dual_gap)
        return it - 1, code, converged

    def keep(self):
        """The final state's words as one new device tensor (one launch)."""
        return torch.cat(self._flat)

    def state_of(self, flat):
        """The state tree whose words are ``flat`` (a :meth:`keep`)."""
        return rebuild(self.carry, flat)[0]

    def answer(self, flat):
        """(DualSolution, PrimalSolution) of a kept state: solvesdp's own
        extraction (``solver/ipm.py::_extract``)."""
        from clrs_tpu_torch.solver.ipm import _extract
        return _extract(self.ds, self.sdp, self.state_of(flat), self.post)
