"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from clrs_tpu_torch/csrc, with its seconds;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the main path (bit-identical is the tolerance), with times;
  4. delsarte(3, 10) through clrs_tpu_torch.solvesdp(device="cuda"): error
     code 0, Optimal, objective within 1e-9 of 13.15831434739031, and every
     kernel's launch count > 0 with every plain version's call count 0;
  5. three IPM iterations of delsarte(3, 95) (P = 192, SOS blocks 96/95:
     blocked Cholesky and solves, panel-scale GEMMs).
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
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


def time_ms(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


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


def _spd(rng, B, n, nw):
    import numpy as np

    a = rng.standard_normal((B, n, n))
    return _split(a @ a.transpose(0, 2, 1) + n * np.eye(n), nw)


def _compare(xs, ys):
    """(bit-identical?, max |x - y|) over paired tensors."""
    import torch

    same, err = True, 0.0
    for x, y in zip(xs, ys):
        if x.dtype == torch.float32:
            same &= torch.equal(x.view(torch.int32), y.view(torch.int32))
        else:
            same &= torch.equal(x, y)
        if x.numel():
            err = max(err, (x.double() - y.double()).abs().max().item())
    return same, err


def compare_kernels():
    """Phase 3: each kernel vs its plain version on the card. Returns the
    per-kernel records for the JSON summary."""
    import numpy as np
    import torch

    from clrs_tpu_torch.dd import kernels as K

    rng = np.random.default_rng(0)
    recs = {}

    def record(name, route_src, replaces, result, ms, plain_ms, shape):
        same, err = result
        r = recs.setdefault(name, dict(
            name=name, route="cuda", source=route_src, replaces=replaces,
            launches=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0, shapes=[]))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"].append(shape)
        if shape.get("timed"):
            r["ms"], r["plain_ms"] = ms, plain_ms
        print(f"  {name} {shape}: max_abs_err {err} kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms", flush=True)
        if not same:
            fail(f"{name} differs from its plain version at {shape}: "
                 f"max_abs_err {err}")

    src = "clrs_tpu_torch/csrc/kernels.cu"
    PL = "clrs_tpu/dd/pallas_linalg.py"
    # limb extraction: Schur-sized and panel-sized operands, both sides
    for nw, (B, d0, d1), timed in ((5, (2, 22, 22), False),
                                   (5, (4, 192, 64), True),
                                   (8, (2, 96, 96), False)):
        L, _ = K.limb_params(nw)
        w = _words(rng, (B, d0, d1), nw, scale_rows=True)
        for side in ("a", "b"):
            res = _compare(K.limb_extract(w, L, side),
                           K.limb_extract_plain(w, L, side))
            t = timed and side == "a"
            ms = time_ms(lambda: K.limb_extract(w, L, side)) if t else 0.0
            pms = time_ms(lambda: K.limb_extract_plain(w, L, side)) if t else 0.0
            record("limb_extract", src, f"{PL}:667 (_extract_call)", res, ms,
                   pms, dict(nw=nw, B=B, d0=d0, d1=d1, side=side, timed=t))
    # fused limb GEMM (with extraction of both operands)
    for nw, (B, m, k, n), timed in ((5, (4, 22, 22, 22), False),
                                    (5, (2, 192, 64, 192), True),
                                    (8, (2, 40, 33, 17), False)):
        L, _ = K.limb_params(nw)
        a = _words(rng, (B, m, k), nw, scale_rows=True)
        b = _words(rng, (B, k, n), nw)
        A3, ea = K.limb_extract_plain(a, L, "a")
        B3, eb = K.limb_extract_plain(b, L, "b")
        eab = (ea + eb).expand(B, m, n).contiguous()
        res = _compare(K.limb_gemm(A3, B3, eab, nw),
                       K.limb_gemm_plain(A3, B3, eab, nw))
        ms = time_ms(lambda: K.limb_gemm(A3, B3, eab, nw)) if timed else 0.0
        pms = time_ms(lambda: K.limb_gemm_plain(A3, B3, eab, nw)) if timed else 0.0
        record("limb_gemm", src, f"{PL}:552 (_limb_gemm_fused_call)", res, ms,
               pms, dict(nw=nw, B=B, m=m, k=k, n=n, timed=timed))
    # Cholesky: X|Y blocks, Schur-sized and a blocked diagonal block
    for nw, (B, n), timed in ((5, (4, 11), False), (5, (2, 64), True),
                              (5, (1, 95), False)):
        a = _spd(rng, B, n, nw)
        if B > 1 and n == 11:       # an indefinite member: ok flag false
            a = (a[0].clone(),) + a[1:]
            a[0][1, 3, 3] = -50.0
        (kl, kok) = K.chol_batched(a)
        (pl_, pok) = K.chol_plain(a)
        res = _compare(kl + (kok,), pl_ + (pok,))
        ms = time_ms(lambda: K.chol_batched(a), reps=3) if timed else 0.0
        pms = time_ms(lambda: K.chol_plain(a), reps=1) if timed else 0.0
        record("chol_batched", src, f"{PL}:153 (_chol_call)", res, ms, pms,
               dict(nw=nw, B=B, n=n, timed=timed))
    # triangular solves, both forms
    for nw, (B, n, m), timed in ((5, (4, 11, 11), False),
                                 (5, (2, 64, 64), True),
                                 (5, (1, 22, 1), False)):
        lw, _ = K.chol_plain(_spd(rng, B, n, nw))
        bw = _words(rng, (B, n, m), nw)
        for trans in (False, True):
            res = _compare(K.tri_solve_batched(lw, bw, trans),
                           K.tri_solve_plain(lw, bw, trans))
            ms = time_ms(lambda: K.tri_solve_batched(lw, bw, trans), reps=3) if timed else 0.0
            pms = time_ms(lambda: K.tri_solve_plain(lw, bw, trans), reps=1) if timed else 0.0
            record("tri_solve_batched", src,
                   f"{PL}:217 (_tril_call); {PL}:272 (_tril_t_call)", res, ms,
                   pms, dict(nw=nw, B=B, n=n, m=m, trans=trans, timed=timed))
    return recs


def delsarte_problem(n, d, costheta):
    """The Delsarte LP bound for spherical codes on the port's API
    (examples/delsarte.py:15-35)."""
    import clrs_tpu_torch as api

    obj = api.Objective(0, {}, {"M": 1})
    R, x = api.polynomial_ring("x")
    samples = api.sample_points_chebyshev(2 * d, -1, costheta)
    basis = api.basis_chebyshev(2 * d, x)
    sosbasis, samples = api.approximatefekete(basis, samples)
    gp = api.basis_gegenbauer(2 * d, n, x)
    psd1 = {("a", k): [[gp[k]]] for k in range(1, 2 * d + 1)}
    psd1[("SOS", 1)] = api.LowRankMatPol([1], [sosbasis[: d + 1]])
    psd1[("SOS", 2)] = api.LowRankMatPol([(1 + x) * (costheta - x)],
                                         [sosbasis[:d]])
    constr1 = api.Constraint(-1, psd1, {}, samples)
    psd2 = {("a", k): [[1]] for k in range(1, 2 * d + 1)}
    psd2["slack"] = [[1]]
    constr2 = api.Constraint(-1, psd2, {"M": -1})
    return api.Problem(api.Minimize(obj), [constr1, constr2])


def solve_delsarte_3_10():
    """Phase 4: the main path, counted. Returns the kernels' counts."""
    import torch

    import clrs_tpu_torch as ct
    from clrs_tpu_torch.dd import kernels as K

    problem = delsarte_problem(3, 10, Fraction(1, 2))
    iters = []
    K.reset_counts()
    status, dualsol, primalsol, t, code = ct.solvesdp(
        problem, device="cuda", omega_p=100, omega_d=100,
        dual_error_threshold=1e-12, primal_error_threshold=1e-12,
        verbose=False, callback=lambda it, info: iters.append(it))
    torch.cuda.synchronize()
    counts = K.counts()
    obj = float(ct.objvalue(problem, primalsol))
    n_it = len(iters)
    print(f"delsarte(3,10): code {code} status {status!r} objective "
          f"{obj!r} |err| {abs(obj - DELSARTE_3_10):.3e} iterations {n_it} "
          f"solve {t:.3f} s = {t / max(n_it, 1):.4f} s/iteration; "
          f"counts {counts}", flush=True)
    if code != 0 or not ct.optimal(status):
        fail(f"delsarte(3,10) ended with code {code}, status {status!r}")
    if not abs(obj - DELSARTE_3_10) < 1e-9:
        fail(f"delsarte(3,10) objective {obj!r} is not within 1e-9 of "
             f"{DELSARTE_3_10!r}")
    for f in K._COUNTED:
        if counts[f.__name__] <= 0:
            fail(f"kernel {f.__name__} was not launched by the solve")
    for f in K._PLAIN:
        if counts[f.__name__] != 0:
            fail(f"plain version {f.__name__} ran in the solve")
    return counts


def delsarte_3_95():
    """Phase 5: three iterations at Schur scale (P = 192: blocked
    Cholesky and solves, panel-scale GEMMs)."""
    import math

    import torch

    import clrs_tpu_torch as ct

    t0 = time.time()
    problem = delsarte_problem(3, 95, Fraction(1, 2))
    t_build = time.time() - t0
    rows = []
    marks = []

    def cb(it, info):
        torch.cuda.synchronize()
        marks.append(time.time())
        rows.append(info)

    status, _, _, t, code = ct.solvesdp(
        problem, device="cuda", omega_p=100, omega_d=100,
        dual_error_threshold=1e-12, primal_error_threshold=1e-12,
        maxiterations=3, verbose=False, callback=cb)
    later = [1e3 * (b - a) for a, b in zip(marks[:-1], marks[1:])]
    print(f"delsarte(3,95): host build {t_build:.1f} s; code {code}; "
          f"iterations {len(rows)}; loop {1e3 * t / max(len(rows), 1):.1f} "
          f"ms/iteration (iterations 2-3: {[round(v, 1) for v in later]} ms)"
          f"; mu {[r['mu'] for r in rows]}; alpha_d "
          f"{[r['alpha_d'] for r in rows]}; alpha_p "
          f"{[r['alpha_p'] for r in rows]}", flush=True)
    if len(rows) != 3 or code != 2:
        fail(f"delsarte(3,95) stopped after {len(rows)} iterations, code "
             f"{code}")
    for r in rows:
        if not (r["ok"] and math.isfinite(r["mu"]) and r["alpha_d"] > 0
                and r["alpha_p"] > 0):
            fail(f"delsarte(3,95) iteration failed: {r}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    try:
        from clrs_tpu_torch.dd import build
    except ImportError as e:
        fail(f"run from the repository root: {e}")
    card = card_line()
    print(card, flush=True)


    t0 = time.time()
    build.library()
    print(f"build: {time.time() - t0:.1f} s (nvcc "
          f"{build.build_seconds if build.build_seconds is not None else 'reused'})",
          flush=True)

    print("kernels vs plain versions:", flush=True)
    recs = compare_kernels()
    torch.cuda.synchronize()

    counts = solve_delsarte_3_10()
    for name, r in recs.items():
        r["launches"] = counts[name]
    delsarte_3_95()

    print(card, flush=True)
    print(json.dumps({"kernels": list(recs.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
