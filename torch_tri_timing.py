"""Time the triangular-solve kernel at the shapes one IPM iteration gives it.

Runs ``--iters`` iterations of delsarte(3, d) on the card with the
solves of ``clrs_tpu_torch.dd.linalg`` (every caller of the kernel)
recording each call's (nw, B, n, m, trans) on their way to
``kernels.tri_solve_batched``, then times the kernel at every recorded shape
on random inputs of that shape (an SPD matrix's factor from the plain
Cholesky, standard normal right-hand sides) with chip_smoke.py's
``time_ms`` (CUDA events around calls queued behind a spin kernel). Prints
one JSON line: per shape the calls per iteration, ms per call and ms per
iteration, and the sum per form. The package and chip_smoke.py are
imported from beside the script, so a copy of it in another checkout
times that checkout's kernel. On a machine with a card:

    python3 torch_tri_timing.py --d 10 --iters 2
    python3 torch_tri_timing.py --d 95 --iters 1
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from fractions import Fraction
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent))

    import numpy as np
    import torch

    import chip_smoke as S
    import clrs_tpu_torch as ct
    from clrs_tpu_torch.dd import kernels as K
    from clrs_tpu_torch.dd import linalg as dl
    from clrs_tpu_torch.examples import delsarte_problem

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    seen = collections.Counter()

    class Recording:
        """The kernels module as dd/linalg.py sees it, with the solve's
        shapes recorded on their way to the wrapper."""

        def __getattr__(self, name):
            return getattr(K, name)

        def tri_solve_batched(self, l, b, trans=False):
            seen[(len(l),) + tuple(l[0].shape[:2]) + (b[0].shape[2],
                                                      bool(trans))] += 1
            return K.tri_solve_batched(l, b, trans)

    dl.K = Recording()
    try:
        ct.solvesdp(delsarte_problem(3, args.d, Fraction(1, 2)),
                    device="cuda", omega_p=100, omega_d=100,
                    dual_error_threshold=1e-12, primal_error_threshold=1e-12,
                    maxiterations=args.iters, verbose=False)
    finally:
        dl.K = K
    rng = np.random.default_rng(0)
    rows, per_form = [], collections.Counter()
    for (nw, B, n, m, trans), calls in sorted(seen.items()):
        lw, _ = K.chol_plain(S._spd(rng, B, n, nw))
        bw = S._words(rng, (B, n, m), nw)
        ms = S.time_ms(lambda: K.tri_solve_batched(lw, bw, trans), args.reps)
        per_it = calls / args.iters
        rows.append(dict(nw=nw, B=B, n=n, m=m, trans=trans,
                         calls_per_iteration=per_it, ms=ms,
                         ms_per_iteration=per_it * ms))
        per_form[trans] += per_it * ms
    print(json.dumps({
        "card": card, "checkout": str(Path(__file__).resolve().parent),
        "problem": f"delsarte(3,{args.d})", "iters": args.iters,
        "shapes": rows,
        "ms_per_iteration_by_form": {("transposed" if t else "forward"): v
                                     for t, v in sorted(per_form.items())},
    }), flush=True)


if __name__ == "__main__":
    main()
