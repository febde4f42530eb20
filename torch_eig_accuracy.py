"""How tight the certified step-length bound is on the card, by eigensolver.

Runs three eager iterations of delsarte(3, 95) with the certified route
(clrs_tpu_torch.solver.step._STEPLEN_VERIFIED = True), records the W2 words
of every step-length class on their way to the certification, and for each
batch certifies f32 candidate eigenpairs from

  - the eig_pairs kernel on the card (the route's own pairs: Jacobi,
    csrc/eig.cu),
  - torch.linalg.eigh on the card (cuSOLVER, the route's pairs before the
    kernel),
  - torch.linalg.eigh on the host (LAPACK),
  - float64 torch.linalg.eigh on the card, rounded to f32,

each on the leading n x n blocks for n in --n (the pairs' accuracy depends
on the size), with the route's own certification
(clrs_tpu_torch.solver.step._eig_lo_certified, on the card). Prints one
JSON line per eigensolver and size: the largest delta = ||V^T V - I||_F and
eta = ||A - V diag(lam) V^T||_F, the band (lambda_min - bound) / (1 +
|lambda_min|) against float64 eigvalsh, and ms per call (CUDA events).
Imports chip_smoke.py from beside it. On a machine with a card:

    python3 torch_eig_accuracy.py --n 33,64,96
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from fractions import Fraction
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", default="33,64,96")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent))

    import torch

    import chip_smoke as S
    from clrs_tpu_torch.dd import kernels as K
    from clrs_tpu_torch.examples import delsarte_problem
    from clrs_tpu_torch.solver import step as TS

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    ds = S.device_sdp(delsarte_problem(3, 95, Fraction(1, 2)))
    batches, inner = [], TS._eig_lo_certified

    def recording(W2, lam, V):
        batches.append(tuple(w.clone() for w in W2))
        return inner(W2, lam, V)

    TS._STEPLEN_VERIFIED, TS._eig_lo_certified = True, recording
    try:
        S.drive(ds, "eager", 2)
    finally:
        TS._STEPLEN_VERIFIED, TS._eig_lo_certified = None, inner

    def host(A):
        lam, V = torch.linalg.eigh(A.cpu())
        return lam.cuda(), V.cuda()

    def rounded(A):
        lam, V = torch.linalg.eigh(A.double())
        return lam.float(), V.float()

    solvers = {"card eig_pairs kernel": K.eig_pairs,
               "card f32 eigh (cuSOLVER)": lambda A: torch.linalg.eigh(A),
               "host f32 eigh (LAPACK)": host,
               "card f64 eigh, rounded to f32": rounded}
    for n in (int(v) for v in args.n.split(",")):
        for name, eig in solvers.items():
            worst = dict(delta=0.0, eta=0.0, band=0.0, ms=0.0)
            for W2 in batches:
                if W2[0].shape[-1] < n:
                    continue
                W2 = tuple(w[:, :n, :n].contiguous() for w in W2)
                A, _ = TS._eig_input_f32(W2)
                lam, V = eig(A)
                lo = TS._eig_lo_certified(W2, lam, V)
                ref = torch.linalg.eigvalsh(TS._eig_input(W2)[0])[:, 0]
                V64, lam64 = V.double(), lam.double()
                G = V64.transpose(1, 2) @ V64 - torch.eye(n, device=V.device,
                                                          dtype=V64.dtype)
                E = TS._eig_input(W2)[0] - (V64 * lam64[:, None]) @ \
                    V64.transpose(1, 2)
                worst["delta"] = max(worst["delta"],
                                     G.square().sum((1, 2)).sqrt().max().item())
                worst["eta"] = max(worst["eta"],
                                   E.square().sum((1, 2)).sqrt().max().item())
                worst["band"] = max(worst["band"], ((ref - lo) / (
                    1 + ref.abs())).max().item())
                worst["ms"] = max(worst["ms"], S.time_ms(lambda: eig(A), 5))
            print(json.dumps(dict(card=card, eigensolver=name, n=n,
                                  batches=len(batches), **worst)),
                  flush=True)


if __name__ == "__main__":
    main()
