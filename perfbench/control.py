"""The control of a cell's correctness check: the plain reference's own
float64 interior-point solver (``perfbench/reference/ipm64.py``) put in
the port's place, on each of the cell's instances at the cell's own size,
its answers judged by the same checks and limits as the port's. Every
instance has to come out not correct; each reading prints beside its limit
as one JSON line per instance, then the least reading of each number.

    python3 perfbench/control.py --workload delsarte-3.d10

It runs on the host's CPU (NumPy) and imports nothing of the port; the
benchmark's own runs do not run it.
"""

import argparse
import json
import sys
import time
from fractions import Fraction
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seed=0):
    """[(instance parameters, {number: reading})] of the control on each
    of ``cell``'s instances."""
    from perfbench.harness import manifest
    from perfbench.harness.cell import instance_params
    from perfbench.reference import ipm64

    ref = manifest.reference(cell.config["family"])
    s = cell.config["solve"]
    out = []
    for p in instance_params(cell.config, cell.traffic, seed):
        p = {k: Fraction(v) if isinstance(v, str) else v
             for k, v in p.items()}
        ans = ipm64.solve(ref.dense(p), s["omega_p"], s["omega_d"],
                          gap_threshold=s["duality_gap_threshold"],
                          error_threshold=min(s["dual_error_threshold"],
                                              s["primal_error_threshold"]))
        out.append((p, ref.check(p, ans)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    args = ap.parse_args(argv)
    from perfbench.harness import manifest
    cell = manifest.cell(ROOT, manifest.load_bench(ROOT), args.workload)
    limits = cell.traffic["limits"]
    t0 = time.perf_counter()
    rows = readings(cell)
    failed_all = True
    for p, r in rows:
        fails = sorted(k for k in limits if r[k] > limits[k])
        failed_all &= bool(fails)
        print(json.dumps({"instance": {k: str(v) for k, v in p.items()},
                          "readings": r, "fails": fails}))
    least = {k: min(r[k] for _, r in rows) for k in limits}
    print(json.dumps({"workload": args.workload, "least": least,
                      "limits": limits, "every_instance_fails": failed_all,
                      "seconds": time.perf_counter() - t0}))
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
