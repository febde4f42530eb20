"""Benchmark of clrs_tpu_torch on one NVIDIA card: whole solves of a cell's
instances back to back, timed on the host's clock, each answer judged by
the plain reference in ``perfbench/reference/``.

Run from the root of a checkout (which holds ``BENCHMARK.json``, this
folder and the ``clrs_tpu_torch`` package) on a machine with a card:

    python3 perfbench/run.py --workload delsarte-3.d10 --seed 7 \\
        --seconds 10 --trace 0

Set-up (``setup_s``, from the start of this process): the port's builder,
``ClusteredLowRankSDP``, ``remove_empty_blocks`` and ``preprocess_sdp``,
``DeviceSDP``, ``make_run_chunk``, the start and its first info, and one
warm solve of each instance, which captures the step's CUDA graph; the
kernels come from ``build/kernels/`` inside the checkout, built there by
the first run. The window then runs whole solves until ``--seconds`` have
passed, ending at the end of the last. ``--trace 1`` profiles a few more
solves afterwards and prints the per-layer metrics instead.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the reference compared
beside its limit); the last lines of standard error repeat the checks.
Without a card, or with fewer cards than the cell asks for, it prints no
result and exits 2; if JAX or the JAX package was loaded, it exits 3.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded when the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "clrs_tpu")


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench.harness import manifest
    cell = manifest.cell(ROOT, manifest.load_bench(ROOT), args.workload)

    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2

    from perfbench.harness.cell import run_cell
    result, notes = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), "cuda", _T0)
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded in this process: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for line in notes:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
