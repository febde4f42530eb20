"""The least time the step-length eigensolver kernels' dependent steps
allow (their chain bounds), from latencies measured on the card.

Builds a latency probe with nvcc (the package's flags) under
build/eig_chains/ of this checkout, runs it, and prints JSON lines:

- ``latency``: cycles of one dependent float64 add, multiply, division and
  square root (IEEE, as the kernels compile them), one dependent shared
  memory load, and one block barrier at 512 and 1024 threads; the rates
  of one SM (512 threads of independent chains): float32/float64
  conversions (each pair around a float64 multiply) and float64
  multiplies a clock; and the SM clock (a spin of known cycles timed by
  CUDA events);
- per (B, n), each kernel's chain bound, ``chain_cycles``, in ms, for the
  most sweeps that the package's eig_pairs takes on a random symmetric
  batch.

The kernels' own times are torch_kernel_timing.py's. On a machine with a
card:

    python3 torch_eig_chains.py
    python3 torch_eig_chains.py --shape 4,11 --shape 4,96
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "eig_chains"

PROBE = r"""
#include <cuda_runtime.h>
__global__ void probe(double* out, long long* cyc, double x0, int reps) {
  __shared__ int chase[1024];
  const int tid = threadIdx.x;
  chase[tid] = (tid * 7 + 1) % blockDim.x;
  __syncthreads();
  if (tid == 0) {
    double x = x0;
    long long t = clock64();
    for (int i = 0; i < reps; ++i) x = x + 1.0000001;
    cyc[0] = clock64() - t;
    t = clock64();
    for (int i = 0; i < reps; ++i) x = x * 1.0000001;
    cyc[1] = clock64() - t;
    t = clock64();
    for (int i = 0; i < reps; ++i) x = (x + 1.0) / x;
    cyc[2] = clock64() - t;
    t = clock64();
    for (int i = 0; i < reps; ++i) x = sqrt(x + 2.0);
    cyc[3] = clock64() - t;
    int j = 0;
    t = clock64();
    for (int i = 0; i < reps; ++i) j = chase[j];
    cyc[4] = clock64() - t;
    out[0] = x + j;
  }
  __syncthreads();
  const long long t = clock64();
  for (int i = 0; i < reps; ++i) __syncthreads();
  if (tid == 0) cyc[5] = clock64() - t;
}
// Throughput on one SM: each of 512 threads runs 8 independent chains of
// float -> double -> float conversions (kind 0) or double multiplies (1).
__global__ void rate(float* out, long long* cyc, int kind, int reps) {
  float f[8];
  double d[8];
  for (int c = 0; c < 8; ++c) {
    f[c] = 1.0f + threadIdx.x * 1e-3f + c;
    d[c] = f[c];
  }
  __syncthreads();
  const long long t = clock64();
  for (int i = 0; i < reps; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (kind == 0) f[c] = static_cast<float>(static_cast<double>(f[c]) * 1.0000001);
      else d[c] = d[c] * 1.0000001;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) cyc[0] = clock64() - t;
  float acc = 0.0f;
  for (int c = 0; c < 8; ++c) acc += f[c] + static_cast<float>(d[c]);
  out[threadIdx.x] = acc;
}
extern "C" int run_probe(double* out, long long* cyc, int threads, int reps) {
  probe<<<1, threads>>>(out, cyc, 0.5, reps);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int run_rate(float* out, long long* cyc, int kind, int reps) {
  rate<<<1, 512>>>(out, cyc, kind, reps);
  return static_cast<int>(cudaGetLastError());
}
"""


MULTISECTION_ROUNDS = 6   # eig_lowest's rounds from a Gershgorin width to 2^-52 |T|


def chain_cycles(lat, rate, n, sweeps):
    """The least cycles the dependent steps of each kernel allow a
    member, from the measured latencies (a lane tree's shuffle taken as a
    shared load), for n and the member's most sweeps: the sweep
    kernel a round (barrier, table and block loads, the block's two
    multiply-add levels, the diagonals' load, then the rotation's three
    divisions, two square roots, four adds and three multiplies) and an
    off-norm sum a sweep; the replay a round (a load, a multiply, an add);
    eig_lowest a column (two barriers, the product's and kk's lane trees,
    row 0's update, the next reflector's sum, square root and division)
    and MULTISECTION_ROUNDS rounds of n dependent divisions. Besides, the
    sweep kernel's floor from one SM's pipes: a round's P (P + 1) / 2
    blocks of 8 conversions and 24 float64 operations at the measured
    rates."""
    add, mul = lat["f64_add"], lat["f64_mul"]
    div, sq = lat["f64_div"], lat["f64_sqrt"]
    ld, bar = lat["shared_load"], lat["barrier_512"]
    tree = 5 * (ld + add)
    N = n + (n & 1)
    P = N // 2
    rounds = sweeps * (N - 1)
    rotation = 3 * div + 2 * sq + 4 * add + 3 * mul
    per_round = bar + 3 * ld + 2 * (mul + add) + rotation
    block_sum = 5 * (bar + ld + add) + tree
    lowest = MULTISECTION_ROUNDS * n * (div + 2 * add)
    for k in range(n - 1):
        m = n - 1 - k
        product = ld + -(-m // 32) * add + mul + tree + mul
        kk = 2 * ld + tree + mul
        row0 = ld + 2 * (mul + add) + add
        reflector = (2 * ld + -(-(m - 1) // 32) * (mul + add) + tree + mul
                     + add + sq + add + div)
        lowest += 2 * bar + product + kk + row0 + reflector
    blocks = P * (P + 1) // 2
    return {"eig_pairs": rounds * per_round + (sweeps + 1) * block_sum,
            "eig_pairs_vec": rounds * (ld + mul + add),
            "eig_lowest": lowest,
            "eig_pairs_one_sm_pipes": rounds * blocks * (
                8 / rate["f32_f64_f32_conversions"]
                + 24 / rate["f64_multiplies"])}


def nvcc(src, so, include):
    from clrs_tpu_torch.dd import build as Bd

    r = subprocess.run([Bd._nvcc()] + Bd.NVCC_FLAGS + [
        "-shared", "-I", str(include), "-o", str(so), str(src)],
        capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"nvcc {src.name}: {r.stderr[-2000:]}")
    return ctypes.CDLL(str(so))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", action="append", default=[],
                    help="B,n (default 4,96 and 4,128)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as S
    from clrs_tpu_torch.dd import kernels as K

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = S.card_line()
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "probe.cu").write_text(PROBE)
    probe = nvcc(OUT / "probe.cu", OUT / "probe.so",
                 ROOT / "clrs_tpu_torch" / "csrc")
    vp, i = ctypes.c_void_p, ctypes.c_int

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    probe.run_probe.argtypes = [vp, vp, i, i]
    lat = {}
    reps = 256
    for threads in (512, 1024):
        out = torch.zeros(1, dtype=torch.float64, device="cuda")
        cyc = torch.zeros(8, dtype=torch.int64, device="cuda")
        for _ in range(2):
            probe.run_probe(ptr(out), ptr(cyc), threads, reps)
        torch.cuda.synchronize()
        c = [v / reps for v in cyc.tolist()]
        lat.update({"f64_add": c[0], "f64_mul": c[1], "f64_div": c[2] - c[0],
                    "f64_sqrt": c[3] - c[0], "shared_load": c[4],
                    f"barrier_{threads}": c[5]})
    probe.run_rate.argtypes = [vp, vp, i, i]
    per_clock = {}
    for kind, name in ((0, "f32_f64_f32_conversions"), (1, "f64_multiplies")):
        out = torch.zeros(512, dtype=torch.float32, device="cuda")
        cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
        for _ in range(2):
            probe.run_rate(ptr(out), ptr(cyc), kind, reps)
        torch.cuda.synchronize()
        # a conversion pair: two conversions around a float64 multiply
        ops = 512 * 8 * reps * (2 if kind == 0 else 1)
        per_clock[name] = ops / cyc.item()
    # the SM clock under a spin of known cycles
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(1e7))
    t0.record()
    torch.cuda._sleep(int(4e8))
    t1.record()
    torch.cuda.synchronize()
    ghz = 4e8 / (t0.elapsed_time(t1) * 1e6)
    print(json.dumps({"card": card, "latency_cycles": lat,
                      "per_sm_clock": per_clock, "sm_clock_ghz": ghz}),
          flush=True)

    shapes = [tuple(int(v) for v in x.split(",")) for x in args.shape] or [
        (4, 96), (4, 128)]
    rng = np.random.default_rng(16)
    for B, n in shapes:
        a = rng.standard_normal((B, n, n))
        A = torch.tensor(a + np.swapaxes(a, 1, 2), dtype=torch.float32,
                         device="cuda")
        _, log = K.eig_pairs_sweeps(A)
        sweeps = int(log[:, K.eig_pairs_log_layout(n)[2]].max())
        chain = {k: c / (ghz * 1e6)
                 for k, c in chain_cycles(lat, per_clock, n, sweeps).items()}
        print(json.dumps({"card": card, "B": B, "n": n, "sweeps": sweeps,
                          "chain_ms": chain}), flush=True)


if __name__ == "__main__":
    main()
