"""The metric arithmetic on synthetic solve records and traces: rates over
the whole window, the tail over all solves, the idle share, the roofline.
CPU only, no card."""

import statistics
from types import SimpleNamespace

import pytest
import torch

from perfbench.harness import manifest, roofline, trace
from perfbench.harness.cell import Run, Solve
from perfbench.harness.stats import p95, per, union_seconds


def read(name, run):
    return manifest.metric_reader(name).read(run)


def make_run(seconds, iterations, window_s, profile=None, least=None):
    solves = [Solve(i % 3, s, it, 0, True)
              for i, (s, it) in enumerate(zip(seconds, iterations))]
    return Run(setup_s=12.5, window_s=window_s, solves=solves,
               host_build_s=[1.0, 2.0], capture_s=[0.1, 0.2],
               profile=profile, least_ms_per_iter=least)


def test_rates_are_over_the_whole_window():
    # the window holds time outside the solves (keeping answers): rates
    # divide the window, not the solves' own sum
    run = make_run([0.06, 0.07, 0.08], [25, 28, 31], window_s=0.3)
    assert read("solve_ms", run) == pytest.approx(100.0)
    assert read("iter_ms", run) == pytest.approx(300.0 / 84)
    assert read("iters_per_solve", run) == pytest.approx(28.0)
    assert read("setup_s", run) == 12.5
    assert read("host_build_s", run) == pytest.approx(3.0)
    assert read("capture_s", run) == pytest.approx(0.3)


def test_p95_is_over_all_solves():
    secs = [i / 1000 for i in range(1, 201)]
    run = make_run(secs, [1] * 200, window_s=sum(secs))
    want = statistics.quantiles([1e3 * s for s in secs], n=20,
                                method="inclusive")[18]
    assert read("solve_ms_p95", run) == pytest.approx(want)
    assert want == pytest.approx(190.05)
    assert p95([]) is None and p95([3.0]) == 3.0


def test_nothing_to_read_gives_nothing():
    run = make_run([], [], window_s=1.0)
    for name in ("solve_ms", "iter_ms", "iters_per_solve", "solve_ms_p95",
                 "kernels_per_iter", "torch_kernel_ms_per_iter",
                 "port_kernel_ms_per_iter", "port_kernels_roofline",
                 "device_idle_share"):
        assert read(name, run) is None, name
    run.capture_s = [None]
    assert read("capture_s", run) is None
    assert per(1.0, 0) is None


def _ev(name, start, end, cuda):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=(torch.autograd.DeviceType.CUDA if cuda
                     else torch.autograd.DeviceType.CPU))


PORT = "void (anonymous namespace)::chol_batched<5>(float const*)"
TORCH = "void at::native::vectorized_elementwise_kernel<4>(int)"


def synthetic_events():
    # 1 s window; device busy 0-300 and 400-700 us of each 1000 us, the
    # host reading info in the first gap and replaying in the second
    ev = []
    for k in range(4):
        o = 1000 * k
        ev += [_ev(PORT, o, o + 200, True), _ev(TORCH, o + 200, o + 300, True),
               _ev("Memcpy DtoH (Device -> Pinned)", o + 400, o + 450, True),
               _ev(PORT, o + 450, o + 700, True),
               _ev("bench.solve", o, o + 1000, False),
               _ev("bench.host_read", o + 290, o + 420, False),
               _ev("cudaStreamSynchronize", o + 300, o + 400, False),
               _ev("bench.replay", o + 690, o + 1000, False)]
    return ev


def test_trace_reduction_and_idle_attribution():
    r = trace.reduce(synthetic_events(), iterations=4, span_s=0.004,
                     n_solves=1)
    assert r["kernels"] == 12                      # copies left out
    assert r["port_kernel_s"] == pytest.approx(4 * 450e-6)
    assert r["torch_kernel_s"] == pytest.approx(4 * 100e-6)
    assert r["busy_s"] == pytest.approx(4 * 600e-6)
    gaps = dict((k, v) for k, v in r["idle_gaps"])
    assert gaps["bench.host_read > cudaStreamSynchronize"] == \
        pytest.approx(4 * 100e-6)
    assert gaps["bench.replay"] == pytest.approx(3 * 300e-6)
    assert r["device_ops"][0][0] == PORT
    # the window's own wall per iteration (1.2 ms) is the divisor, not
    # the traced span's
    run = make_run([0.004], [4], window_s=0.0048, profile=r,
                   least=(0.0045, "operations"))
    assert read("device_idle_share", run) == pytest.approx(50.0)
    assert read("kernels_per_iter", run) == pytest.approx(3.0)
    assert read("port_kernel_ms_per_iter", run) == pytest.approx(0.45)
    assert read("torch_kernel_ms_per_iter", run) == pytest.approx(0.1)
    assert read("port_kernels_roofline", run) == pytest.approx(1.0)


def test_port_kernel_names():
    assert trace.is_port_kernel(PORT)
    assert trace.is_port_kernel("(anonymous namespace)::eig_lowest(int)")
    assert not trace.is_port_kernel(TORCH)
    assert not trace.is_port_kernel(
        "void at::(anonymous namespace)::foo(int)")


def test_union_of_intervals():
    assert union_seconds([(0, 10), (5, 20), (30, 40)]) == pytest.approx(3e-5)
    assert union_seconds([(0, 10), (2, 3)]) == pytest.approx(1e-5)


@pytest.mark.parametrize("shape,nw", [
    ({"clusters": [{"P": 22, "blocks": [[11, 1], [10, 1]] + [[1, 1]] * 21}]},
     5),
    ({"clusters": [{"P": 128, "blocks": [[64, 1], [63, 1]]}]}, 8)])
def test_roofline_least_time(shape, nw):
    ms, by = roofline.least_ms(shape, nw)
    nbytes, ops = roofline.iteration_work(shape, nw)
    assert ms > 0 and by in ("bytes", "operations")
    assert ms == pytest.approx(1e3 * max(
        [nbytes / roofline.HBM_BYTES_PER_S]
        + [v / roofline.PEAK_OPS_PER_S[k] for k, v in ops.items()]))
    # the scalar packs add nothing
    small = {"clusters": [{"P": shape["clusters"][0]["P"],
                           "blocks": shape["clusters"][0]["blocks"][:2]}]}
    assert roofline.least_ms(small, nw)[0] == pytest.approx(ms)
