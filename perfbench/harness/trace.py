"""The traced spans of a ``--trace 1`` run: whole solves after the window
under ``torch.profiler``, reduced to device kernels, busy time, idle gaps
and what the host was doing in them.

Not the whole window: the profiler loses device records in a process
after hundreds of thousands of them (``torch_step_profile.py``), and a
solve at delsarte(3,10) launches about 20 thousand kernels. The harness's
own spans (``bench.solve``, ``bench.replay``, ``bench.host_read``) name
what the host was doing when the device idled.
"""

from __future__ import annotations

import bisect
import time

from .stats import union_seconds

_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


def is_port_kernel(name: str) -> bool:
    """The port's own kernels: each source of ``clrs_tpu_torch/csrc``
    keeps them in a top-level anonymous namespace, PyTorch's lie under
    ``at::`` (``torch_step_profile.py``'s rule, copied)."""
    head, sep, _ = name.partition("(anonymous namespace)::")
    return bool(sep) and head in ("", "void ")


def _solves(instances, order, n_solves):
    """Run ``n_solves`` whole solves (instances taken in ``order``) and
    synchronise: (iterations, seconds)."""
    import torch
    from torch.profiler import record_function

    iterations = 0
    t0 = time.perf_counter()
    for k in range(n_solves):
        with record_function("bench.solve"):
            it, _, _ = instances[order[k % len(order)]].solve()
        iterations += it
    torch.cuda.synchronize()
    return iterations, time.perf_counter() - t0


def profile(instances, order, n_solves):
    """Two profiled spans after the window. The first, ``n_solves`` whole
    solves with the device's activity alone (the host's operations not
    recorded, so they run at their own pace), gives the kernels, the busy
    time and the span. The second, one solve with the host's operations
    recorded too, names what the host was doing in the device's idle gaps
    (its own pace slowed by the recording). Returns the reduced record
    (:func:`reduce`) with the second span's ``idle_gaps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        iterations, span_s = _solves(instances, order, n_solves)
    out = reduce(prof.events(), iterations, span_s, n_solves)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        it2, span2 = _solves(instances, order, 1)
    host = reduce(prof.events(), it2, span2, 1)
    out["idle_gaps"] = host["idle_gaps"]
    out["host_recorded"] = {k: host[k] for k in
                            ("iterations", "span_s", "busy_s", "kernels")}
    return out


def reduce(events, iterations, span_s, n_solves):
    """Device operations, busy seconds, kernels by name and the idle gaps
    by host activity, from profiler events (objects with ``name``,
    ``device_type`` and ``time_range`` in microseconds)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == cuda:
            # the harness's spans are mirrored on the device's timeline as
            # annotations: not device work
            if not e.name.startswith("bench."):
                dev.append((tr.start, tr.end, e.name))
        else:
            host.append((tr.start, tr.end, e.name))
    kernels = [d for d in dev if not d[2].startswith(_NOT_KERNELS)]
    by_name = {}
    for a, b, name in dev:
        c, t = by_name.get(name, (0, 0.0))
        by_name[name] = (c + 1, t + (b - a) / 1e6)
    port_s = sum(t for n, (_, t) in by_name.items() if is_port_kernel(n))
    kern_s = sum((b - a) / 1e6 for a, b, _ in kernels)
    return {
        "iterations": iterations, "solves": n_solves, "span_s": span_s,
        "kernels": len(kernels),
        "port_kernel_s": port_s, "torch_kernel_s": kern_s - port_s,
        "busy_s": union_seconds([(a, b) for a, b, _ in dev]),
        "device_ops": sorted(([n, t] for n, (_, t) in by_name.items()),
                             key=lambda v: -v[1])[:10],
        "idle_gaps": idle_gaps(dev, host)[:10],
    }


def idle_gaps(dev, host):
    """Seconds of device idleness between device operations, summed by
    what the host was doing at each gap's midpoint: the innermost of the
    harness's spans with the innermost host operation inside it."""
    spans = sorted(h for h in host if h[2].startswith("bench."))
    ops = sorted(h for h in host if not h[2].startswith("bench."))
    merged = []
    for a, b, _ in sorted(dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    span_starts = [h[0] for h in spans]
    op_starts = [h[0] for h in ops]
    out = {}
    for (_, end), (start, _) in zip(merged, merged[1:]):
        mid = (end + start) / 2
        label = (_innermost(spans, mid, span_starts)
                 or "outside the harness's spans")
        op = _innermost(ops, mid, op_starts)
        if op:
            label = f"{label} > {op}"
        out[label] = out.get(label, 0.0) + (start - end) / 1e6
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])


def _innermost(events, t, starts, back=256):
    """The event with the latest start at or before ``t`` that still runs
    at ``t`` (for nested events, the innermost), among the ``back``
    events that start last before ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for a, b, name in reversed(events[max(0, i - back + 1):i + 1]):
        if b >= t:
            return name
    return None
