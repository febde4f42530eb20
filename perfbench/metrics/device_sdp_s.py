"""Seconds building the device-resident problem, ``DeviceSDP``, summed
over the instances (the program's ``compile.device_sdp`` spans), less the
nvcc build of the kernel library where a checkout's first run does it
inside them (the ``kernels.build`` span)."""

from perfbench.harness.spans import replayed, span


def read(run):
    b = replayed()
    if b is None or not span(b, "compile.device_sdp", "count"):
        return None
    ns = span(b, "compile.device_sdp")
    if (b["spans"].get("kernels.build") or {}).get("parent") \
            == "compile.device_sdp":
        ns -= span(b, "kernels.build")
    return 1e-9 * ns
