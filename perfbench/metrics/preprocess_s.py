"""Seconds in the compile layer's ``preprocess_sdp``, summed over the
instances (the program's ``compile.preprocess`` spans)."""

from perfbench.harness.spans import replayed, span


def read(run):
    b = replayed()
    if b is None or not span(b, "compile.preprocess", "count"):
        return None
    return 1e-9 * span(b, "compile.preprocess")
