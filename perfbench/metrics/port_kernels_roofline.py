"""The least time one iteration's work could take on the card (the larger
of its operations over the published peaks and its bytes over 3.35 TB/s,
counted from the cell's shapes: perfbench/harness/roofline.py) over the
port's kernels' device time per iteration, in percent. Nothing where the
port's kernels did not run."""


def read(run):
    p = run.profile
    if not p or not p["iterations"] or not p["port_kernel_s"] \
            or run.least_ms_per_iter is None:
        return None
    port_ms = 1e3 * p["port_kernel_s"] / p["iterations"]
    return 100.0 * run.least_ms_per_iter[0] / port_ms
