"""Device milliseconds per IPM iteration of the port's own CUDA kernels
(csrc/*.cu), in the traced solves."""


def read(run):
    p = run.profile
    if not p or not p["iterations"] or not p["port_kernel_s"]:
        return None
    return 1e3 * p["port_kernel_s"] / p["iterations"]
