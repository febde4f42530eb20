"""Device milliseconds per IPM iteration of the kernels that are not the
port's (PyTorch's own), in the traced solves."""


def read(run):
    p = run.profile
    if not p or not p["iterations"] or not p["kernels"]:
        return None
    return 1e3 * p["torch_kernel_s"] / p["iterations"]
