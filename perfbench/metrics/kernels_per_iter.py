"""Device kernels per IPM iteration in the traced solves (torch.profiler;
copies and fills left out)."""


def read(run):
    p = run.profile
    if not p or not p["iterations"] or not p["kernels"]:
        return None
    return p["kernels"] / p["iterations"]
