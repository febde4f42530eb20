"""The Delsarte LP bound for spherical codes: the port's
``clrs_tpu_torch.examples.delsarte_problem(n, d, costheta)``."""

from fractions import Fraction


def build(p: dict):
    from clrs_tpu_torch.examples import delsarte_problem
    return delsarte_problem(int(p["n"]), int(p["d"]), Fraction(p["costheta"]))
