"""The three-point bound for spherical codes: the port's
``clrs_tpu_torch.examples.three_point_problem(n, costheta, d2, d3)``."""

from fractions import Fraction


def build(p: dict):
    from clrs_tpu_torch.examples import three_point_problem
    return three_point_problem(int(p["n"]), Fraction(p["costheta"]),
                               int(p["d2"]), int(p["d3"]))
