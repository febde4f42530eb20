"""The rounding stack gives the caller's Decimal context back (ROADMAP C3):
``find_field``'s root refinement raises the process's precision to 70
digits, and a host compile after it would build another problem. The port's
public rounding entries (``find_field``, ``to_field``, ``exact_solution``)
run inside a local context; the JAX package's copy does not
(tests/test_torch_copies.py records the difference). No JAX runs. Each
test starts from the context a caller of the port has, HOST_DIGITS (which
utils/hp.py sets at import): a test process may hold another, since the
JAX package's rounding, run by an earlier test in it, leaves 70 digits."""

import decimal
import pickle
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import clrs_tpu_torch as ct
from clrs_tpu_torch.examples import delsarte_problem
from clrs_tpu_torch.round import find_field as ff
from clrs_tpu_torch.utils.hp import HOST_DIGITS, DDScalar

ROOT = Path(__file__).resolve().parent.parent

# the compiled delsarte(3,10,1/2), pickled, from a process that rounds
# nothing
COMPILE = ("import pickle, sys\n"
           "from fractions import Fraction\n"
           "import clrs_tpu_torch as ct\n"
           "from clrs_tpu_torch.examples import delsarte_problem\n"
           "sys.stdout.buffer.write(pickle.dumps(ct.ClusteredLowRankSDP("
           "delsarte_problem(3, 10, Fraction(1, 2)))))\n")


def _golden_field(monkeypatch):
    """find_field on a solution whose one kernel value is the golden ratio:
    the value selection is stubbed (a solve would take minutes here); the
    minimal polynomial, the field and the root refinement run as they
    are."""
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        phi = (1 + decimal.Decimal(5).sqrt()) / 2
        hi = float(phi)
        lo = float(phi - decimal.Decimal(hi))
    monkeypatch.setattr(ff, "_select_vals",
                        lambda *a, **k: [(DDScalar(hi, lo), 2)])
    return ct.find_field(None, None)


def test_rounding_entries_keep_the_callers_precision(monkeypatch):
    with decimal.localcontext() as ctx:
        ctx.prec = HOST_DIGITS
        N, g = _golden_field(monkeypatch)
        assert N.degree == 2 and isinstance(g, decimal.Decimal)
        assert len(str(g).split(".")[1]) > HOST_DIGITS   # refined at 70
        assert decimal.getcontext().prec == HOST_DIGITS
        x = ct.to_field(DDScalar(float(g) - 1.0), N, g)
        assert x == N.gen() - 1
        assert decimal.getcontext().prec == HOST_DIGITS


def test_compile_after_rounding_equals_a_fresh_process(monkeypatch):
    with decimal.localcontext() as ctx:
        ctx.prec = HOST_DIGITS
        _golden_field(monkeypatch)
        here = pickle.dumps(ct.ClusteredLowRankSDP(
            delsarte_problem(3, 10, Fraction(1, 2))))
    fresh = subprocess.run([sys.executable, "-c", COMPILE], cwd=ROOT,
                           capture_output=True, check=True).stdout
    assert here == fresh
