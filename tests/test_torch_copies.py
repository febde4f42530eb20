"""The port's copies of the JAX package's host modules equal their sources
byte for byte, but for each module's recorded differences: a change to a
module of clrs_tpu/ that has a copy fails here until it is carried to the
copy (or recorded as a new difference). No JAX runs; the files are read
as text."""

import difflib
import hashlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

# the copies that differ: module -> the diff's '-' (source) and '+' (copy)
# lines in order
DIFFERENCES = {
    # nextprime without sympy (exact/primes.py)
    "exact/modp.py": ["-from sympy import nextprime",
                      "+from .primes import nextprime"],
    "exact/dixon.py": ["-from sympy import nextprime",
                       "+from .primes import nextprime"],
    # the library is built under build/native/ at the repository root,
    # never into the source tree, and renamed into place
    "native/__init__.py": [
        '+_OUT = os.path.join(os.path.dirname(os.path.dirname(_DIR)), '
        '"build", "native")',
        "+    # several processes may build at once: each writes its own "
        "file and",
        "+    # renames it into place, so none loads another's half-written "
        "library",
        '+    tmp = f"{out}.{os.getpid()}.tmp"',
        "+        os.makedirs(_OUT, exist_ok=True)",
        '-            ["g++", "-O3", "-shared", "-fPIC", src, "-o", out],',
        '+            ["g++", "-O3", "-shared", "-fPIC", src, "-o", tmp],',
        "+        if r.returncode == 0 and os.path.exists(tmp):",
        "+            os.replace(tmp, out)",
        '-        so = os.path.join(_DIR, "librref_modp.so")',
        '+        so = os.path.join(_OUT, "librref_modp.so")'],
    # Model.solve binds the port's solvesdp, on the card by default
    "frontend/model.py": [
        "-of the framework consumes (so clustering, preprocessing, the TPU "
        "solver and",
        "-the exact rounding pipeline all apply unchanged).",
        "+of the framework consumes (so clustering, preprocessing, the solver "
        "on the card",
        "+and the exact rounding pipeline all apply unchanged).",
        "+from ..device import DEFAULT_DEVICE",
        "-    def solve(self, **kwargs):",
        "+    def solve(self, device=DEFAULT_DEVICE, **kwargs):",
        '+        """Build the problem and solve it with the port\'s '
        '``solvesdp`` on',
        '+        ``device`` (the card by default; ``"cpu"`` runs the kernels\' '
        'plain',
        '+        versions)."""',
        "-         t, self.errorcode) = solvesdp(problem, **kwargs)",
        "+         t, self.errorcode) = solvesdp(problem, device=device, "
        "**kwargs)"],
    # the public rounding entries give the caller's Decimal context back
    # (find_field.py::_refine_root raises the precision; ROADMAP C3): the
    # JAX copy leaves it raised for every later host compile
    "round/rounding.py": [
        "+import functools",
        "+from decimal import localcontext",
        "+def keeps_decimal_context(fn):",
        '+    """Run ``fn`` in a copy of the caller\'s Decimal context, so '
        'that the',
        "+    precision the rounding sets (find_field.py::_refine_root) does "
        "not",
        '+    outlast the call and change every later host compile."""',
        "+    @functools.wraps(fn)",
        "+    def wrapper(*args, **kwargs):",
        "+        with localcontext():",
        "+            return fn(*args, **kwargs)",
        "+",
        "+    return wrapper",
        "+",
        "+",
        "+@keeps_decimal_context"],
    "round/find_field.py": [
        "-from .rounding import RoundingSettings, _dd_rref_colpivot, _to_f64",
        "+from .rounding import (RoundingSettings, _dd_rref_colpivot, _to_f64,",
        "+                       keeps_decimal_context)",
        "+@keeps_decimal_context",
        "+@keeps_decimal_context"],
}
# dd/core.py keeps the numpy half and drops the JAX branches, the
# optimisation barriers and the TPU routing throughout (some 250 diff
# lines): its difference is held to the recorded one by digest, and
# printed when it changes
DIGESTS = {"dd/core.py": "0a046fa7e5e36570"}

IDENTICAL = (
    "model/problem.py", "model/reform.py", "model/checks.py",
    "compile/sdp.py", "compile/preprocess.py", "poly/mpoly.py",
    "poly/bases.py", "poly/samples.py", "poly/sampled.py", "poly/fekete.py",
    "solver/status.py", "utils/hp.py", "exact/rational.py",
    "exact/field.py", "exact/hnf.py", "exact/lll.py",
    "model/linearsystem.py", "model/sdpa.py", "round/__init__.py",
    "native/rref_modp.cpp",
    "frontend/__init__.py")


def _diff(module):
    src = (ROOT / "clrs_tpu" / module).read_text().splitlines()
    cpy = (ROOT / "clrs_tpu_torch" / module).read_text().splitlines()
    return [ln for ln in difflib.unified_diff(src, cpy, n=0, lineterm="")
            if ln[:1] in "+-" and not ln.startswith(("+++", "---"))]


@pytest.mark.parametrize("module", IDENTICAL + tuple(DIFFERENCES)
                         + tuple(DIGESTS))
def test_copy_equals_its_source(module):
    d = _diff(module)
    if module in DIGESTS:
        got = hashlib.sha256("\n".join(d).encode()).hexdigest()[:16]
        assert got == DIGESTS[module], "\n".join(d)
    else:
        assert d == DIFFERENCES.get(module, []), "\n".join(d)
