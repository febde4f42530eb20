"""clrs_tpu_torch: the clustered low-rank SDP solver on PyTorch and CUDA.

A port of :mod:`clrs_tpu` (JAX on a TPU) to one NVIDIA Hopper GPU. The
modelling API and the host layers (problem building, sampled polynomials,
compilation to a clustered SDP, preprocessing) are copies of the JAX
package's modules at the same relative paths (``model/``, ``poly/``,
``compile/``, ``exact/rational.py``, ``utils/hp.py``, ``solver/status.py``
and the numpy half of ``dd/core.py``). The solver is ported:
``solvesdp(problem)`` runs the f32-expansion interior point method on the
card through hand-written CUDA kernels (:mod:`clrs_tpu_torch.dd.kernels`);
``device="cpu"`` runs the kernels' plain PyTorch versions.
``substrate="f64"`` runs it on f64 words instead (the JAX package's
substrate off the TPU: :mod:`clrs_tpu_torch.dd.f64ops` and slice GEMMs).
The exact rounding stack (``exact/``, ``round/``, ``native/``,
``model/linearsystem.py``, ``model/sdpa.py``) is copied too and runs on
the host, with its own ``nextprime`` (``exact/primes.py``) in place of
sympy's; the ``frontend.Model`` solves through the port's ``solvesdp``.
This package imports neither JAX, nor sympy, nor anything of
:mod:`clrs_tpu`.
"""

from .model.problem import (Block, Constraint, LowRankMatPol, Maximize,
                            Minimize, Objective, Problem)
from .model.reform import model_psd_variables_as_free_variables
from .compile.sdp import ClusteredLowRankSDP
from .solver.status import (DualFeasible, DualSolution, Feasible,
                            NearOptimal, NotConverged, Optimal,
                            PrimalFeasible, PrimalSolution, as_primal_solution,
                            freevar, freevars, matrixvar, matrixvars,
                            objvalue, optimal, slacks, vectorize)
from .poly.mpoly import PolyRing, polynomial_ring
from .poly.bases import (basis_chebyshev, basis_gegenbauer, basis_jacobi,
                         basis_laguerre, basis_monomial)
from .poly.samples import (sample_points_chebyshev,
                           sample_points_chebyshev_mod,
                           sample_points_padua,
                           sample_points_rescaled_laguerre,
                           sample_points_simplex)
from .poly.sampled import (SampledPoly, SampledPolyRing,
                           sampled_polynomial_ring)
from .poly.fekete import approximatefekete, approximatefeketeexact
from .solver.ipm import SaveSettings, SolverFailure, solvesdp

__version__ = "0.1.0"

# rounding and exact solutions, on the host (clrs_tpu/__init__.py:83-93)
from .round.rounding import RoundingSettings, exact_solution  # noqa: E402
from .round.find_field import find_field, to_field, min_poly  # noqa: E402
from .exact.field import NumberField, QQ, generic_embedding  # noqa: E402
from .model.sdpa import sdpa_sparse_to_problem  # noqa: E402
from .model.checks import check_problem, check_sdp  # noqa: E402
from .model.linearsystem import (  # noqa: E402
    linearsystem,
    linearsystem_coefficientmatching,
    partial_linearsystem,
)
from . import frontend  # noqa: E402
from . import tracing  # noqa: E402

tracing.instrument_compile()
