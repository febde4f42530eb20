"""clrs_tpu_torch: the clustered low-rank SDP solver on PyTorch and CUDA.

A port of :mod:`clrs_tpu` (JAX on a TPU) to one NVIDIA Hopper GPU. The
modelling API and the host layers (problem building, sampled polynomials,
compilation to a clustered SDP, preprocessing) are the JAX package's own
source, loaded without JAX through :mod:`clrs_tpu_torch.host`. The solver
is ported: ``solvesdp(problem, device="cuda")`` runs the f32-expansion
interior point method through hand-written CUDA kernels
(:mod:`clrs_tpu_torch.dd.kernels`). This package never imports JAX.
"""

from .host.model.problem import (Block, Constraint, LowRankMatPol, Maximize,
                                 Minimize, Objective, Problem)
from .host.model.reform import model_psd_variables_as_free_variables
from .host.compile.sdp import ClusteredLowRankSDP
from .host.solver.status import (DualFeasible, DualSolution, Feasible,
                                 NearOptimal, NotConverged, Optimal,
                                 PrimalFeasible, PrimalSolution, as_primal_solution,
                                 freevar, freevars, matrixvar, matrixvars,
                                 objvalue, optimal, slacks, vectorize)
from .host.poly.mpoly import PolyRing, polynomial_ring
from .host.poly.bases import (basis_chebyshev, basis_gegenbauer, basis_jacobi,
                              basis_laguerre, basis_monomial)
from .host.poly.samples import (sample_points_chebyshev,
                                sample_points_chebyshev_mod,
                                sample_points_padua,
                                sample_points_rescaled_laguerre,
                                sample_points_simplex)
from .host.poly.sampled import (SampledPoly, SampledPolyRing,
                                sampled_polynomial_ring)
from .host.poly.fekete import approximatefekete, approximatefeketeexact
from .solver.ipm import SaveSettings, SolverFailure, solvesdp

__version__ = "0.1.0"
