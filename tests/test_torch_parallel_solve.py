"""``clrs_tpu_torch.solvesdp(mesh=...)`` end to end over gloo rank
processes on the CPU (tests/torch_helpers.py::run_ranks), against the
one-process port solve, as tests/test_sharding.py:111-132 and 241-262 hold
the JAX package's sharded solves: delsarte(3,10) over 2 ranks (one
cluster: the class and scalar-pack axes, padded by mesh_divisor) and
multi_cluster_test_problem(4, 2) over 4 (the cluster and class axes),
each to optimality, every rank with the one-process code, status and
iteration count, and its objective within 1e-10; and a checkpoint asked
for by one rank only is taken by all. Both run on the f64
substrate, the JAX package's default on the CPU (the f32 kernels' plain
versions take minutes here; the f32 step is held word for word in
tests/test_torch_parallel_step.py).
"""

import pytest

import clrs_tpu_torch as ct
from clrs_tpu_torch.parallel import api as TA
from torch_helpers import delsarte, run_ranks, save_on_rank_1, solve_on_mesh

KW = dict(verbose=False, omega_p=100.0, omega_d=100.0, substrate="f64",
          dual_error_threshold=1e-12, primal_error_threshold=1e-12)


@pytest.mark.parametrize("name,world", [("delsarte3_10", 2),
                                        ("multi4x2", 4)])
def test_sharded_solve_equals_one_process(name, world, tmp_path):
    problem = (delsarte(ct, 10) if name == "delsarte3_10"
               else TA.multi_cluster_test_problem(4, 2))
    code, status, its, obj = solve_on_mesh(problem, 0, KW)
    assert code == 0 and status == "Optimal"
    if name == "delsarte3_10":
        assert obj == pytest.approx(13.15831434739031, abs=1e-9)
    for r, got in enumerate(run_ranks(tmp_path, world, "solve_on_mesh",
                                      problem, world, KW)):
        assert got[:3] == (code, status, its), (r, got)
        assert abs(got[3] - obj) < 1e-10, (r, got[3], obj)


def test_save_decisions_agree_across_ranks(tmp_path):
    """A checkpoint that only rank 1's callback asks for: every rank joins
    the gather of the state and rank 0 writes the file (a rank that
    gathered alone would wait on the others until gloo's timeout)."""
    problem = TA.multi_cluster_test_problem(4, 2)
    name = str(tmp_path / "ckpt")
    kw = dict(KW, save_settings=ct.SaveSettings(callback=save_on_rank_1,
                                                 save_name=name))
    ranks = run_ranks(tmp_path, 2, "solve_on_mesh", problem, 2, kw)
    assert ranks[0] == ranks[1] and ranks[0][0] == 0
    assert (tmp_path / "ckpt.jls").is_file()
