"""theta(C5) and the POVM at f32 nw 5 on the CPU: the JAX package against
the port (ROADMAP.md, section C, C4). Not a test file: it writes the
fixture of tests/test_torch_c4_theta.py and runs the whole solves that
file keeps out of the tests.

    python tests/c4_theta.py              # writes tests/fixtures/c4_theta_c5_jax.npz
    python tests/c4_theta.py --solves     # both packages' 250-iteration solves
    python tests/c4_theta.py --lockstep 8 [povm]   # 8 steps side by side

The fixture holds the JAX package's own f32 nw 5 step (jit, its CPU route)
on theta(C5): the state before each of the first four iterations, its
pd_feas flag, and the info of each of those iterations. Compiling that
step takes about 45 s here, which is why the test reads it from a file.

--lockstep N runs the JAX package's step and the port's step (each with
its own eigensolver, subnormals flushed as XLA:CPU does) side by side from
omega 100 I on theta(C5) (or the POVM), and prints per iteration whether the states are
equal word for word and the relative differences of mu and the step
lengths.

--solves runs examples/theta_povm.py's lovasz_theta_c5 and povm with
substrate="f32", maxiterations=250, and the port's counterparts in
clrs_tpu_torch.examples with device="cpu" (a few minutes), and prints
each solve's error code, iterations and objective.
"""

import os
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_max_isa=AVX")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "c4_theta_c5_jax.npz"
N_ITERATIONS = 4
INFO_KEYS = ("mu", "alpha_d", "alpha_p", "d_obj", "p_obj")
STEP_KW = dict(gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
               dual_error_threshold=1e-30, primal_error_threshold=1e-30)
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))


def compiled_sdp(api, model_module, build):
    """The SDP that ``api``'s solvesdp builds from the Model of ``build``
    (an example of either package): compiled, empty blocks removed,
    preprocessed."""
    from importlib import import_module

    solve = model_module.Model.solve
    model_module.Model.solve = lambda self, **kw: self.build_problem()
    try:
        problem = build().build_problem()
    finally:
        model_module.Model.solve = solve
    sdp = api.ClusteredLowRankSDP(problem)
    import_module(api.__name__ + ".model.checks").remove_empty_blocks(
        sdp, verbose=False)
    prep = import_module(api.__name__ + ".compile.preprocess")
    return prep.preprocess_sdp(sdp, verbose=False)[0]


def write_fixture():
    import jax.numpy as jnp
    import theta_povm

    import clrs_tpu as jc
    import clrs_tpu.frontend.model as model_j
    from clrs_tpu.solver import step as JS

    dj = JS.DeviceSDP(compiled_sdp(jc, model_j, theta_povm.lovasz_theta_c5),
                      nw=5, dtype=jnp.float32)
    step = JS.make_step(dj, **STEP_KW)
    state, feas = JS.initial_state(dj, 100.0, 100.0), False
    out = {}
    for it in range(1, N_ITERATIONS + 1):
        for i, leaf in enumerate(jax.tree_util.tree_leaves(state)):
            out[f"state{it}_{i}"] = np.asarray(leaf)
        out[f"feas{it}"] = np.asarray(feas)
        state, info = step(state, feas)
        out[f"info{it}"] = np.array([float(info[k]) for k in INFO_KEYS])
        feas = bool(info["pd_feas"])
    np.savez_compressed(FIXTURE, **out)
    print(f"wrote {FIXTURE}")


def lockstep(n, name="lovasz_theta_c5"):
    import jax.numpy as jnp
    import theta_povm
    import torch

    import clrs_tpu as jc
    import clrs_tpu.frontend.model as model_j
    import clrs_tpu_torch as ct
    import clrs_tpu_torch.examples as examples_t
    import clrs_tpu_torch.frontend.model as model_t
    from clrs_tpu.solver import step as JS
    from clrs_tpu_torch.solver import step as TS
    from clrs_tpu_torch.state import state_to_numpy

    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    dj = JS.DeviceSDP(compiled_sdp(jc, model_j, getattr(theta_povm, name)),
                      nw=5, dtype=jnp.float32)
    dt = TS.DeviceSDP(compiled_sdp(ct, model_t, getattr(examples_t, name)),
                      nw=5, device="cpu")
    step_j, step_t = JS.make_step(dj, **STEP_KW), TS.make_step_body(
        dt, **STEP_KW)
    sj, st = JS.initial_state(dj, 100.0, 100.0), TS.initial_state(
        dt, 100.0, 100.0)
    fj = ft = False
    for it in range(1, n + 1):
        same = all(np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, sj)),
            jax.tree_util.tree_leaves(state_to_numpy(st))))
        sj, ij = step_j(sj, fj)
        st, itt = step_t(st, ft)
        fj, ft = bool(ij["pd_feas"]), bool(itt["pd_feas"])
        rel = {k: abs(float(ij[k]) - float(itt[k])) / abs(float(ij[k]))
               for k in ("mu", "alpha_d", "alpha_p")}
        print(f"iteration {it}: states equal before it {same}; JAX alpha_p "
              f"{float(ij['alpha_p'])!r}, port {float(itt['alpha_p'])!r}; "
              f"rel. differences {rel}", flush=True)


def solves():
    import theta_povm

    import clrs_tpu_torch.examples as examples_t
    from clrs_tpu.solver.ipm import SaveSettings as SaveJ
    from clrs_tpu_torch.solver.ipm import SaveSettings as SaveT

    for name in ("lovasz_theta_c5", "povm"):
        for label, fn, save, kw in (
                ("JAX", getattr(theta_povm, name), SaveJ, {}),
                ("port", getattr(examples_t, name), SaveT,
                 {"device": "cpu"})):
            iters = []

            def count(it, *_):
                iters.append(it)
                return False

            m = fn(substrate="f32", maxiterations=250,
                   save_settings=save(callback=count), **kw)
            print(f"{name} {label}: code {m.errorcode}, iterations "
                  f"{iters[-1] if iters else 0}, objective "
                  f"{float(m.objective_value().hi)!r}", flush=True)


if __name__ == "__main__":
    if "--solves" in sys.argv:
        solves()
    elif "--lockstep" in sys.argv:
        i = sys.argv.index("--lockstep")
        lockstep(int(sys.argv[i + 1]), *sys.argv[i + 2:i + 3])
    else:
        write_fixture()
