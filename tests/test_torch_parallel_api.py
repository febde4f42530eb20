"""The port's mesh API (clrs_tpu_torch.parallel.api) and the inert padding
of DeviceSDP(mesh_divisor=...), in this process: no rank processes.

- make_mesh raises unless the default process group has its world size
  (the JAX package's make_mesh falls back onto CPU devices; the port's
  does not);
- shard_device_sdp refuses to leave a model fully replicated
  (tests/test_sharding.py:134-145), and solvesdp keeps the refusal;
- the port's choice of sharded axes equals the JAX predicates'
  (clrs_tpu/parallel/api.py:69-81) on the same padded problems, and the
  padded DeviceSDP's words equal the JAX package's bit for bit;
- the padding is inert: the padded first step equals the unpadded one bit
  for bit on the CPU, and the JAX package's padded first step at rel
  1e-13, abs 1e-18 (the contract of tests/test_torch_step.py).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import clrs_tpu as jc
import clrs_tpu.parallel.api as JA
import clrs_tpu_torch as ct
from clrs_tpu.solver import step as JS
from clrs_tpu_torch.parallel import api as TA
from clrs_tpu_torch.solver import step as TS
from torch_helpers import STEP_KW, delsarte

INFO_KEYS = ("mu", "d_obj", "p_obj", "alpha_d", "alpha_p", "dual_error",
             "primal_error", "dual_gap")


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo default process group of world size 1 in this process."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_raises_at_wrong_world_size(world_of_one):
    mesh = TA.make_mesh(1)
    assert mesh.size() == 1 and mesh.mesh_dim_names == (TA.BLOCK_AXIS,)
    for n in (2, 4):
        with pytest.raises(ValueError, match="world size"):
            TA.make_mesh(n)


def test_make_mesh_raises_without_process_group():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="none is initialized"):
        TA.make_mesh(1)


def test_shard_refuses_full_replication(world_of_one):
    """No axis divides the mesh: shard_device_sdp raises and leaves the
    DeviceSDP unsharded; solvesdp keeps the failure (no row-panel
    cluster either)."""
    problem = TA.multi_cluster_test_problem(n_clusters=2, n_blocks=3)
    ds = TS.DeviceSDP(ct.ClusteredLowRankSDP(problem), device="cpu")
    assert TA.shard_plan(ds, 8) == [(False, False, [False])]
    with pytest.raises(ValueError, match="refusing"):
        TA.shard_device_sdp(ds, TA.make_mesh(1))
    assert ds.comm is None and not TS.sharded(ds)
    with pytest.raises(ValueError, match="refusing"):
        ct.solvesdp(problem, device="cpu", mesh=TA.make_mesh(1),
                    verbose=False)


def _problems():
    from clrs_tpu.parallel import multi_cluster_test_problem as jm

    return [("delsarte3", lambda api: delsarte(api, 3)),
            ("delsarte4", lambda api: delsarte(api, 4)),
            ("multi8x4", lambda api: (jm if api is jc else
                                      TA.multi_cluster_test_problem)(8, 4)),
            ("multi2x3", lambda api: (jm if api is jc else
                                      TA.multi_cluster_test_problem)(2, 3)),
            ("multi3x2", lambda api: (jm if api is jc else
                                      TA.multi_cluster_test_problem)(3, 2))]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name,build", _problems(),
                         ids=[p[0] for p in _problems()])
def test_shard_plan_matches_jax_predicates(name, build, n):
    """The same padded problems give the same sharded axes, and the same
    padded words (f32 nw 5)."""
    import jax.numpy as jnp

    for div in (1, n):
        dj = JS.DeviceSDP(jc.ClusteredLowRankSDP(build(jc)), nw=5,
                          dtype=jnp.float32, mesh_divisor=div)
        dt = TS.DeviceSDP(ct.ClusteredLowRankSDP(build(ct)), nw=5,
                          device="cpu", mesh_divisor=div)
        want = [(JA._shard_j(cl, n), not JA._shard_j(cl, n)
                 and JA._shard_bs(cl, n),
                 [JA._shard_class(k, cl, None, JA.BLOCK_AXIS, n)
                  for k in cl.classes]) for cl in dj.clusters]
        assert TA.shard_plan(dt, n) == want
        for cj, ctt in zip(dj.clusters, dt.clusters):
            assert (cj.J, cj.s_nb, cj.s_nreal, cj.layout) == \
                (ctt.J, ctt.s_nb, ctt.s_nreal, ctt.layout)
            assert np.array_equal(np.asarray(cj.jmask), ctt.jmask.numpy())
            for key in ("c", "B", "sa", "sC"):
                if getattr(cj, key) is not None:
                    for a, b in zip(getattr(cj, key), getattr(ctt, key)):
                        assert np.array_equal(np.asarray(a), b.numpy()), key
            for kj, kt in zip(cj.classes, ctt.classes):
                assert (kj.L, kj.Lc, kj.n, kj.use_pairs) == \
                    (kt.L, kt.Lc, kt.n, kt.use_pairs)
                assert np.array_equal(np.asarray(kj.maskd), kt.maskd.numpy())
                for a, b in zip(kj.C, kt.C):
                    assert np.array_equal(np.asarray(a), b.numpy())


def _real_blocks(ds, state):
    """Each real block's words of X and Y, by (cluster, block), x and the
    scalar packs (padded at their end), as numpy arrays."""
    out = {}
    for j, (g, jslot) in sorted(ds.cluster_of.items()):
        dc = ds.clusters[g]
        for l, (ki, slot) in enumerate(dc.layout[jslot]):
            for key in ("X", "Y"):
                out[key, j, l] = [c[slot].numpy()
                                  for c in state[key][g][ki]]
        for key in ("Xs", "Ys", "x"):
            if key != "x" and not dc.s_nb:
                continue
            out[key, j] = [c[jslot].numpy() for c in state[key][g]]
    return out


def test_mesh_divisor_padding_is_inert():
    """delsarte(3,4) padded for a mesh of 8 (fake blocks on the class axis,
    the scalar pack padded at its end): the first step equals the unpadded
    one bit for bit, info and every real block's words, on the CPU; and
    the JAX package's padded first step (its default CPU substrate) at
    rel 1e-13, abs 1e-18."""
    sdp = ct.ClusteredLowRankSDP(delsarte(ct, 4))
    infos, blocks, ys = [], [], []
    for div in (1, 8):
        ds = TS.DeviceSDP(sdp, nw=5, device="cpu", mesh_divisor=div)
        new, info = TS.make_step_body(ds, **STEP_KW)(
            TS.initial_state(ds, 100.0, 100.0), False)
        infos.append({k: float(v) for k, v in info.items()})
        blocks.append(_real_blocks(ds, new))
        ys.append([c.numpy() for c in new["y"]])
    assert [k.L for cl in ds.clusters for k in cl.classes] == [8]
    assert ds.clusters[0].s_nb % 8 == 0
    assert infos[0] == infos[1]
    assert blocks[0].keys() == blocks[1].keys()
    for key, ws in blocks[0].items():
        for a, b in zip(ws, blocks[1][key]):
            b = b[:a.shape[0]]            # the scalar pack's real entries
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), key
    for a, b in zip(*ys):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))

    dj = JS.DeviceSDP(jc.ClusteredLowRankSDP(delsarte(jc, 4)),
                      mesh_divisor=8)
    _, info_j = JS.make_step(dj, **STEP_KW)(
        JS.initial_state(dj, 100.0, 100.0), False)
    for k in INFO_KEYS:
        assert infos[1][k] == pytest.approx(float(info_j[k]), rel=1e-13,
                                            abs=1e-18), k
