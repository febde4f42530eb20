"""Sharding of the IPM over a ``torch.distributed`` mesh (port of
``clrs_tpu/parallel/api.py``).

The shard axes are the JAX package's (clrs_tpu/parallel/api.py:1-31):

- the CLUSTER axis [J] of a group of same-signature clusters: its
  cluster-level arrays (c, B, the scalar packs) and the flattened class
  block axis [J * Lc] split by rank, so every per-cluster Schur
  complement, chol(S) and KKT solve stays on its rank; Q = sum_j
  (L^-1 B)_j^T (L^-1 B)_j and the dy sum see every cluster;
- the class BLOCK axis [J * Lc] alone (few-cluster problems): every
  per-block kernel runs on the rank's blocks, and the Schur sum and the
  trace_A sums over the class axis see all of them;
- the scalar-pack axis [Bs].

One process per rank (as under ``torchrun``) runs the same step on its
slice. Where a sharded axis is contracted, the step all-gathers the
per-block terms (raw words) and runs the one-process reduction in its
order, so the cluster, class and scalar-pack axes give the one-process
step bit for bit; minima and maxima are exact reductions. The collectives
are :mod:`.comm`'s. ONE big cluster distributes by row panels instead
(:func:`enable_row_sharding`, :mod:`.bigcluster`).

Only axes whose length divides by the mesh shard; :func:`shard_device_sdp`
RAISES if that leaves nothing sharded, because a silently replicated
model reports nothing about sharding. ``DeviceSDP(mesh_divisor=n)`` pads
the axes to divisibility with inert fake blocks and clusters. The mesh is
1-D; the ``axis`` arguments keep the JAX package's signatures and name
its one axis.
"""

from __future__ import annotations

from fractions import Fraction

import torch

from . import comm as _comm

__all__ = ["make_mesh", "shard_device_sdp", "shard_state",
           "enable_row_sharding", "multi_cluster_test_problem",
           "gather_state", "shard_plan", "row_plan", "mesh_size",
           "BLOCK_AXIS"]

BLOCK_AXIS = "blk"


def make_mesh(n_devices: int, axis: str = BLOCK_AXIS):
    """1-D ``DeviceMesh`` of ``n_devices`` ranks over the default process
    group, which the caller initializes (``torchrun``, or
    ``torch.distributed.init_process_group`` in each rank process). Raises
    ValueError unless that group exists with world size ``n_devices``:
    there is no fallback onto other devices."""
    ws = _comm.world_size()
    if ws != n_devices:
        raise ValueError(
            f"make_mesh({n_devices}) needs a default process group of world "
            f"size {n_devices}, " + ("but none is initialized" if ws == 0
                                     else f"got world size {ws}"))
    return _comm.device_mesh(n_devices, axis)


def mesh_size(mesh):
    """The number of ranks of a 1-D ``DeviceMesh``; TypeError for anything
    that is not a DeviceMesh, ValueError for more dimensions."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    if mesh.ndim != 1:
        raise ValueError(f"mesh must be 1-D, got {mesh.ndim} dimensions")
    return mesh.size()


def _shard_class(k, cl, mesh, axis, n):
    """Class block axis [J*Lc] shardable? jslot-major flattening means a
    J-divisible mesh split keeps whole clusters rank-local."""
    return k.L % n == 0 and k.L >= n > 1


def _shard_j(cl, n):
    return cl.J % n == 0 and cl.J >= n > 1


def _shard_bs(cl, n):
    return bool(cl.s_nb) and cl.s_nb % n == 0 and cl.s_nb >= n > 1


def shard_plan(ds, n):
    """The axes :func:`shard_device_sdp` shards over a mesh of ``n``: per
    cluster group, (shard J, shard Bs, [shard class]) from the predicates
    of clrs_tpu/parallel/api.py:69-81. Row-sharded groups keep their
    axes whole."""
    plan = []
    for cl in ds.clusters:
        if cl.row_shard:
            plan.append((False, False, [False] * len(cl.classes)))
            continue
        sj = _shard_j(cl, n)
        plan.append((sj, not sj and _shard_bs(cl, n),
                     [_shard_class(k, cl, None, None, n)
                      for k in cl.classes]))
    return plan


def _cut(x, dim, lo, n):
    """Words (a tuple) or one tensor, narrowed to [lo, lo + n) on ``dim``
    and copied (the rank keeps only its slice)."""
    if isinstance(x, tuple):
        return tuple(c.narrow(dim, lo, n).clone() for c in x)
    return x.narrow(dim, lo, n).clone()


def _cut_pre(pre, lo, n, stacked=False):
    """A precomputed limb form (limbs [L, ...], exps [L, ...]) narrowed to
    the rank's members; ``stacked`` forms hold two [L] stacks ([2L])."""
    if pre is None:
        return None
    if not stacked:
        return tuple(t.narrow(0, lo, n).clone() for t in pre)
    L = pre[0].shape[0] // 2
    return tuple(torch.cat([t.narrow(0, lo, n), t.narrow(0, L + lo, n)])
                 for t in pre)


_CLASS_WORDS = ("C", "V", "lam", "Ul", "Ur", "Ulw", "Urw", "A")
_CLASS_ARRAYS = ("maskd", "maskdiag", "li", "ri", "tmask")


def shard_device_sdp(ds, mesh, axis: str = BLOCK_AXIS) -> int:
    """Shard the DeviceSDP constants in place: this rank keeps its slice of
    each shardable axis (:func:`shard_plan`: the cluster axis first, then
    the class axis, then the scalar pack, clrs_tpu/parallel/api.py:83-147).
    Build the DeviceSDP with ``mesh_divisor=n`` to make axes divisible.
    Returns the number of sharded axes; raises ValueError if zero (silent
    full replication) and leaves the DeviceSDP as it was."""
    n = mesh_size(mesh)
    if ds.comm is not None:
        raise ValueError("this DeviceSDP is sharded already")
    plan = shard_plan(ds, n)
    sharded = sum(int(sj) + int(sb) + sum(ks) for sj, sb, ks in plan)
    if sharded == 0:
        raise ValueError(
            "no cluster, class, or scalar-pack axis was shardable over "
            f"this mesh (mesh size {n}); refusing to run a fully "
            "replicated model")
    cm = ds.row_comm or _comm.Comm(mesh)
    for cl, (sj, sb, ks) in zip(ds.clusters, plan):
        cl.comm = cm
        for k, sk in zip(cl.classes, ks):
            if not sk:
                continue
            per = k.L // n
            lo = cm.rank * per
            for key in _CLASS_WORDS + _CLASS_ARRAYS:
                v = getattr(k, key)
                if v is not None:
                    setattr(k, key, _cut(v, 0, lo, per))
            for key in ("Vpre_r", "Vtpre_l", "Urpre_r"):
                setattr(k, key, _cut_pre(getattr(k, key), lo, per))
            for key in ("V2pre_r", "V2tpre_l", "U2pre_l", "U2tpre_r"):
                setattr(k, key, _cut_pre(getattr(k, key), lo, per,
                                         stacked=True))
            if k.U2pre_l is not None:
                k.Ulpre_l = tuple(t[per:] for t in k.U2pre_l)
            k.shard, k.lo, k.L = True, lo, per
        if sj:
            per = cl.J // n
            lo = cm.rank * per
            cl.B_full = cl.B
            for key in ("c", "B", "sa", "sC", "jmask", "smask"):
                if getattr(cl, key) is not None:
                    setattr(cl, key, _cut(getattr(cl, key), 0, lo, per))
            cl.shard_j, cl.J = True, per
        elif sb:
            per = cl.s_nb // n
            lo = cm.rank * per
            cl.sa_full = cl.sa
            cl.sa = _cut(cl.sa, 1, lo, per)
            cl.sC = _cut(cl.sC, 1, lo, per)
            cl.smask = _cut(cl.smask, 1, lo, per)
            cl.shard_bs, cl.s_lo, cl.s_nb = True, lo, per
    ds.comm = cm
    return sharded


def _state_parts(ds):
    """(key path, sharded dim or None) of each leaf of a state: per group
    x, X/Y per class, Xs/Ys; y is replicated."""
    out = []
    for j, cl in enumerate(ds.clusters):
        out.append((("x", j), 0 if cl.shard_j else None))
        for ki, k in enumerate(cl.classes):
            d = 0 if k.shard else None
            out.append((("X", j, ki), d))
            out.append((("Y", j, ki), d))
        d = 0 if cl.shard_j else (1 if cl.shard_bs else None)
        out.append((("Xs", j), d))
        out.append((("Ys", j), d))
    return out


def _get(state, path):
    v = state[path[0]]
    for i in path[1:]:
        v = v[i]
    return v


def _map_state(ds, state, fn):
    """A new state with ``fn(words, dim)`` applied to each leaf."""
    out = {"y": tuple(state["y"]), "x": list(state["x"]),
           "X": [list(c) for c in state["X"]],
           "Y": [list(c) for c in state["Y"]],
           "Xs": list(state["Xs"]), "Ys": list(state["Ys"])}
    for path, dim in _state_parts(ds):
        v = fn(_get(state, path), dim)
        if len(path) == 3:
            out[path[0]][path[1]][path[2]] = v
        else:
            out[path[0]][path[1]] = v
    return out


def shard_state(ds, state, mesh, axis: str = BLOCK_AXIS):
    """This rank's slice of a full IPM state (as ``initial_state`` of the
    unsharded DeviceSDP, or ``state_from_numpy`` of a one-process state,
    gives it), consistently with :func:`shard_device_sdp`, which must have
    run on ``ds``. A DeviceSDP sharded before ``initial_state`` gives the
    rank's slice of the initial state directly."""
    n = mesh_size(mesh)
    rank = ds.comm.rank if ds.comm is not None else 0

    def cut(ws, dim):
        if dim is None:
            return tuple(ws)
        per = ws[0].shape[dim] // n
        return _cut(tuple(ws), dim, rank * per, per)

    return _map_state(ds, state, cut)


def gather_state(ds, state):
    """The full state from every rank's slice (exact; every rank gets it):
    the inverse of :func:`shard_state`."""
    if ds.comm is None:
        return state

    def gather(ws, dim):
        return tuple(ws) if dim is None else ds.comm.all_gather(ws, dim)

    return _map_state(ds, state, gather)


def row_plan(ds, n):
    """Which cluster groups :func:`enable_row_sharding` distributes by row
    panels over a mesh of ``n``: J == 1, P divisible by the mesh with >= 8
    rows a rank (:func:`.bigcluster.row_shard_ok`), low-rank classes on
    the pair path, no dense classes (clrs_tpu/parallel/api.py:183-210)."""
    from .bigcluster import row_shard_ok

    return [cl.J == 1 and row_shard_ok(cl.nrows, n)
            and any(k.kind == "lowrank" for k in cl.classes)
            and all(k.kind == "lowrank" and k.use_pairs for k in cl.classes)
            for cl in ds.clusters]


def enable_row_sharding(ds, mesh, axis: str = None) -> int:
    """Row-panel sharding of SINGLE-cluster groups over ``mesh``: the
    [P, P] Schur assembly, chol(S) and the KKT triangular solves of each
    eligible cluster (:func:`row_plan`) distribute by row panels
    (:mod:`.bigcluster`); the rest of the cluster stays replicated.
    Returns the number of clusters enabled; 0 leaves the DeviceSDP
    untouched."""
    plan = row_plan(ds, mesh_size(mesh))
    if any(plan):
        ds.row_comm = ds.comm or _comm.Comm(mesh)
        for cl, on in zip(ds.clusters, plan):
            if on:
                cl.row_shard, cl.comm = True, ds.row_comm
    return sum(plan)


def multi_cluster_test_problem(n_clusters: int = 4, n_blocks: int = 8):
    """A small SDP with ``n_clusters`` independent clusters, each holding
    ``n_blocks`` same-size 2x2 PSD blocks (one size class of L = n_blocks),
    coupled ONLY through a shared free variable: block-parallel work inside
    clusters, a single cross-cluster reduction through Q
    (clrs_tpu/parallel/api.py:213-236)."""
    from ..model.problem import Constraint, Maximize, Objective, Problem

    h = Fraction(1, 2)
    obj_mats = {}
    cons = []
    for c in range(n_clusters):
        names = [f"X{c}_{b}" for b in range(n_blocks)]
        for nm in names:
            obj_mats[nm] = [[-1, 0], [0, -1]]
        a1 = {nm: [[1, h], [h, 0]] for nm in names}
        a2 = {nm: [[0, h], [h, 1]] for nm in names}
        cons.append(Constraint(Fraction(3 + c, 2), a1, {"y": 1}))
        cons.append(Constraint(Fraction(4 + c, 3), a2, {"y": -1}))
    obj = Objective(0, obj_mats, {"y": Fraction(1, 10)})
    return Problem(Maximize(obj), cons)
