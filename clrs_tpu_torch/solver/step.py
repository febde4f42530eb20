"""One Mehrotra predictor-corrector IPM iteration (port of
``clrs_tpu/solver/step.py``), on f32-expansion or f64 words.

The structure is the JAX package's: PSD blocks are grouped into size
classes per cluster and every per-block operation runs once per class over
a leading [L] batch axis; 1x1 dense blocks form a per-cluster scalar pack;
padding is inert (padded diagonal entries of X/Y pinned at 1, residuals
masked). Every value is an nw-word expansion of the DeviceSDP's word
dtype, and every op dispatches on it (:mod:`clrs_tpu_torch.dd.arith`):

- f32 words (default nw = 5, ~106 bits), the route the JAX package takes
  on the TPU: GEMMs are exact int8-limb products
  (:func:`clrs_tpu_torch.dd.limb_gemm.fx_matmul`, routed as there by
  :func:`clrs_tpu_torch.dd.limb_gemm.gemm_route`), factorizations and
  triangular solves go through the kernel wrappers of
  :mod:`clrs_tpu_torch.dd.kernels`, and the three per-class elementwise
  chains of ``pl_map`` (the residual R, the corrector sum X + dX and the
  state update X + alpha dX) run as one kernel each (``plmap_*``);
  ``plmap=False`` gives the JAX ``_USE_PLMAP=False`` form of plain
  expansion ops instead;
- f64 words (nw = 2, 4, ...), the route the JAX package takes off the
  TPU: GEMMs are slice GEMMs (:mod:`clrs_tpu_torch.dd.slice_gemm`), the
  factorizations the batched f64 loops of :mod:`clrs_tpu_torch.dd.linalg`,
  and the three chains plain expansion ops (the JAX package gates
  ``pl_map`` on f32 words).

The step-length bound takes the lowest eigenvalue of float64 matrices
with ``eig_safety`` (the JAX package's off-TPU route): on the card the
port's ``eig_lowest`` kernel (csrc/eig.cu), on the CPU LAPACK's
``torch.linalg.eigvalsh``. With the module global
``_STEPLEN_VERIFIED = True`` (the JAX package's own override) f32 words
take the JAX package's TPU route instead: f32 eigenpairs (the card's
``eig_pairs`` Jacobi kernel, LAPACK's ``eigh`` on the CPU) certified with
exact limb GEMMs (:func:`_eig_lo_certified`). The scalar-pack parts stay
plain ops, as in the JAX package.

A step is a Python function over device tensors, split at its
eigensolver into a head and a tail (:func:`make_step_parts`);
:func:`make_step_body` runs them eagerly, and on the card :func:`make_step`
and :func:`make_run_chunk` replay head, eigensolver and tail as one CUDA
graph (:class:`.graph.GraphStep`), the counterpart of the JAX package's
``jax.jit`` and ``lax.while_loop``, on either substrate.

Sharded over a mesh (:mod:`clrs_tpu_torch.parallel`), every rank runs the
same step on its slice of the cluster, class or scalar-pack axes; where a
sharded axis is contracted (the Schur and trace_A sums over the class
axis, Q, the dy sum, B^T x, the inner products behind mu and the
objectives) the per-block terms are all-gathered and reduced in the
one-process order, and the error maxima, step-length minima and ok flags
are reduced across the ranks. Row-sharded big clusters run their Schur
assembly, chol(S) and KKT solves by row panels
(:mod:`clrs_tpu_torch.parallel.bigcluster`). A sharded step runs eagerly
(:class:`.graph.EagerSplit`): its collectives are not captured.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch

from .. import tracing
from ..compile.sdp import ClusteredLowRankSDP
from ..dd import core as host_core
from ..dd import kernels as dk
from ..dd import linalg as dl
from ..dd import ops as O
from ..dd.arith import (dd_add, dd_commit, dd_div, dd_fma, dd_fms, dd_mms,
                        dd_msub, dd_mul, dd_neg, dd_sub, dd_sub2)
from ..dd.limb_gemm import fx_matmul, host_precompute
from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["DeviceSDP", "make_step_parts", "make_step_body", "make_step",
           "make_run_chunk", "make_assess", "initial_state", "zero_info",
           "eig_lowest", "eig_pairs", "step_eig", "sharded"]

F32 = torch.float32
F64 = torch.float64


def _w(a, nw, device, dtype=F32):
    """Host multi-word tuple (f64 words) -> nw words of ``dtype`` on
    ``device`` (clrs_tpu/solver/step.py:75-95). f32: the double-word value
    is re-decomposed on the host (IEEE f64) into nw non-overlapping f32
    words. f64: the first nw words as they are, zero words after them (an
    exact embed)."""
    if dtype == F64:
        ws = tuple(torch.from_numpy(np.array(c, dtype=np.float64)).to(device)
                   for c in a[:nw])
        return ws + tuple(torch.zeros_like(ws[0])
                          for _ in range(nw - len(ws)))
    h = np.asarray(a[0], dtype=np.float64)
    l = np.asarray(a[1], dtype=np.float64) if len(a) > 1 else np.zeros_like(h)
    words = []
    for _ in range(nw):
        w = (h + l).astype(np.float32)
        words.append(torch.from_numpy(np.array(w)).to(device))
        h, l = host_core.dd_add_f64((h, l), -w.astype(np.float64))
    return tuple(words)


def _scalar(v, nw):
    """nw-word f32 value from an f32 tensor (exact embed)."""
    return (v,) + (torch.zeros_like(v),) * (nw - 1)


def _scalar_split(v, nw, dtype=F32):
    """f64 tensor -> nw-word expansion of ``dtype``: f32 words take up to
    three words by successive rounding, so the full f64 value enters the
    expansion arithmetic; f64 words take v as word 0."""
    if dtype == F64:
        return (v,) + (torch.zeros_like(v),) * (nw - 1)
    return dk.expf64_split(v, nw)


def _bcast_words(ws, L):
    """Scalar expansion -> [L, 1, 1]-broadcast word views for the chain
    kernels (clrs_tpu/solver/step.py:1232-1236; nothing is copied)."""
    return tuple(c.reshape(1, 1, 1).expand(L, 1, 1) for c in ws)


def _f64sum(x):
    """Multi-word value -> float64 (exact word casts, summed in f64): one
    expf64 launch for f32 words on the card."""
    return dk.expf64_sum(x)


def _dd_scale(x, a):
    """Multiply an expansion by an exact {0,1}/power-of-two array."""
    return tuple(c * a for c in x)


def _cat(a, b):
    return tuple(torch.cat([x, y], 0) for x, y in zip(a, b))


_bmm = dl.bmm


def _bmm_pre_r(a, pre):
    """Batched GEMM with a host-precomputed (constant) RIGHT operand."""
    return fx_matmul(a, None, nw=len(a), pre_b=pre)


def _bmm_pre_l(b, pre, nw):
    """Batched GEMM with a host-precomputed (constant) LEFT operand."""
    return fx_matmul(None, b, nw=nw, pre_a=pre)


def _class_terms(cl, k, x):
    """Per-block terms [L, ...] of a class whose [J*Lc] axis is split by
    rank while its clusters are not: all ranks' blocks, in order, so that
    the reduction over each cluster's Lc blocks is the one-process one."""
    return cl.comm.all_gather(x, 0) if k.shard and not cl.shard_j else x


def _s_axis(cl):
    """The sharded axis of a scalar pack [J, Bs], or None."""
    return 0 if cl.shard_j else (1 if cl.shard_bs else None)


def _dot(cl, x, y, dim, acc, scale=None):
    """acc + sum(x s * y) over all elements (s an exact mask, or none):
    one fused product-sum-accumulate (:func:`dl.dd_sum_prod`) where
    ``dim`` is None; where ``dim`` is sharded the products are gathered
    along it first, so the product and the sum run apart."""
    if dim is None:
        return dl.dd_sum_prod(x, y, None, acc, scale=scale)
    p = dd_mul(x if scale is None else _dd_scale(x, scale), y)
    p = cl.comm.all_gather(p, dim)
    return dd_add(acc, dl.dd_sum(tuple(c.reshape(-1) for c in p), axis=0))


@dataclasses.dataclass
class _DevClass:
    """A batch of same-size-class PSD blocks of one cluster group; the
    leading axis has length L = J * Lc, jslot-major."""

    kind: str
    L: int
    n: int
    Lc: int
    members: List[Tuple[int, int, int]]
    C: Any
    maskd: Any = None
    maskdiag: Any = None
    V: Any = None
    lam: Any = None
    li: Any = None               # int64 [L, P, T] (torch index dtype)
    ri: Any = None
    tmask: Any = None
    Ul: Any = None
    Ur: Any = None
    Ulw: Any = None
    Urw: Any = None
    use_pairs: bool = False
    A: Any = None
    Vpre_r: Any = None
    Vtpre_l: Any = None
    V2pre_r: Any = None
    V2tpre_l: Any = None
    Urpre_r: Any = None
    U2pre_l: Any = None
    U2tpre_r: Any = None
    Ulpre_l: Any = None
    shard: bool = False          # the [L] axis split by rank (L is local)
    lo: int = 0                  # first block of this rank's slice


@dataclasses.dataclass
class _DevCluster:
    """A group of J same-signature clusters stacked on a leading [J] axis."""

    J: int
    nrows: int
    members_j: List[int]
    c: Any
    B: Any
    classes: List[_DevClass]
    sa: Any = None
    sC: Any = None
    smask: Any = None
    s_nb: int = 0
    s_nreal: int = 0
    row_shard: bool = False      # row-panel sharding over comm's ranks
    nw: int = 5
    device: Any = None
    dtype: Any = F32
    layout: List[List[Tuple[int, int]]] = None
    jmask: Any = None            # [J]: 1 a real cluster, 0 mesh padding
    J_full: int = 0              # J with padding, before any sharding
    comm: Any = None             # parallel.comm.Comm of a sharded solve
    shard_j: bool = False        # [J] split by rank (J is local)
    shard_bs: bool = False       # [Bs] split by rank (s_nb is local)
    s_lo: int = 0                # first scalar block of this rank
    B_full: Any = None           # all clusters' B (shard_j)
    sa_full: Any = None          # all scalar blocks' sa (shard_bs)


def _col(v):
    return tuple(c[:, None] for c in v)


def _col0(m):
    return tuple(c[:, 0] for c in m)


def _group_lowrank(blocks):
    """Greedy size-classing (clrs_tpu/solver/step.py:262-273)."""
    order = sorted(blocks, key=lambda t: -t[1].n)
    classes = []
    for l, bd in order:
        if classes and bd.n >= 0.7 * classes[-1][0][1].n:
            classes[-1].append((l, bd))
        else:
            classes.append([(l, bd)])
    return classes


def _pad2(arr, shape):
    out = np.zeros(shape, dtype=arr.dtype)
    out[tuple(slice(0, s) for s in arr.shape)] = arr
    return out


def _pad_dd(ws, shape):
    return tuple(_pad2(np.asarray(c), shape) for c in ws)


# element budget of the one-shot [L,P,T,P,T] Schur pair path
_SCHUR_T1_BATCH_BUDGET = 2 ** 22


class DeviceSDP:
    """Device-resident constants of a compiled SDP as nw-word expansions of
    ``dtype`` on ``device`` (clrs_tpu/solver/step.py:286-621): f32 words
    (the substrate of the kernels, with the limb forms of the constant
    GEMM operands precomputed) or f64 words (the IEEE substrate, no
    precompute). ``mesh_divisor=d`` pads the cluster, class and
    scalar-pack axes for a mesh of d ranks with inert fake clusters and
    blocks (:mod:`clrs_tpu_torch.parallel`)."""

    @tracing.timed("compile.device_sdp")
    def __init__(self, sdp: ClusteredLowRankSDP, nw: int = 5,
                 device=DEFAULT_DEVICE, dtype=F32, mesh_divisor: int = 1):
        if dtype not in (F32, F64):
            raise ValueError(f"expansion words are float32 or float64, "
                             f"got {dtype}")
        self.nw = nw
        self.dtype = dtype
        self.device = dev = resolve_device(device)
        _dd = lambda a: _w(a, nw, dev, dtype)  # noqa: E731
        _t = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
        self.maximize = sdp.maximize
        self.sign = 1.0 if sdp.maximize else -1.0
        self.constant = _w((np.float64(sdp.constant.hi),
                            np.float64(sdp.constant.lo)), nw, dev, dtype)
        self.b = _dd(sdp.b)
        self.nfree = sdp.nfree
        # the mesh's collectives (parallel.api.shard_device_sdp and
        # enable_row_sharding set them; None: one process)
        self.comm = None
        self.row_comm = None
        d = max(1, int(mesh_divisor))

        protos = []
        for cl in sdp.clusters:
            P = cl.nrows
            lowrank = [(l, bd) for l, bd in enumerate(cl.blocks)
                       if bd.kind == "lowrank"]
            dense = [(l, bd) for l, bd in enumerate(cl.blocks)
                     if bd.kind != "lowrank"]
            layout = [None] * len(cl.blocks)
            classes = []
            for group in _group_lowrank(lowrank):
                Lb = len(group)
                n = max(bd.n for _, bd in group)
                m = max(bd.V[0].shape[1] for _, bd in group)
                T = max(bd.li.shape[1] for _, bd in group)
                Cs, Vs, lams, lis, ris, tms = [], [], [], [], [], []
                maskd = np.zeros((Lb, n, n))
                maskdiag = np.zeros((Lb, n))
                members = []
                for i, (l, bd) in enumerate(group):
                    layout[l] = (len(classes), i)
                    members.append((l, bd.n))
                    Cs.append(_pad_dd(bd.C, (n, n)))
                    Vs.append(_pad_dd(bd.V, (n, m)))
                    lams.append(_pad_dd(bd.lam, (P, T)))
                    lis.append(_pad2(np.asarray(bd.li), (P, T)))
                    ris.append(_pad2(np.asarray(bd.ri), (P, T)))
                    tms.append(_pad2(np.asarray(bd.tmask), (P, T)))
                    maskd[i, :bd.n, :bd.n] = 1.0
                    maskdiag[i, :bd.n] = 1.0
                stack = lambda ws: tuple(np.stack([w[k] for w in ws])  # noqa: E731
                                         for k in range(len(ws[0])))
                classes.append(dict(
                    kind="lowrank", Lc=Lb, n=n, m=m, T=T, members=members,
                    C=stack(Cs), V=stack(Vs), lam=stack(lams),
                    li=np.stack(lis).astype(np.int32),
                    ri=np.stack(ris).astype(np.int32),
                    tm=np.stack(tms), maskd=maskd, maskdiag=maskdiag))
            bysize = {}
            for l, bd in dense:
                bysize.setdefault(bd.n, []).append((l, bd))
            for n, group in sorted(bysize.items()):
                Lb = len(group)
                members = []
                Cs, As = [], []
                for i, (l, bd) in enumerate(group):
                    layout[l] = (len(classes), i)
                    members.append((l, n))
                    Cs.append(tuple(np.asarray(w) for w in bd.C))
                    As.append(tuple(np.asarray(w) for w in bd.A))
                stack = lambda ws: tuple(np.stack([w[k] for w in ws])  # noqa: E731
                                         for k in range(len(ws[0])))
                classes.append(dict(
                    kind="dense", Lc=Lb, n=n, members=members,
                    C=stack(Cs), A=stack(As),
                    maskd=np.ones((Lb, n, n)), maskdiag=np.ones((Lb, n))))
            protos.append(dict(
                P=P, layout=layout, classes=classes,
                c=tuple(np.asarray(w) for w in cl.c),
                B=tuple(np.asarray(w) for w in cl.B),
                scalars=cl.scalars))

        def _sig(pr):
            cs = tuple((k["kind"], k["Lc"], k["n"], k.get("m", 0),
                        k.get("T", 0)) for k in pr["classes"])
            sc = pr["scalars"]
            return (pr["P"], cs, 0 if sc is None else sc.nblocks)

        groups: dict = {}
        for j, pr in enumerate(protos):
            groups.setdefault(_sig(pr), []).append(j)

        self.clusters = []
        self.cluster_of = {}
        for sig, js in groups.items():
            J = len(js)
            base = protos[js[0]]
            P = base["P"]
            # inert padding for a mesh of d (clrs_tpu/solver/step.py:
            # 397-441): fake all-zero clusters pad [J] to a multiple of d;
            # where [J] stays unshardable, fake masked blocks pad each
            # cluster's Lc so that J * Lc divides by d, and the scalar pack
            # is padded at its end
            Jp = J if (d <= 1 or J < d) else -(-J // d) * d

            def _pad_lc(Lc):
                if d <= 1 or Jp % d == 0:
                    return Lc
                Lcp = Lc
                while (Jp * Lcp) % d:
                    Lcp += 1
                return Lcp

            for jslot, j in enumerate(js):
                self.cluster_of[j] = (len(self.clusters), jslot)
            classes = []
            for ki in range(len(base["classes"])):
                prs = [protos[j]["classes"][ki] for j in js]
                k0 = prs[0]
                Lc, n = k0["Lc"], k0["n"]
                Lcp = _pad_lc(Lc)
                members = [(j, l, rn) for j, pk in zip(js, prs)
                           for (l, rn) in pk["members"]]

                def cat(key, words=True):
                    parts = []
                    for pk in prs:
                        a = pk[key]
                        a = (tuple(_pad2(np.asarray(w), (Lcp,) + w.shape[1:])
                                   for w in a) if words
                             else _pad2(np.asarray(a),
                                        (Lcp,) + np.asarray(a).shape[1:]))
                        parts.append(a)
                    fake = (tuple(np.zeros_like(w) for w in parts[0]) if words
                            else np.zeros_like(parts[0]))
                    parts += [fake] * (Jp - J)
                    if words:
                        return tuple(np.concatenate([p[w] for p in parts])
                                     for w in range(len(parts[0])))
                    return np.concatenate(parts)

                common = dict(
                    kind=k0["kind"], L=Jp * Lcp, Lc=Lcp, n=n, members=members,
                    C=_dd(cat("C")),
                    maskd=_t(cat("maskd", words=False)).to(dtype),
                    maskdiag=_t(cat("maskdiag", words=False)).to(dtype))
                if k0["kind"] == "lowrank":
                    li = cat("li", words=False).astype(np.int32)
                    ri = cat("ri", words=False).astype(np.int32)
                    tm = cat("tm", words=False)
                    Vw = cat("V")
                    T = k0["T"]
                    # gathered term columns Ul[i, p*T+t, :] = tmask * V[:, li]
                    Ul, Ur = [], []
                    for wword in Vw:
                        wl = np.zeros((Jp * Lcp, P * T, n))
                        wr = np.zeros((Jp * Lcp, P * T, n))
                        for i in range(Jp * Lcp):
                            wl[i] = wword[i].T[li[i].reshape(-1)] * \
                                tm[i].reshape(-1)[:, None]
                            wr[i] = wword[i].T[ri[i].reshape(-1)] * \
                                tm[i].reshape(-1)[:, None]
                        Ul.append(wl)
                        Ur.append(wr)
                    # lam-weighted term tables of the gather-free pair path
                    # (exact host double-word products)
                    lamw = cat("lam")
                    lam3 = tuple(w.reshape(w.shape[0], -1, 1) for w in lamw)
                    Ulww = host_core.dd_mul(lam3, tuple(Ul))
                    Urww = host_core.dd_mul(lam3, tuple(Ur))
                    common.update(
                        V=_dd(Vw), lam=_dd(lamw),
                        li=_t(li).long(), ri=_t(ri).long(),
                        tmask=_t(tm).to(dtype),
                        Ul=_dd(tuple(Ul)), Ur=_dd(tuple(Ur)),
                        Ulw=_dd(Ulww), Urw=_dd(Urww),
                        use_pairs=(Jp * Lcp) * (P * T) ** 2
                        <= _SCHUR_T1_BATCH_BUDGET)
                else:
                    common.update(A=_dd(cat("A")))
                classes.append(_DevClass(**common))

            def stackj(key):
                parts = [tuple(np.asarray(w) for w in protos[j][key])
                         for j in js]
                parts += [tuple(np.zeros_like(w) for w in parts[0])] * (Jp - J)
                return tuple(np.stack([p[w] for p in parts])
                             for w in range(len(parts[0])))

            layout = [protos[j]["layout"] for j in js]
            Lcs = [k.Lc for k in classes]
            layout = [[(ki, jslot * Lcs[ki] + slot) for (ki, slot) in lay]
                      for jslot, lay in enumerate(layout)]
            jmask = np.zeros(Jp)
            jmask[:J] = 1.0
            dc = _DevCluster(J=Jp, nrows=P, members_j=list(js),
                             c=_dd(stackj("c")), B=_dd(stackj("B")),
                             classes=classes, nw=nw, device=dev,
                             dtype=dtype, layout=layout,
                             jmask=_t(jmask).to(dtype), J_full=Jp)
            scs = [protos[j]["scalars"] for j in js]
            if scs[0] is not None:
                Bs = scs[0].nblocks
                Bsp = Bs if d <= 1 or Jp % d == 0 else -(-Bs // d) * d

                def scat(key, words=True):
                    parts = []
                    for sc in scs:
                        a = getattr(sc, key)
                        if words:
                            a = tuple(_pad2(np.asarray(w), (Bsp,)
                                            + np.asarray(w).shape[1:])
                                      for w in a)
                        else:
                            a = _pad2(np.asarray(a), (Bsp,))
                        parts.append(a)
                    fake = (tuple(np.zeros_like(w) for w in parts[0]) if words
                            else np.zeros_like(parts[0]))
                    parts += [fake] * (Jp - J)
                    if words:
                        return tuple(np.stack([p[w] for p in parts])
                                     for w in range(len(parts[0])))
                    return np.stack(parts)

                dc.sa = _dd(scat("a"))
                dc.sC = _dd(scat("C"))
                dc.smask = _t(scat("mask", words=False)).to(dtype)
                dc.s_nb = Bsp
                dc.s_nreal = sum(sc.nreal for sc in scs)
            self.clusters.append(dc)
        self.total_size = sum(rn for cl in self.clusters for k in cl.classes
                              for _, _, rn in k.members) \
            + sum(cl.s_nreal for cl in self.clusters)
        self.total_rows = sum(len(cl.members_j) * cl.nrows
                              for cl in self.clusters)
        if dtype == F32:
            self._precompute_limb_forms()

    def _precompute_limb_forms(self):
        """Host-extract the limb forms of the constant GEMM operands (V
        panels, the U term tables): bit-identical to the device extraction
        (limb_gemm.host_precompute), done once per solve."""
        nw, dev = self.nw, self.device

        def _dev(lb, eb):
            return (torch.from_numpy(lb).to(dev), torch.from_numpy(eb).to(dev))

        def _stackpre(mats, axis):
            ls, es = [], []
            for ws in mats:
                lb, eb = host_precompute(ws, nw, axis=axis)
                ls.append(lb)
                es.append(eb)
            return _dev(np.stack(ls), np.stack(es))

        for cl in self.clusters:
            for k in cl.classes:
                if k.kind != "lowrank":
                    continue
                if not k.use_pairs:
                    Vw = [c.cpu().numpy() for c in k.V]
                    lr, er, lt, et = [], [], [], []
                    for l in range(k.L):
                        lb, eb = host_precompute([w[l] for w in Vw], nw,
                                                 axis=0)
                        lr.append(lb)
                        er.append(eb)
                        la, ea = host_precompute([w[l].T for w in Vw], nw,
                                                 axis=1)
                        lt.append(la)
                        et.append(ea)
                    lr, er = np.stack(lr), np.stack(er)
                    lt, et = np.stack(lt), np.stack(et)
                    k.Vpre_r = _dev(lr, er)
                    k.Vtpre_l = _dev(lt, et)
                    k.V2pre_r = _dev(np.concatenate([lr, lr]),
                                     np.concatenate([er, er]))
                    k.V2tpre_l = _dev(np.concatenate([lt, lt]),
                                      np.concatenate([et, et]))
                Uw = [c.cpu().numpy() for c in k.Ur]
                k.Urpre_r = _stackpre([[w[l] for w in Uw]
                                       for l in range(k.L)], axis=0)
                Ulw_ = [c.cpu().numpy() for c in k.Ulw]
                Ul_ = [c.cpu().numpy() for c in k.Ul]
                Urw_ = [c.cpu().numpy() for c in k.Urw]
                k.U2pre_l = _stackpre(
                    [[w[l] for w in Ulw_] for l in range(k.L)]
                    + [[w[l] for w in Ul_] for l in range(k.L)], axis=1)
                k.U2tpre_r = _stackpre(
                    [[w[l].T for w in Urw_] for l in range(k.L)]
                    + [[w[l].T for w in Uw] for l in range(k.L)], axis=0)
                k.Ulpre_l = (k.U2pre_l[0][k.L:], k.U2pre_l[1][k.L:])


def initial_state(ds: DeviceSDP, omega_p: float, omega_d: float):
    """x=0, X=omega_p*I, y=0, Y=omega_d*I; padded diagonal entries at 1."""
    nw, dev, dt = ds.nw, ds.device, ds.dtype

    def eyes(k, omega):
        dv = omega * k.maskdiag + (1.0 - k.maskdiag)
        w0 = torch.eye(k.n, dtype=dt, device=dev) * dv[:, None, :]
        return (w0,) + tuple(torch.zeros_like(w0) for _ in range(nw - 1))

    def ones(shape, v):
        return torch.full(shape, float(v), dtype=dt, device=dev)

    x = [dl.dd_zeros((cl.J, cl.nrows), nw, dev, dt) for cl in ds.clusters]
    y = dl.dd_zeros((ds.nfree,), nw, dev, dt)
    X = [[eyes(k, omega_p) for k in cl.classes] for cl in ds.clusters]
    Y = [[eyes(k, omega_d) for k in cl.classes] for cl in ds.clusters]
    Xs = [_scalar(ones((cl.J, cl.s_nb), omega_p), nw) for cl in ds.clusters]
    Ys = [_scalar(ones((cl.J, cl.s_nb), omega_d), nw) for cl in ds.clusters]
    return {"x": x, "y": y, "X": X, "Y": Y, "Xs": Xs, "Ys": Ys}


# ---------------------------------------------------------------------------
# core operators (batched over the class [L] axis)
# ---------------------------------------------------------------------------

def _panels_xy(k: _DevClass, Xb, Yb):
    """V^T X^-1 V and V^T Y V as one [2L]-stacked batched GEMM pair."""
    M2 = _cat(Xb, Yb)
    if k.V2pre_r is not None:
        MV = _bmm_pre_r(M2, k.V2pre_r)
        P2 = _bmm_pre_l(MV, k.V2tpre_l, len(M2))
    else:
        V2 = _cat(k.V, k.V)
        MV = _bmm(M2, V2)
        P2 = _bmm(dl.dd_transpose(V2), MV)
    return (tuple(c[:k.L] for c in P2), tuple(c[k.L:] for c in P2))


def _pairs_xy(k: _DevClass, Xb, Yb):
    """Gather-free pairings GXw = (lam Ul) X^-1 (lam Ur)^T and
    GY = Ul Y Ur^T [L, PT, PT], as one [2L] batched GEMM pair."""
    M2 = _cat(Xb, Yb)
    if k.U2pre_l is not None:
        UM = _bmm_pre_l(M2, k.U2pre_l, len(M2))
        G2 = _bmm_pre_r(UM, k.U2tpre_r)
    else:
        U_l = _cat(k.Ulw, k.Ul)
        U_rt = _cat(dl.dd_transpose(k.Urw), dl.dd_transpose(k.Ur))
        UM = _bmm(U_l, M2)
        G2 = _bmm(UM, U_rt)
    return (tuple(c[:k.L] for c in G2), tuple(c[k.L:] for c in G2))


def _gather_b(PM, li, ri):
    """PM[l, li[l,p,t], ri[l,p,t]] -> [L, P, T]."""
    L = li.shape[0]
    lidx = torch.arange(L, device=li.device)[:, None, None]
    return tuple(c[lidx, li, ri] for c in PM)


def _trace_A_cluster(cl: _DevCluster, Zs, Zsc, panels=None):
    """[<A_p, Z>]_p -> [J, P] words for all rows of a cluster group."""
    J, P = cl.J, cl.nrows
    tot = dl.dd_zeros((J, P), cl.nw, cl.device, cl.dtype)
    for ki, (k, Z) in enumerate(zip(cl.classes, Zs)):
        if k.kind == "lowrank":
            L, P_, T = k.li.shape
            have_panel = panels is not None and panels[ki] is not None
            if have_panel and k.use_pairs:
                pan = panels[ki]
                if isinstance(pan[0], str):           # ("diag", dgy [L, PT])
                    g = tuple(c.reshape(L, P_, T) for c in pan[1])
                else:                                 # GY [L, PT, PT]
                    g = tuple(torch.diagonal(c, dim1=1, dim2=2)
                              .reshape(L, P_, T) for c in pan)
                mask = None                           # tmask already in U
            elif have_panel:
                g = _gather_b(panels[ki], k.li, k.ri)
                mask = k.tmask
            else:
                # Hadamard: <A_p, Z> = sum_t lam (Ul Z)[pt,:] . Ur[pt,:]
                if k.Ulpre_l is not None:
                    UZ = _bmm_pre_l(Z, k.Ulpre_l, cl.nw)
                else:
                    UZ = _bmm(k.Ul, Z)
                h = dl.dd_sum_prod(UZ, k.Ur, 2)
                g = tuple(c.reshape(L, P_, T) for c in h)
                mask = None
            if k.shard and not cl.shard_j:      # gathered between
                v = dd_mul(k.lam, g)
                if mask is not None:
                    v = _dd_scale(v, mask)
                v = _class_terms(cl, k, v)
                s = dl.dd_sum(tuple(c.movedim(1, 2).reshape(J, -1, P)
                                    for c in v), axis=1)
                tot = dd_add(tot, s)
            else:
                # the same sum over each cluster's (block, t) entries, one
                # launch: [L, P, T] viewed as [J, P, Lc, T]
                def jp(x):
                    return tuple(c.reshape(J, -1, P_, T).movedim(2, 1)
                                 for c in x)
                tot = dl.dd_sum_prod(jp(k.lam), jp(g), (2, 3), tot,
                                     scale=None if mask is None
                                     else jp((mask,))[0],
                                     scale_on="product")
        elif k.shard and not cl.shard_j:
            prod = _class_terms(cl, k, dd_mul(k.A, tuple(c[:, None]
                                                         for c in Z)))
            flat = tuple(c.reshape(J, k.Lc, P, k.n, k.n).movedim(2, 1)
                         .reshape(J, P, -1) for c in prod)
            tot = dd_add(tot, dl.dd_sum(flat, axis=2))
        else:
            # [L, P, n, n] products viewed as [J, P, Lc, n, n], one launch
            A5 = tuple(c.reshape(J, k.Lc, P, k.n, k.n).movedim(2, 1)
                       for c in k.A)
            Z5 = tuple(c.reshape(J, k.Lc, 1, k.n, k.n).movedim(2, 1)
                       for c in Z)
            tot = dl.dd_sum_prod(A5, Z5, (2, 3, 4), tot)
    if cl.s_nb:
        sa = cl.sa
        if cl.shard_bs:
            Zsc, sa = cl.comm.all_gather(Zsc, 1), cl.sa_full
        r = _bmm(tuple(c[:, None, :] for c in Zsc), sa)
        tot = dd_add(tot, tuple(c[:, 0] for c in r))
    return tot


def _weighted_A_cluster(cl: _DevCluster, a):
    """sum_p a_p A_p per class + scalar pack; ``a`` is [J, P] words."""
    out = []
    for k in cl.classes:
        # a's rows repeated for each of a cluster's blocks: [L, P]
        ab = tuple(torch.repeat_interleave(c, k.Lc, dim=0) for c in a)
        if k.shard and not cl.shard_j:
            ab = tuple(c[k.lo:k.lo + k.L] for c in ab)
        if k.kind == "lowrank":
            L, P, T = k.li.shape
            ab = tuple(c[:, :, None] for c in ab)
            w = _dd_scale(dd_mul(k.lam, ab), k.tmask)
            wf = tuple(c.reshape(L, P * T, 1) for c in w)
            wUl = dd_mul(wf, k.Ul)                              # [L, PT, n]
            if k.Urpre_r is not None:
                out.append(_bmm_pre_r(dl.dd_transpose(wUl), k.Urpre_r))
            else:
                out.append(_bmm(dl.dd_transpose(wUl), k.Ur))
        else:
            ab = tuple(c[:, :, None, None] for c in ab)
            out.append(dl.dd_sum_prod(k.A, ab, 1))
    if cl.s_nb:
        sa = cl.sa_full if cl.shard_bs else cl.sa
        r = _bmm(sa, tuple(c[:, :, None] for c in a))
        out_s = tuple(c[:, :, 0] for c in r)
        if cl.shard_bs:
            out_s = tuple(c[:, cl.s_lo:cl.s_lo + cl.s_nb] for c in out_s)
    else:
        out_s = dl.dd_zeros((cl.J, 0), cl.nw, cl.device, cl.dtype)
    return out, out_s


def _schur_cluster(cl: _DevCluster, Xinvs, Ys, Xinv_s, Y_s, panels=None):
    """S^j (upper triangle mirrored), solver.jl:1062-1226."""
    J, P = cl.J, cl.nrows
    S = dl.dd_zeros((J, P, P), cl.nw, cl.device, cl.dtype)
    for ki, (k, Xinv, Y) in enumerate(zip(cl.classes, Xinvs, Ys)):
        if k.kind == "lowrank":
            L, P_, T = k.li.shape
            if k.use_pairs:
                if panels is not None and panels[ki] is not None:
                    GXw, GY = panels[ki]
                else:
                    GXw, GY = _pairs_xy(k, Xinv, Y)
                gx5 = tuple(c.reshape(L, P_, T, P_, T) for c in GXw)
                gy5 = tuple(c.transpose(1, 2).reshape(L, P_, T, P_, T)
                            for c in GY)
                inner = dl.dd_sum_prod(tuple(c.movedim(2, 3) for c in gx5),
                                       tuple(c.movedim(2, 3) for c in gy5),
                                       (3, 4))
                contrib = _class_terms(cl, k, inner)
                S = dl.dd_sum_prod(tuple(c.reshape(J, k.Lc, P, P)
                                         for c in contrib), None, 1, S)
                continue
            if panels is not None and panels[ki] is not None:
                PX, PY = panels[ki]
            else:
                PX, PY = _panels_xy(k, Xinv, Y)
            PYT = dl.dd_transpose(PY)
            lidx = torch.arange(L, device=cl.device)[:, None, None, None]
            li2 = k.li[:, None, :, :]
            ri2 = k.ri[:, None, :, :]
            lam2 = tuple(c[:, None, :, :] for c in k.lam)
            m2 = k.tmask[:, None, :, :]
            contrib = None
            for t1 in range(T):
                li1 = k.li[:, :, t1, None, None]
                ri1 = k.ri[:, :, t1, None, None]
                gx = tuple(c[lidx, li1, ri2] for c in PX)
                gy = tuple(c[lidx, ri1, li2] for c in PYT)
                inner = dl.dd_sum_prod(
                    lam2, dd_mul(gx, gy), 3,
                    scale=m2 * k.tmask[:, :, t1, None, None],
                    scale_on="product")
                lam1 = tuple(c[:, :, t1, None] for c in k.lam)
                contrib = (dd_mul(lam1, inner) if contrib is None
                           else dd_fma(contrib, lam1, inner))
            contrib = _class_terms(cl, k, contrib)
            S = dl.dd_sum_prod(tuple(c.reshape(J, k.Lc, P, P)
                                     for c in contrib), None, 1, S)
        else:
            LP = k.L * P
            Af = tuple(c.reshape(LP, k.n, k.n) for c in k.A)
            Xr = tuple(torch.repeat_interleave(c, P, dim=0) for c in Xinv)
            Yr = tuple(torch.repeat_interleave(c, P, dim=0) for c in Y)
            XAY = _bmm(_bmm(Xr, Af), Yr)
            XAYb = tuple(c.reshape(k.L, P, k.n, k.n) for c in XAY)
            inner = dl.dd_sum_prod(tuple(c[:, :, None] for c in k.A),
                                   tuple(c[:, None] for c in XAYb), (3, 4))
            terms = _class_terms(cl, k, inner)
            S = dl.dd_sum_prod(tuple(c.reshape(J, k.Lc, P, P)
                                     for c in terms), None, 1, S)
    if cl.s_nb:
        w = dd_mul(Xinv_s, Y_s)
        sa = cl.sa
        if cl.shard_bs:
            w, sa = cl.comm.all_gather(w, 1), cl.sa_full
        t = dd_mul(sa, tuple(c[:, :, None] for c in w))
        S = dd_add(S, _bmm(dl.dd_transpose(sa), t))
    if len(cl.members_j) < cl.J_full:
        # fake padding clusters carry S = I so chol(S) stays well-posed
        # (clrs_tpu/solver/step.py:984-986)
        S = (S[0] + (1.0 - cl.jmask)[:, None, None]
             * torch.eye(P, dtype=S[0].dtype, device=cl.device),) + S[1:]
    # keep the upper triangle, mirror it (reference: symmetric!(S))
    iu = torch.triu(torch.ones((P, P), dtype=torch.bool, device=cl.device))
    return tuple(torch.where(iu, c, c.transpose(-1, -2)) for c in S)


def _dist_schur_region(cl, Xinv_cls, Y_cls, Xinv_s, Y_s):
    """Row-panel Schur + chol(S) + L^-1 B of a single-cluster group
    (cl.J == 1) over cl.comm's ranks (clrs_tpu/solver/step.py:813-873).
    Returns (("dist", L_loc [Pl, P]), LinvB [1, P, F] replicated, diag(GY)
    per class [L, PT] replicated, ok)."""
    from ..parallel import bigcluster as bc

    cm, P = cl.comm, cl.nrows
    nb = bc.row_nb(P, cm.size)
    S_loc, dgys = None, []
    for k, Xi, Yb in zip(cl.classes, Xinv_cls, Y_cls):
        S_k, dgy_loc = bc.dist_pairs_schur(k, cm.local_rows(k.Ulw, 1),
                                           cm.local_rows(k.Ur, 1), Xi, Yb, cm)
        S_loc = S_k if S_loc is None else dd_add(S_loc, S_k)
        dgys.append(cm.all_gather(dgy_loc, 1))
    if cl.s_nb:
        w = dd_mul(Xinv_s, Y_s)                      # [1, Bs]
        S_loc = dd_add(S_loc, bc.dist_scalar_schur_rows(
            tuple(c[0] for c in cl.sa), tuple(c[0] for c in w), cm,
            P // cm.size))
    L_loc, ok = bc.dist_cholesky(S_loc, P, cm, nb)
    LinvB = bc.dist_solve_tril(L_loc, tuple(c[0] for c in cl.B), P, cm, nb)
    return ("dist", L_loc), tuple(c[None] for c in LinvB), dgys, ok


def _dist_solve(cl, cholS, rhs, transpose=False):
    """L X = rhs (or L^T X = rhs) with the row-sharded factor of
    :func:`_dist_schur_region`; rhs [1, P, m] replicated
    (clrs_tpu/solver/step.py:876-898)."""
    from ..parallel import bigcluster as bc

    cm, P = cl.comm, cl.nrows
    solve = bc.dist_solve_tril_t if transpose else bc.dist_solve_tril
    out = solve(cholS[1], tuple(c[0] for c in rhs), P, cm,
                bc.row_nb(P, cm.size))
    return tuple(c[None] for c in out)


def _dot_state(ds, A, B):
    tot = _scalar(torch.zeros((), dtype=ds.dtype, device=ds.device), ds.nw)
    for j, cl in enumerate(ds.clusters):
        for k, Xb, Yb in zip(cl.classes, A["X"][j], B["Y"][j]):
            tot = _dot(cl, Xb, Yb, 0 if k.shard else None, tot, k.maskd)
        if cl.s_nb:
            tot = _dot(cl, A["Xs"][j], B["Ys"][j], _s_axis(cl), tot,
                       cl.smask)
    return tot


def _max_abs_all(ds, Ms, Ms_s):
    """max |M| over the blocks, each block's max folded into the last
    (maximum(0, m) is m for an m >= 0 or NaN, so the first needs none)."""
    v = None
    for Mb in [Mb for Mc in Ms for Mb in Mc] + [
            Mb for Mb in Ms_s if Mb[0].shape[0]]:
        v = dl.dd_max_abs(Mb, v)
    return torch.zeros((), dtype=F64, device=ds.device) if v is None else v


def _residuals(ds: DeviceSDP, state, panelsY=None):
    """P = sum_i x_i A_i - X - sign*C;  d = c - <A_*,Y> - By;
    p = sign*b - B^T x  (solver.jl:882-918); P masked to the real area."""
    x, y = state["x"], state["y"]
    Pres, Pres_s, dres = [], [], []
    for j, cl in enumerate(ds.clusters):
        wA, wA_s = _weighted_A_cluster(cl, x[j])
        Pres.append([dd_sub2(wA[ki], state["X"][j][ki], k.C, ds.sign,
                             k.maskd)
                     for ki, k in enumerate(cl.classes)])
        if cl.s_nb:
            Pres_s.append(dd_sub2(wA_s, state["Xs"][j], cl.sC, ds.sign,
                                  cl.smask))
        else:
            Pres_s.append(dl.dd_zeros((cl.J, 0), ds.nw, ds.device,
                                      ds.dtype))
        yb = tuple(c[None, :, None].expand(cl.J, c.shape[0], 1) for c in y)
        By = _bmm(cl.B, yb)
        d_j = dd_sub2(cl.c, tuple(c[:, :, 0] for c in By),
                      _trace_A_cluster(cl, state["Y"][j], state["Ys"][j],
                                       panels=None if panelsY is None
                                       else panelsY[j]))
        dres.append(d_j)
    pres = _dd_scale(ds.b, ds.sign)
    for j, cl in enumerate(ds.clusters):
        B, xj = cl.B, x[j]
        if cl.shard_j:
            B, xj = cl.B_full, cl.comm.all_gather(xj, 0)
        J, P, F = B[0].shape
        Bf = tuple(c.reshape(J * P, F) for c in B)
        xf = tuple(c.reshape(J * P, 1) for c in xj)
        Btx = dl.dd_matmul(dl.dd_transpose(Bf), xf)
        pres = dd_sub(pres, _col0(Btx))
    return Pres, Pres_s, pres, dres


def _objectives(ds: DeviceSDP, state):
    x, y = state["x"], state["y"]
    zero = torch.zeros((), dtype=ds.dtype, device=ds.device)
    dot_cx = _scalar(zero, ds.nw)
    for j, cl in enumerate(ds.clusters):
        dot_cx = _dot(cl, cl.c, x[j], 0 if cl.shard_j else None, dot_cx)
    d_obj = dd_add(_dd_scale(dot_cx, ds.sign), ds.constant)
    CY = _scalar(zero, ds.nw)
    for j, cl in enumerate(ds.clusters):
        for k, Yb in zip(cl.classes, state["Y"][j]):
            # C is zero on padding
            CY = _dot(cl, k.C, Yb, 0 if k.shard else None, CY)
        if cl.s_nb:
            CY = _dot(cl, cl.sC, state["Ys"][j], _s_axis(cl), CY)
    p_obj = dd_add(dl.dd_dot(ds.b, y, CY), ds.constant)
    diff = dd_sub(d_obj, p_obj)
    gap_num = _f64sum(diff).abs()
    d64, p64 = _f64sum(d_obj), _f64sum(p_obj)
    denom = torch.clamp((d64 + p64).abs(), min=1.0)
    return d64, p64, gap_num / denom


def _errors(ds, Pres, Pres_s, pres, dres):
    """P_error = max |P|, p_error = max |p|, primal error = max |d|;
    dual_error = max(P_error, p_error) (solver.jl:806-847)."""
    P_error = _max_abs_all(ds, Pres, Pres_s)
    p_error = dl.dd_max_abs(pres)
    primal_error = None
    for d_j in dres:
        primal_error = dl.dd_max_abs(d_j, primal_error)
    if primal_error is None:
        primal_error = torch.zeros((), dtype=F64, device=ds.device)
    if ds.comm is not None:
        P_error = ds.comm.all_max(P_error)
        primal_error = ds.comm.all_max(primal_error)
    dual_error = torch.maximum(P_error, p_error)
    return dual_error, primal_error, P_error, p_error


def _eig_input(W2):
    """The eigensolver's input from L^-1 dM L^-T words [2L, n, n]: the f64
    sum of the words, symmetrized, with every member that holds a NaN or
    an Inf (a failed Cholesky leaves NaNs past its pivot) set to zero, so
    that the eigensolver sees finite matrices only (the card's kernels
    take nothing else, and PyTorch raises on LAPACK's info for a NaN
    member). Returns (matrices, bad [2L]). LAPACK (the JAX package's
    eigvalsh) returns NaN for such a member, which :func:`_step_lengths`
    puts back."""
    A64 = _f64sum(W2)
    A64 = 0.5 * (A64 + A64.transpose(-1, -2))
    bad = ~torch.isfinite(A64).all(dim=-1).all(dim=-1)
    return torch.where(bad[:, None, None], 0.0, A64), bad


def eig_lowest(mats):
    """Lowest eigenvalue of each member of each float64 matrix batch (the
    JAX package's off-TPU route, ``jnp.linalg.eigvalsh``,
    clrs_tpu/solver/step.py:1146-1166): on the card one ``eig_lowest``
    kernel launch a batch (:func:`clrs_tpu_torch.dd.kernels.eig_lowest`),
    which reads nothing back to the host, so the step's graph holds it;
    on the CPU LAPACK's ``torch.linalg.eigvalsh``. Nothing falls back: a
    kernel that does not build or launch raises."""
    return [dk.eig_lowest(A) if A.is_cuda else torch.linalg.eigvalsh(A)[:, 0]
            for A in mats]


# The step-length route (clrs_tpu/solver/step.py:1083-1093): None picks as
# the JAX package does off a TPU, the float64 eigvalsh route; True takes
# the JAX package's TPU route on f32 words, f32 eigenpairs certified with
# exact limb GEMMs. Tests and chip_smoke.py set it, as the JAX package's
# tests set its own.
_STEPLEN_VERIFIED = None


def _use_verified_eig():
    if _STEPLEN_VERIFIED is not None:
        return _STEPLEN_VERIFIED
    return False        # the port runs on no TPU


def _eig_input_f32(W2):
    """The certified route's eigensolver input (clrs_tpu/solver/step.py:
    1124-1127): the words of W2 summed in f32 in the JAX order and
    symmetrized, with every member that is not finite set to zero, as
    :func:`_eig_input` does. Returns (matrices, bad [2L])."""
    A32 = W2[0]
    for c in W2[1:]:
        A32 = A32 + c
    A32 = 0.5 * (A32 + A32.transpose(-1, -2))
    bad = ~torch.isfinite(A32).all(dim=-1).all(dim=-1)
    return torch.where(bad[:, None, None], 0.0, A32), bad


def eig_pairs(mats):
    """f32 eigenpairs (ascending eigenvalues [B, n], eigenvectors as
    columns [B, n, n]) of each matrix batch: the certified route's
    candidate decompositions (``jnp.linalg.eigh`` in the JAX package's TPU
    step, clrs_tpu/solver/step.py:1123). On the card one ``eig_pairs``
    Jacobi kernel launch a batch
    (:func:`clrs_tpu_torch.dd.kernels.eig_pairs`), inside the step's
    graph; on the CPU LAPACK's ``torch.linalg.eigh``."""
    return [dk.eig_pairs(A) if A.is_cuda else tuple(torch.linalg.eigh(A))
            for A in mats]


def step_eig(mats):
    """The eigensolver between a step's head and tail: the certified
    route's f32 eigenpairs for f32 matrices, else the lowest eigenvalues."""
    if mats and mats[0].dtype == F32:
        return eig_pairs(mats)
    return eig_lowest(mats)


def _eig_lo_certified(W2, lam, V):
    """Certified lower bound on the lowest eigenvalue of each member of the
    symmetrized W2 [2L, n, n] from its f32 eigenpairs (lam, V)
    (clrs_tpu/solver/step.py:1096-1143, after its eigh): with
    E = A - V diag(lam) V^T and delta = ||V^T V - I||,
    lambda_min(A) >= lam_min - |lam_min| delta - ||E||_2. V diag(lam) is an
    exact two-word product, E and V^T V come from exact limb GEMMs (an
    nw-word by one-word product, and one-word operands into two words,
    batched under the route decision the JAX package's vmap makes per
    member), and both norms are bounded by Frobenius norms in f64."""
    nw = len(W2)
    lmin = lam[:, 0].to(F64)
    p, e = O.two_prod(V, lam[:, None, :])
    z = torch.zeros_like(p)
    VD = (p, e) + (z,) * (nw - 2)
    Vt = V.transpose(-1, -2)
    M = fx_matmul(VD, (Vt,))
    E = dd_sub(W2, M)
    Ev = _f64sum(E)
    eta = torch.sqrt((Ev * Ev).sum(dim=(-2, -1)))
    G = fx_matmul((Vt,), (V,), nw=2)
    G0 = G[0] - torch.eye(V.shape[-1], dtype=V.dtype, device=V.device)
    Gv = G0.to(F64) + G[1].to(F64)
    delta = torch.sqrt((Gv * Gv).sum(dim=(-2, -1)))
    slack = 1.0 + 1e-12                              # norm-evaluation margin
    return lmin - slack * (lmin.abs() * delta + eta)


def _step_mats(ds, dX, dY, cholX, cholY):
    """The head half of the step lengths (solver.jl:1618-1693): per
    non-scalar size class, the eigensolver's input for the X and Y sides
    as one [2L] batch, L^-1 dM L^-T with the factors of this iteration.
    Returns (matrices, bad masks, words), class by class; on the certified
    route (f32 words) the matrices are f32 and the words are each class's
    W2, which the tail certifies against; else the words are None."""
    verified = _use_verified_eig() and ds.dtype == F32
    mats, bads, words = [], [], [] if verified else None
    for j, cl in enumerate(ds.clusters):
        for ki, k in enumerate(cl.classes):
            if k.n == 1:
                continue
            L2 = _cat(cholX[j][ki], cholY[j][ki])
            W = dl.b_solve_tril(L2, _cat(dX[j][ki], dY[j][ki]))
            W2 = dl.b_solve_tril(L2, dl.dd_transpose(W))
            A, bad = (_eig_input_f32 if verified else _eig_input)(W2)
            mats.append(A)
            bads.append(bad)
            if verified:
                words.append(W2)
    return mats, bads, words


def _certify(words, lows, eig_safety):
    """The eigensolver's results as :func:`_step_lengths` takes them, with
    its eig_safety: on the certified route (``words``, the W2 of each class
    from :func:`_step_mats`) the certified bounds of the eigenpairs and
    None; else the lowest eigenvalues as they are and ``eig_safety``."""
    if words is None:
        return lows, eig_safety
    return [_eig_lo_certified(W2, lam, V)
            for W2, (lam, V) in zip(words, lows)], None


def _step_lengths(ds, state, dX, dXs, dY, dYs, lows, bads, gamma,
                  eig_safety, inf, one):
    """(alpha_d, alpha_p): longest steps keeping X + a dX and Y + a dY PSD.
    ``lows``/``bads`` are :func:`eig_lowest` and the masks of
    :func:`_step_mats`, class by class; the lower bound is the lowest
    eigenvalue less eig_safety * (1 + |lambda_min|), NaN for a member that
    was not finite. ``eig_safety=None``: ``lows`` are lower bounds already
    (the certified route's, :func:`_eig_lo_certified`, which the JAX
    package uses as they stand, clrs_tpu/solver/step.py:1150-1151)."""
    min_d, min_p = inf, inf
    lows, bads = iter(lows), iter(bads)

    def scalar_min(cur, Mb, dMb, mask):
        e = (_f64sum(tuple(c[:, 0, 0] for c in dMb))
             / _f64sum(tuple(c[:, 0, 0] for c in Mb)))
        e = torch.where(mask > 0, e, inf)
        return torch.minimum(cur, e.min())

    for j, cl in enumerate(ds.clusters):
        for ki, k in enumerate(cl.classes):
            if k.n == 1:
                Xb, Yb = state["X"][j][ki], state["Y"][j][ki]
                min_d = scalar_min(min_d, Xb, dX[j][ki], k.maskdiag[:, 0])
                min_p = scalar_min(min_p, Yb, dY[j][ki], k.maskdiag[:, 0])
                continue
            lam = next(lows)
            lo = lam if eig_safety is None else \
                lam - eig_safety * (1.0 + lam.abs())
            lo = torch.where(next(bads), float("nan"), lo)
            min_d = torch.minimum(min_d, lo[:k.L].min())
            min_p = torch.minimum(min_p, lo[k.L:].min())
        if cl.s_nb:
            e = _f64sum(dXs[j]) / _f64sum(state["Xs"][j])
            min_d = torch.minimum(min_d, torch.where(cl.smask > 0, e, inf).min())
            e = _f64sum(dYs[j]) / _f64sum(state["Ys"][j])
            min_p = torch.minimum(min_p, torch.where(cl.smask > 0, e, inf).min())
    if ds.comm is not None:
        min_d, min_p = ds.comm.all_min(min_d), ds.comm.all_min(min_p)
    # tensor by tensor, one IEEE division as the reference's -gamma / min_d:
    # a host float over a tensor is reciprocal() * float in PyTorch, two
    # roundings
    neg = torch.full_like(one, -gamma)
    return (torch.where(min_d > -gamma, one, neg / min_d),
            torch.where(min_p > -gamma, one, neg / min_p))


def _axpy_state(state, dx, dy, dX, dY, dXs, dYs, alpha_d, alpha_p,
                plmap=True):
    nw = len(state["y"])
    dt = state["y"][0].dtype
    ad = _scalar_split(alpha_d, nw, dt)
    ap = _scalar_split(alpha_p, nw, dt)
    if plmap:
        # the fused form: alpha as three words, padded inside the kernel
        # (clrs_tpu/solver/step.py:1244-1260)
        def fma(Mb, dMb, a):
            return dk.plmap_axpy(Mb, dMb, _bcast_words(a[:3], Mb[0].shape[0]))
    else:
        fma = dd_fma
    X = [[fma(Xb, dXb, ad) for Xb, dXb in zip(Xc, dXc)]
         for Xc, dXc in zip(state["X"], dX)]
    Y = [[fma(Yb, dYb, ap) for Yb, dYb in zip(Yc, dYc)]
         for Yc, dYc in zip(state["Y"], dY)]
    x = [dd_fma(xj, dxj, ad) for xj, dxj in zip(state["x"], dx)]
    y = dd_fma(state["y"], dy, ap)
    Xs = [dd_fma(a, b, ad) for a, b in zip(state["Xs"], dXs)]
    Ys = [dd_fma(a, b, ap) for a, b in zip(state["Ys"], dYs)]
    return {"x": x, "y": y, "X": X, "Y": Y, "Xs": Xs, "Ys": Ys}


# ---------------------------------------------------------------------------
# assess + step factories
# ---------------------------------------------------------------------------

def make_assess(ds: DeviceSDP):
    """state -> dict of float64 device scalars (errors, objectives, mu)."""

    def assess(state):
        Pres, Pres_s, pres, dres = _residuals(ds, state)
        dual_error, primal_error, P_error, p_error = _errors(
            ds, Pres, Pres_s, pres, dres)
        d_obj, p_obj, gap = _objectives(ds, state)
        K = torch.full((), float(ds.total_size), dtype=ds.dtype,
                       device=ds.device)
        mu_dd = dd_div(_dot_state(ds, state, state), _scalar(K, ds.nw))
        return {"dual_error": dual_error, "primal_error": primal_error,
                "P_error": P_error, "p_error": p_error,
                "d_obj": d_obj, "p_obj": p_obj,
                "dual_gap": gap, "mu": _f64sum(mu_dd)}

    return assess


def make_step_parts(ds: DeviceSDP, *, gamma: float, beta_feasible: float,
                    beta_infeasible: float, dual_error_threshold: float,
                    primal_error_threshold: float, safe_step: bool = True,
                    correctoronly: bool = False, eig_safety: float = 1e-12,
                    plmap: bool = True):
    """One iteration split at its eigensolver: ``head(state, pd_feas_prev)
    -> (mid, mats)`` runs up to the step-length matrices, :func:`step_eig`
    (mats) gives their lowest eigenvalues (or, on the certified route, their
    f32 eigenpairs, which the tail certifies), and ``tail(state, mid, lows) ->
    (new_state, info)`` runs the rest; info values are device tensors.
    ``pd_feas_prev`` is a bool tensor on the device. Neither half reads a
    device value on the host or copies host data to the device, so each
    can be captured in a CUDA graph (:func:`make_step`). ``plmap=False``
    runs the three elementwise chains as plain expansion ops instead of
    the chain kernels. The IPM phases are marked for the graph's timing
    events (:func:`clrs_tpu_torch.tracing.phase`)."""
    K = float(ds.total_size)
    nw = ds.nw
    dev = ds.device
    dt = ds.dtype
    # the chain kernels compute on f32 words; on f64 words the dispatching
    # ops compute R, the corrector sum and the update, as the JAX package
    # gates pl_map on f32 words (clrs_tpu/solver/step.py:1219-1229)
    plmap = plmap and dt == F32

    def f64(v):
        return torch.full((), float(v), dtype=F64, device=dev)

    # constants, made once so that a step copies nothing to the device
    Kt = torch.full((), K, dtype=dt, device=dev)
    beta_f, beta_i = f64(beta_feasible), f64(beta_infeasible)
    inf, one = f64(float("inf")), f64(1.0)

    def head(state, pd_feas_prev):
        X, Y, Xs, Ys = state["X"], state["Y"], state["Xs"], state["Ys"]
        ok = torch.ones((), dtype=torch.bool, device=dev)
        ok_X = ok.clone()
        ok_S = ok.clone()

        # mu and mu_p (the words of beta_infeasible, or 0 after a feasible
        # step: a select, as clrs_tpu/solver/step.py:1321; the split of 0
        # is +0 words, so selecting before the split selects each word)
        tracing.phase("chol")
        mu = dd_div(_dot_state(ds, state, state), _scalar(Kt, nw))
        if correctoronly:
            mu_p = mu
        else:
            mu_p = dd_mul(mu, _scalar_split(
                torch.where(pd_feas_prev, 0.0, beta_i), nw, dt))

        # chol(X)+chol(Y) per class as one [2L] batch; X^-1
        Xinv, Xinv_s, cholX, cholY = [], [], [], []
        for j, cl in enumerate(ds.clusters):
            xi, lc, ly = [], [], []
            for ki, k in enumerate(cl.classes):
                L2, okb = dl.b_cholesky(_cat(X[j][ki], Y[j][ki]))
                ok = ok & okb.all()
                ok_X = ok_X & okb[:k.L].all()
                Lc = tuple(c[:k.L] for c in L2)
                ly.append(tuple(c[k.L:] for c in L2))
                eye_b = tuple(c.expand(k.L, k.n, k.n)
                              for c in dl.dd_eye(k.n, nw, dev, dt))
                inv = dl.b_solve_cholesky(Lc, eye_b)
                xi.append(dl.dd_symmetrize(inv))
                lc.append(Lc)
            Xinv.append(xi)
            cholX.append(lc)
            cholY.append(ly)
            if cl.s_nb:
                ok = ok & (Xs[j][0] > 0).all()
                Xinv_s.append(dd_div(_scalar(
                    torch.ones((cl.J, cl.s_nb), dtype=dt, device=dev), nw),
                    Xs[j]))
            else:
                Xinv_s.append(dl.dd_zeros((cl.J, 0), nw, dev, dt))

        # XY products and the pairing panels (shared by Schur and d)
        tracing.phase("schur")
        XYs, panels = [], []
        for j, cl in enumerate(ds.clusters):
            xyc, pc = [], []
            for ki, k in enumerate(cl.classes):
                xyc.append(_bmm(X[j][ki], Y[j][ki]))
                if k.kind != "lowrank" or cl.row_shard:
                    # row-sharded clusters get their pairings (and the
                    # trace diagonal) from the row-panel Schur region
                    pc.append(None)
                elif k.use_pairs:
                    pc.append(_pairs_xy(k, Xinv[j][ki], Y[j][ki]))
                else:
                    pc.append(_panels_xy(k, Xinv[j][ki], Y[j][ki]))
            XYs.append(xyc)
            panels.append(pc)
        panelsY = [[None if pc is None else pc[1] for pc in pj]
                   for pj in panels]

        def _residual_R(mu_val, corr=None):
            """R = mu I - X Y [- dX dY], masked on padding."""
            Rs, Rs_s = [], []
            for j, cl in enumerate(ds.clusters):
                Rc = []
                for ki, k in enumerate(cl.classes):
                    dXdY = (None if corr is None
                            else _bmm(corr[0][j][ki], corr[1][j][ki]))
                    if plmap:
                        Rc.append(dk.plmap_residual(
                            _bcast_words(mu_val, k.L), k.maskd, XYs[j][ki],
                            dXdY))
                        continue
                    eye_b = tuple(c.expand(k.L, k.n, k.n)
                                  for c in dl.dd_eye(k.n, nw, dev, dt))
                    if dXdY is None:
                        Rc.append(dd_msub(mu_val, eye_b, XYs[j][ki],
                                          k.maskd))
                        continue
                    Rb = dd_sub(dd_msub(mu_val, eye_b, XYs[j][ki]), dXdY)
                    Rc.append(_dd_scale(Rb, k.maskd))
                Rs.append(Rc)
                if cl.s_nb:
                    ones = torch.ones((cl.J, cl.s_nb), dtype=dt, device=dev)
                    if corr is None:
                        Rs_s.append(dd_mms(mu_val, _scalar(ones, nw), Xs[j],
                                           Ys[j], cl.smask))
                    else:
                        Rb = dd_mms(mu_val, _scalar(ones, nw), Xs[j], Ys[j])
                        Rs_s.append(dd_fms(Rb, corr[2][j], corr[3][j],
                                           cl.smask))
                else:
                    Rs_s.append(dl.dd_zeros((cl.J, 0), nw, dev, dt))
            return Rs, Rs_s

        R, R_s = _residual_R(mu_p)

        # Schur complement per cluster + KKT decomposition
        cholSs, LinvBs = [], []
        for j, cl in enumerate(ds.clusters):
            if j:
                tracing.phase("schur")
            if cl.row_shard:
                L, LinvB, dgys, okb = _dist_schur_region(
                    cl, Xinv[j], Y[j], Xinv_s[j], Ys[j])
                for ki, dgy in enumerate(dgys):
                    panelsY[j][ki] = ("diag", dgy)
            else:
                S = _schur_cluster(cl, Xinv[j], Y[j], Xinv_s[j], Ys[j],
                                   panels=panels[j])
                tracing.phase("kkt")
                L, okb = dl.b_cholesky(S)
                okb = okb.all()
                LinvB = dl.b_solve_tril(L, cl.B)
            ok = ok & okb
            ok_S = ok_S & okb
            cholSs.append(L)
            LinvBs.append(LinvB)
        Q = dl.dd_zeros((ds.nfree, ds.nfree), nw, dev, dt)
        for LinvB, cl in zip(LinvBs, ds.clusters):
            if cl.shard_j:
                LinvB = cl.comm.all_gather(LinvB, 0)
            Bf = tuple(c.reshape(c.shape[0] * c.shape[1], c.shape[2])
                       for c in LinvB)
            Q = dd_add(Q, dl.dd_matmul(dl.dd_transpose(Bf), Bf))
        cholQ, okq = dl.s_cholesky(Q)
        ok = ok & okq

        # residuals at the current point
        tracing.phase("direction")
        Pres, Pres_s, pres, dres = _residuals(ds, state, panelsY=panelsY)
        dual_error, primal_error, P_error, p_error = _errors(
            ds, Pres, Pres_s, pres, dres)
        pd_feas_now = (dual_error < dual_error_threshold) & \
                      (primal_error < primal_error_threshold)

        PYprod = [[_bmm(Pres[j][ki], Y[j][ki])
                   for ki in range(len(cl.classes))]
                  for j, cl in enumerate(ds.clusters)]

        def search_direction(Rcur, Rcur_s):
            # Z = X^-1 (P Y - R), symmetrized
            Zs, Zs_s = [], []
            for j, cl in enumerate(ds.clusters):
                Zs.append([dl.dd_symmetrize(_bmm(
                    Xinv[j][ki], dd_sub(PYprod[j][ki], Rcur[j][ki])))
                    for ki in range(len(cl.classes))])
                if cl.s_nb:
                    Zs_s.append(dd_mul(Xinv_s[j], dd_msub(
                        Pres_s[j], Ys[j], Rcur_s[j])))
                else:
                    Zs_s.append(dl.dd_zeros((cl.J, 0), nw, dev, dt))
            # rhs_x = -d - <A_*, Z>
            rhs_x = [dd_sub(dd_neg(dres[j]),
                            _trace_A_cluster(cl, Zs[j], Zs_s[j]))
                     for j, cl in enumerate(ds.clusters)]
            # 3-stage triangular solve, batched over each group's [J]
            temp_x, temp_y = [], []
            for j, cl in enumerate(ds.clusters):
                rhs3 = tuple(c[:, :, None] for c in rhs_x[j])
                if cl.row_shard:
                    tx = _dist_solve(cl, cholSs[j], rhs3)
                else:
                    tx = dl.b_solve_tril(cholSs[j], rhs3)
                temp_x.append(tx)
                ty = _bmm(dl.dd_transpose(LinvBs[j]), tx)
                temp_y.append(cl.comm.all_gather(ty, 0) if cl.shard_j
                              else ty)
            dy = _col(pres)
            for ty in temp_y:
                dy = dl.dd_sum_prod(ty, None, 0, dy, sub=True)
            dy = dl.s_solve_cholesky(cholQ, dy)
            dx = []
            for j, cl in enumerate(ds.clusters):
                dyb = tuple(c[None].expand((cl.J,) + c.shape) for c in dy)
                t = dd_add(temp_x[j], _bmm(LinvBs[j], dyb))
                if cl.row_shard:
                    dxj = _dist_solve(cl, cholSs[j], t, transpose=True)
                else:
                    dxj = dl.b_solve_tril_t(cholSs[j], t)
                dx.append(tuple(c[:, :, 0] for c in dxj))
            dy = _col0(dy)
            # dX = sum_i dx_i A_i + P
            dX, dXs = [], []
            for j, cl in enumerate(ds.clusters):
                wA, wA_s = _weighted_A_cluster(cl, dx[j])
                dX.append([dd_add(w, Pb) for w, Pb in zip(wA, Pres[j])])
                dXs.append(dd_add(wA_s, Pres_s[j]) if cl.s_nb
                           else dl.dd_zeros((cl.J, 0), nw, dev, dt))
            # dY = X^-1 (R - dX Y), symmetrized
            dY, dYs = [], []
            for j, cl in enumerate(ds.clusters):
                dY.append([dl.dd_symmetrize(_bmm(
                    Xinv[j][ki], dd_sub(Rcur[j][ki],
                                        _bmm(dX[j][ki], Y[j][ki]))))
                    for ki in range(len(cl.classes))])
                if cl.s_nb:
                    dYs.append(dd_mul(Xinv_s[j], dd_fms(
                        Rcur_s[j], dXs[j], Ys[j])))
                else:
                    dYs.append(dl.dd_zeros((cl.J, 0), nw, dev, dt))
            return dx, dy, dX, dY, dXs, dYs

        # predictor
        dx, dy, dX, dY, dXs, dYs = search_direction(R, R_s)

        # corrector mu: r = <X+dX, Y+dY>/(mu K)
        padd = dk.plmap_add if plmap else dd_add
        sstate = {
            "X": [[padd(a, b) for a, b in zip(Xc, dXc)]
                  for Xc, dXc in zip(state["X"], dX)],
            "Y": [[padd(a, b) for a, b in zip(Yc, dYc)]
                  for Yc, dYc in zip(state["Y"], dY)],
            "Xs": [dd_add(a, b) for a, b in zip(state["Xs"], dXs)],
            "Ys": [dd_add(a, b) for a, b in zip(state["Ys"], dYs)],
        }
        mu64 = _f64sum(mu)
        r_val = _f64sum(_dot_state(ds, sstate, sstate)) / (mu64 * K)
        beta = torch.where(r_val < 1.0, r_val ** 2, r_val)
        beta_c = torch.where(
            pd_feas_now,
            torch.clamp(torch.maximum(beta_f, beta), max=1.0),
            torch.maximum(beta_i, beta))
        mu_c = dd_mul(mu, _scalar_split(beta_c, nw, dt))

        # corrector direction
        Rc, Rc_s = _residual_R(mu_c, corr=(dX, dY, dXs, dYs))
        dx, dy, dX, dY, dXs, dYs = search_direction(Rc, Rc_s)

        # the step-length matrices (the eigensolver's input)
        tracing.phase("steplen")
        mats, bads, words = _step_mats(ds, dX, dY, cholX, cholY)
        if ds.comm is not None:
            ok, ok_X, ok_S = (ds.comm.all_and(f) for f in (ok, ok_X, ok_S))
        mid = {
            "dx": dx, "dy": dy, "dX": dX, "dY": dY, "dXs": dXs, "dYs": dYs,
            "bads": bads, "words": words, "mu": mu64,
            "dual_error": dual_error,
            "primal_error": primal_error, "P_error": P_error,
            "p_error": p_error, "pd_feas": pd_feas_now, "beta_c": beta_c,
            "ok": ok, "ok_X": ok_X, "ok_S": ok_S, "ok_Q": okq,
        }
        return mid, mats

    def tail(state, mid, lows):
        lows, safety = _certify(mid["words"], lows, eig_safety)
        alpha_d, alpha_p = _step_lengths(
            ds, state, mid["dX"], mid["dXs"], mid["dY"], mid["dYs"], lows,
            mid["bads"], gamma, safety, inf, one)
        pd_feas_now = mid["pd_feas"]
        if safe_step:
            a = torch.minimum(alpha_p, alpha_d)
            alpha_p = torch.where(pd_feas_now, a, alpha_p)
            alpha_d = torch.where(pd_feas_now, a, alpha_d)

        tracing.phase("update")
        new_state = _axpy_state(state, mid["dx"], mid["dy"], mid["dX"],
                                mid["dY"], mid["dXs"], mid["dYs"],
                                alpha_d, alpha_p, plmap=plmap)
        d_obj, p_obj, gap = _objectives(ds, new_state)
        info = {
            "mu": mid["mu"], "dual_error": mid["dual_error"],
            "primal_error": mid["primal_error"], "P_error": mid["P_error"],
            "p_error": mid["p_error"], "pd_feas": pd_feas_now,
            "alpha_d": alpha_d, "alpha_p": alpha_p, "beta_c": mid["beta_c"],
            "d_obj": d_obj, "p_obj": p_obj,
            "dual_gap": gap, "ok": mid["ok"], "ok_X": mid["ok_X"],
            "ok_S": mid["ok_S"], "ok_Q": mid["ok_Q"],
        }
        return new_state, info

    return head, tail


def _as_flag(v, dev):
    """A bool (host or device) -> a 0-dim bool tensor on ``dev``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.bool)
    return torch.full((), bool(v), dtype=torch.bool, device=dev)


def sharded(ds: DeviceSDP):
    """Whether ``ds`` runs over a mesh (any axis or row panels sharded)."""
    return ds.comm is not None or ds.row_comm is not None


def make_step_body(ds: DeviceSDP, **kw):
    """The eager one-iteration function ``step(state, pd_feas_prev) ->
    (new_state, info)``: :func:`make_step_parts` run in turn, on any
    device. ``pd_feas_prev`` may be a host bool or a device bool tensor;
    info values are device tensors."""
    head, tail = make_step_parts(ds, **kw)

    def step(state, pd_feas_prev):
        mid, mats = head(state, _as_flag(pd_feas_prev, ds.device))
        return tail(state, mid, step_eig(mats))

    return step


# False runs make_step and make_run_chunk eagerly on the card too (the
# tests compare the two there); the solver never changes it
_CAPTURE = True

INFO_KEYS = ("mu", "dual_error", "primal_error", "P_error", "p_error",
             "pd_feas", "alpha_d", "alpha_p", "beta_c", "d_obj", "p_obj",
             "dual_gap", "ok", "ok_X", "ok_S", "ok_Q")
_FLAGS = ("pd_feas", "ok", "ok_X", "ok_S", "ok_Q")


def zero_info(assess_info=None, device=DEFAULT_DEVICE):
    """Initial info carry of :func:`make_run_chunk`, with the step's keys
    and dtypes (clrs_tpu/solver/step.py:55-72): errors, objectives and mu
    from an assess() result where given, so a chunk whose first step fails
    still reports them."""
    dev = resolve_device(device)
    seed = {"alpha_d": 1.0, "alpha_p": 1.0, "beta_c": 0.0, "pd_feas": False,
            "ok": True, "ok_X": True, "ok_S": True, "ok_Q": True}
    out = {}
    for k in INFO_KEYS:
        v = seed.get(k, 0.0)
        if k not in seed and assess_info and k in assess_info:
            v = float(assess_info[k])
        out[k] = torch.full((), v, device=dev,
                            dtype=torch.bool if k in _FLAGS else F64)
    return out


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a state or info tree (dicts, lists and
    tuples), leaf by leaf across trees of one structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _expansion_pairs(tree, other):
    """(expansion of ``tree``, the same leaf of ``other``) for every
    expansion (word tuple) of a state tree, leaves matched by key and
    position as :func:`_tree_map` matches them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _expansion_pairs(v, other[k])
    elif len(tree) and isinstance(tree[0], torch.Tensor):
        yield tuple(tree), tuple(other)
    else:
        for v, o in zip(tree, other, strict=True):
            yield from _expansion_pairs(v, o)


def _assign(buf, v):
    """Copy ``v`` (a tensor or a host number) into the tensor ``buf``."""
    if v is buf:
        return
    if isinstance(v, torch.Tensor):
        buf.copy_(v)
    else:
        buf.fill_(v)


def make_step(ds: DeviceSDP, **kw):
    """The counterpart of the JAX package's ``jax.jit(make_step_body)``:
    ``step(state, pd_feas_prev) -> (new_state, info)``.

    On the CPU this is :func:`make_step_body`. On the card the head, the
    eigensolver and the tail of :func:`make_step_parts` are captured as
    one CUDA graph at the first call (:class:`.graph.GraphStep`) and
    replayed; the words equal the eager step's bit for bit. Inputs are
    copied into static buffers; the returned state and info ARE the
    graph's static outputs, overwritten by the next call: clone what must
    outlive it. Passing them back as the next call's inputs is fine.

    A sharded ``ds`` (:func:`sharded`) runs eagerly on every device: its
    collectives are not captured."""
    if ds.device.type != "cuda" or not _CAPTURE or sharded(ds):
        return make_step_body(ds, **kw)
    from .graph import GraphStep

    head, tail = make_step_parts(ds, **kw)
    bufs = {}

    def step(state, pd_feas_prev):
        if not bufs:
            bufs["state"] = _tree_map(torch.clone, state)
            bufs["pd"] = _as_flag(pd_feas_prev, ds.device).clone()
            S, pd = bufs["state"], bufs["pd"]
            bufs["graph"] = GraphStep(
                lambda: head(S, pd), step_eig,
                lambda mid, lows: tail(S, mid, lows))
        _tree_map(_assign, bufs["state"], state)
        _assign(bufs["pd"], pd_feas_prev)
        return bufs["graph"].run()

    step.buffers = bufs
    return step


def make_run_chunk(ds: DeviceSDP, *, duality_gap_threshold: float,
                   need_dual_feasible: bool = False,
                   need_primal_feasible: bool = False,
                   step_length_threshold: float = 1e-7,
                   max_complementary_gap: float = 1e100, **step_kw):
    """Up to ``nmax`` IPM iterations with commit and rollback and the
    error codes 1/3/4 decided on the device (clrs_tpu/solver/step.py:
    1624-1694); codes 0/2 stay with the host.

    Returns ``run(state, pd_feas, info, nmax) -> (state, pd_feas, info,
    it_done, code, done)``: ``it_done`` counts committed iterations,
    ``code`` is 0/1/3/4, ``done`` says the chunk stopped for a reason other
    than reaching ``nmax``; all are device tensors, and the host reads them
    (with the info) in one transfer. A step is committed only where it is
    ok, mu is finite and the step lengths reach ``step_length_threshold``;
    otherwise state, info and pd_feas keep their last committed values.

    On the card each iteration is one replay of the step's graph (head,
    eigensolver, tail, and the commit, the termination tests and the code
    ladder as device selects; :class:`.graph.GraphStep`, captured at the
    first call), queued without a wait. A graph cannot end a loop, so
    after ``done`` an iteration commits nothing; the host stops the chunk
    early instead, keeping at most two iterations in flight: a copy of
    ``done`` to one of two pinned flags follows replay i, and before it
    queues replay i + 2 the host reads that flag, which waits only where
    the device has not yet reached the copy (at most two iterations run
    past ``done``, committing nothing). On the CPU the same loop runs
    eagerly and stops at once.

    The returned state, pd_feas and info are the loop's own buffers,
    overwritten by the next call: clone what must outlive it. Passing them
    back as the next call's inputs is fine.

    A sharded ``ds`` (:func:`sharded`) runs the same loop eagerly
    (:class:`.graph.EagerSplit`) on every device, the card included: the
    collectives of its step are not captured."""
    head, tail = make_step_parts(ds, **step_kw)
    dual_error_threshold = step_kw.get("dual_error_threshold", 1e-30)
    primal_error_threshold = step_kw.get("primal_error_threshold", 1e-30)
    correctoronly = step_kw.get("correctoronly", False)
    dev = ds.device
    graphs = dev.type == "cuda" and _CAPTURE and not sharded(ds)

    def tail_chunk(carry, mid, lows):
        state, pd_feas, info_prev, it, code, done = carry
        new_state, info = tail(state, mid, lows)
        okstep = info["ok"] & torch.isfinite(info["mu"])
        alpha_ok = torch.minimum(info["alpha_d"], info["alpha_p"]) \
            >= step_length_threshold
        commit = okstep & alpha_ok & ~done
        info2 = {k: torch.where(commit, info[k], info_prev[k])
                 for k in info_prev}
        pd_feas2 = torch.where(commit, info["pd_feas"], pd_feas)
        it2 = it + commit.to(torch.int32)
        # termination with the updated errors (the host checks these at the
        # top of the next iteration; the same decision point)
        term = torch.zeros_like(done)
        if need_dual_feasible:
            term = term | (info2["dual_error"] < dual_error_threshold)
        if need_primal_feasible:
            term = term | (info2["primal_error"] < primal_error_threshold)
        if not correctoronly:
            term = term | ((info2["dual_error"] < dual_error_threshold)
                           & (info2["primal_error"] < primal_error_threshold)
                           & (info2["dual_gap"] < duality_gap_threshold))
        mu_exceeded = info2["mu"] > max_complementary_gap
        ladder = torch.where(~okstep, 1, torch.where(
            ~alpha_ok, 4, torch.where(mu_exceeded, 3, 0))).to(torch.int32)
        code2 = torch.where((code != 0) | done, code, ladder)
        done2 = done | ~commit | term | mu_exceeded
        # every word of every state leaf picked on the device, in place
        dd_commit(commit, _expansion_pairs(new_state, state))
        _tree_map(_assign, info_prev, info2)
        for buf, v in ((pd_feas, pd_feas2), (it, it2), (code, code2),
                       (done, done2)):
            buf.copy_(v)

    loop = {}

    def setup(state, pd_feas, info):
        flag = torch.zeros((), dtype=torch.bool, device=dev)
        count = torch.zeros((), dtype=torch.int32, device=dev)
        carry = (_tree_map(torch.clone, state), flag.clone(),
                 zero_info(None, dev), count.clone(), count.clone(),
                 flag.clone())
        loop["carry"] = carry
        S, pd = carry[0], carry[1]
        parts = (lambda: head(S, pd), step_eig,
                 lambda mid, lows: tail_chunk(carry, mid, lows))
        if not graphs:
            from .graph import EagerSplit
            loop["split"] = EagerSplit(*parts)
            return
        from .graph import GraphStep
        _assign(carry[5], True)     # the warm-up iteration commits nothing
        loop["split"] = GraphStep(*parts)
        loop["done_host"] = [torch.zeros((), dtype=torch.bool,
                                         pin_memory=True) for _ in range(2)]
        loop["done_copied"] = [torch.cuda.Event() for _ in range(2)]

    def run(state, pd_feas, info, nmax):
        tracing.chunk_solve(not loop or state is not loop["carry"][0])
        with tracing.span("chunk"):
            return chunk(state, pd_feas, info, int(nmax))

    def chunk(state, pd_feas, info, nmax):
        if not loop:
            setup(state, pd_feas, info)
        carry, split = loop["carry"], loop["split"]
        S, pd, info_buf, it, code, done = carry
        with tracing.span("chunk.copy_in"):
            _tree_map(_assign, S, state)
            _assign(pd, pd_feas)
            _tree_map(_assign, info_buf, dict(info))
            for buf in (it, code, done):
                buf.zero_()
        for i in range(nmax):
            if i and not graphs and bool(done):
                break
            if graphs and i >= 2:
                # iteration i - 2's flag: a wait only where the device has
                # not reached its copy yet
                with tracing.span("chunk.flag"):
                    loop["done_copied"][i % 2].synchronize()
                    stop = bool(loop["done_host"][i % 2])
                if stop:
                    break
            with tracing.span("chunk.launch"):
                split.run()
            if graphs and i + 2 < nmax:
                with tracing.span("chunk.flag"):
                    loop["done_host"][i % 2].copy_(done, non_blocking=True)
                    loop["done_copied"][i % 2].record()
                    split.count_host_call()
        return S, pd, info_buf, it, code, done

    run.loop = loop
    return run
