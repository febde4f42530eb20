"""One Mehrotra predictor-corrector IPM iteration on the f32-expansion
substrate (port of ``clrs_tpu/solver/step.py``).

The structure is the JAX package's: PSD blocks are grouped into size
classes per cluster and every per-block operation runs once per class over
a leading [L] batch axis; 1x1 dense blocks form a per-cluster scalar pack;
padding is inert (padded diagonal entries of X/Y pinned at 1, residuals
masked). Every value is an nw-word f32 expansion (default nw = 5, ~106
bits). GEMMs are exact int8-limb products
(:func:`clrs_tpu_torch.dd.limb_gemm.fx_matmul`), factorizations and
triangular solves go through the kernel wrappers of
:mod:`clrs_tpu_torch.dd.kernels`, and the step-length bound takes the
lowest eigenvalue from float64 ``torch.linalg.eigvalsh`` with
``eig_safety`` (the JAX package's off-TPU route; the card's f64 is IEEE).

PyTorch runs eagerly: a step is a Python function over device tensors
(no jit). The elementwise chains are plain expansion ops (the JAX
``_USE_PLMAP=False`` form). Not ported here: the row-sharded big-cluster
branches and the on-device multi-iteration loop (``make_run_chunk``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..dd import linalg as dl
from ..dd.limb_gemm import fx_matmul, host_precompute
from ..dd.ops import exp_add as dd_add
from ..dd.ops import exp_div as dd_div
from ..dd.ops import exp_mul as dd_mul
from ..dd.ops import exp_neg as dd_neg
from ..dd.ops import exp_sub as dd_sub
from ..host.compile.sdp import ClusteredLowRankSDP
from ..host.dd import core as host_core

__all__ = ["DeviceSDP", "make_step_body", "make_assess", "initial_state",
           "make_run_chunk"]

F32 = torch.float32
F64 = torch.float64


def _w(a, nw, device):
    """Host multi-word tuple (f64 words) -> nw f32 words on ``device``: the
    double-word value is re-decomposed on the host (IEEE f64) into nw
    non-overlapping f32 words (clrs_tpu/solver/step.py:75-95)."""
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


def _scalar_split(v, nw):
    """f64 tensor -> nw-word f32 expansion: up to three words by successive
    rounding, so the full f64 value enters the expansion arithmetic."""
    words = []
    r = v
    for _ in range(min(nw, 3)):
        w = r.to(F32)
        words.append(w)
        r = r - w.to(F64)
    words += [torch.zeros_like(words[0])] * (nw - len(words))
    return tuple(words)


def _f64sum(x):
    """Multi-word value -> float64 (exact word casts, summed in f64)."""
    out = x[0].to(F64)
    for c in x[1:]:
        out = out + c.to(F64)
    return out


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
    row_shard: bool = False      # row-panel sharding: not ported
    nw: int = 5
    device: Any = None
    layout: List[List[Tuple[int, int]]] = None


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
    """Device-resident constants of a compiled SDP as nw-word f32
    expansions on ``device`` (clrs_tpu/solver/step.py:286-621 with
    ``dtype=float32`` and no mesh)."""

    def __init__(self, sdp: ClusteredLowRankSDP, nw: int = 5, device=None):
        self.nw = nw
        self.device = dev = resolve_device(device)
        _dd = lambda a: _w(a, nw, dev)  # noqa: E731
        _t = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
        self.maximize = sdp.maximize
        self.sign = 1.0 if sdp.maximize else -1.0
        self.constant = _w((np.float64(sdp.constant.hi),
                            np.float64(sdp.constant.lo)), nw, dev)
        self.b = _dd(sdp.b)
        self.nfree = sdp.nfree

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
            for jslot, j in enumerate(js):
                self.cluster_of[j] = (len(self.clusters), jslot)
            classes = []
            for ki in range(len(base["classes"])):
                prs = [protos[j]["classes"][ki] for j in js]
                k0 = prs[0]
                Lc, n = k0["Lc"], k0["n"]
                members = [(j, l, rn) for j, pk in zip(js, prs)
                           for (l, rn) in pk["members"]]

                def cat(key, words=True):
                    if words:
                        parts = [tuple(np.asarray(w) for w in pk[key])
                                 for pk in prs]
                        return tuple(np.concatenate([p[w] for p in parts])
                                     for w in range(len(parts[0])))
                    return np.concatenate([np.asarray(pk[key]) for pk in prs])

                common = dict(
                    kind=k0["kind"], L=J * Lc, Lc=Lc, n=n, members=members,
                    C=_dd(cat("C")),
                    maskd=_t(cat("maskd", words=False)).to(F32),
                    maskdiag=_t(cat("maskdiag", words=False)).to(F32))
                if k0["kind"] == "lowrank":
                    li = cat("li", words=False).astype(np.int32)
                    ri = cat("ri", words=False).astype(np.int32)
                    tm = cat("tm", words=False)
                    Vw = cat("V")
                    T = k0["T"]
                    # gathered term columns Ul[i, p*T+t, :] = tmask * V[:, li]
                    Ul, Ur = [], []
                    for wword in Vw:
                        wl = np.zeros((J * Lc, P * T, n))
                        wr = np.zeros((J * Lc, P * T, n))
                        for i in range(J * Lc):
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
                        tmask=_t(tm).to(F32),
                        Ul=_dd(tuple(Ul)), Ur=_dd(tuple(Ur)),
                        Ulw=_dd(Ulww), Urw=_dd(Urww),
                        use_pairs=(J * Lc) * (P * T) ** 2
                        <= _SCHUR_T1_BATCH_BUDGET)
                else:
                    common.update(A=_dd(cat("A")))
                classes.append(_DevClass(**common))

            def stackj(key):
                parts = [tuple(np.asarray(w) for w in protos[j][key])
                         for j in js]
                return tuple(np.stack([p[w] for p in parts])
                             for w in range(len(parts[0])))

            layout = [protos[j]["layout"] for j in js]
            Lcs = [k.Lc for k in classes]
            layout = [[(ki, jslot * Lcs[ki] + slot) for (ki, slot) in lay]
                      for jslot, lay in enumerate(layout)]
            dc = _DevCluster(J=J, nrows=P, members_j=list(js),
                             c=_dd(stackj("c")), B=_dd(stackj("B")),
                             classes=classes, nw=nw, device=dev,
                             layout=layout)
            scs = [protos[j]["scalars"] for j in js]
            if scs[0] is not None:
                def scat(key, words=True):
                    parts = [getattr(sc, key) for sc in scs]
                    if words:
                        parts = [tuple(np.asarray(w) for w in a)
                                 for a in parts]
                        return tuple(np.stack([p[w] for p in parts])
                                     for w in range(len(parts[0])))
                    return np.stack([np.asarray(a) for a in parts])

                dc.sa = _dd(scat("a"))
                dc.sC = _dd(scat("C"))
                dc.smask = _t(scat("mask", words=False)).to(F32)
                dc.s_nb = scs[0].nblocks
                dc.s_nreal = sum(sc.nreal for sc in scs)
            self.clusters.append(dc)
        self.total_size = sum(rn for cl in self.clusters for k in cl.classes
                              for _, _, rn in k.members) \
            + sum(cl.s_nreal for cl in self.clusters)
        self.total_rows = sum(len(cl.members_j) * cl.nrows
                              for cl in self.clusters)
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
    nw, dev = ds.nw, ds.device

    def eyes(k, omega):
        dv = omega * k.maskdiag + (1.0 - k.maskdiag)
        w0 = torch.eye(k.n, dtype=F32, device=dev) * dv[:, None, :]
        return (w0,) + tuple(torch.zeros_like(w0) for _ in range(nw - 1))

    def ones(shape, v):
        return torch.full(shape, float(v), dtype=F32, device=dev)

    x = [dl.dd_zeros((cl.J, cl.nrows), nw, dev) for cl in ds.clusters]
    y = dl.dd_zeros((ds.nfree,), nw, dev)
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
    tot = dl.dd_zeros((J, P), cl.nw, cl.device)
    for ki, (k, Z) in enumerate(zip(cl.classes, Zs)):
        if k.kind == "lowrank":
            L, P_, T = k.li.shape
            have_panel = panels is not None and panels[ki] is not None
            if have_panel and k.use_pairs:
                g = tuple(torch.diagonal(c, dim1=1, dim2=2).reshape(L, P_, T)
                          for c in panels[ki])
                v = dd_mul(k.lam, g)                  # tmask already in U
            elif have_panel:
                g = _gather_b(panels[ki], k.li, k.ri)
                v = _dd_scale(dd_mul(k.lam, g), k.tmask)
            else:
                # Hadamard: <A_p, Z> = sum_t lam (Ul Z)[pt,:] . Ur[pt,:]
                if k.Ulpre_l is not None:
                    UZ = _bmm_pre_l(Z, k.Ulpre_l, cl.nw)
                else:
                    UZ = _bmm(k.Ul, Z)
                h = dl.dd_sum(dd_mul(UZ, k.Ur), axis=2)
                v = dd_mul(k.lam, tuple(c.reshape(L, P_, T) for c in h))
            s = dl.dd_sum(tuple(c.movedim(1, 2).reshape(J, -1, P)
                                for c in v), axis=1)
            tot = dd_add(tot, s)
        else:
            prod = dd_mul(k.A, tuple(c[:, None] for c in Z))
            flat = tuple(c.reshape(J, k.Lc, P, k.n, k.n).movedim(2, 1)
                         .reshape(J, P, -1) for c in prod)
            tot = dd_add(tot, dl.dd_sum(flat, axis=2))
    if cl.s_nb:
        r = _bmm(tuple(c[:, None, :] for c in Zsc), cl.sa)
        tot = dd_add(tot, tuple(c[:, 0] for c in r))
    return tot


def _weighted_A_cluster(cl: _DevCluster, a):
    """sum_p a_p A_p per class + scalar pack; ``a`` is [J, P] words."""
    out = []
    for k in cl.classes:
        if k.kind == "lowrank":
            L, P, T = k.li.shape
            ab = tuple(torch.repeat_interleave(c, k.Lc, dim=0)[:, :, None]
                       for c in a)
            w = _dd_scale(dd_mul(k.lam, ab), k.tmask)
            wf = tuple(c.reshape(L, P * T, 1) for c in w)
            wUl = dd_mul(wf, k.Ul)                              # [L, PT, n]
            if k.Urpre_r is not None:
                out.append(_bmm_pre_r(dl.dd_transpose(wUl), k.Urpre_r))
            else:
                out.append(_bmm(dl.dd_transpose(wUl), k.Ur))
        else:
            ab = tuple(torch.repeat_interleave(c, k.Lc, dim=0)[:, :, None, None]
                       for c in a)
            out.append(dl.dd_sum(dd_mul(k.A, ab), axis=1))
    if cl.s_nb:
        r = _bmm(cl.sa, tuple(c[:, :, None] for c in a))
        out_s = tuple(c[:, :, 0] for c in r)
    else:
        out_s = dl.dd_zeros((cl.J, 0), cl.nw, cl.device)
    return out, out_s


def _schur_cluster(cl: _DevCluster, Xinvs, Ys, Xinv_s, Y_s, panels=None):
    """S^j (upper triangle mirrored), solver.jl:1062-1226."""
    J, P = cl.J, cl.nrows
    S = dl.dd_zeros((J, P, P), cl.nw, cl.device)
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
                v = dd_mul(gx5, gy5)
                vt = tuple(c.movedim(2, 3).reshape(L, P_, P_, T * T)
                           for c in v)
                contrib = dl.dd_sum(vt, axis=3)
                S = dd_add(S, dl.dd_sum(tuple(
                    c.reshape(J, k.Lc, P, P) for c in contrib), axis=1))
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
                v = dd_mul(lam2, dd_mul(gx, gy))
                v = _dd_scale(v, m2 * k.tmask[:, :, t1, None, None])
                inner = dl.dd_sum(v, axis=3)
                lam1 = tuple(c[:, :, t1, None] for c in k.lam)
                term = dd_mul(lam1, inner)
                contrib = term if contrib is None else dd_add(contrib, term)
            S = dd_add(S, dl.dd_sum(tuple(
                c.reshape(J, k.Lc, P, P) for c in contrib), axis=1))
        else:
            LP = k.L * P
            Af = tuple(c.reshape(LP, k.n, k.n) for c in k.A)
            Xr = tuple(torch.repeat_interleave(c, P, dim=0) for c in Xinv)
            Yr = tuple(torch.repeat_interleave(c, P, dim=0) for c in Y)
            XAY = _bmm(_bmm(Xr, Af), Yr)
            XAYb = tuple(c.reshape(k.L, P, k.n, k.n) for c in XAY)
            prod = dd_mul(tuple(c[:, :, None] for c in k.A),
                          tuple(c[:, None] for c in XAYb))
            flat = tuple(c.reshape(J, k.Lc, P, P, -1) for c in prod)
            S = dd_add(S, dl.dd_sum(dl.dd_sum(flat, axis=4), axis=1))
    if cl.s_nb:
        w = dd_mul(Xinv_s, Y_s)
        t = dd_mul(cl.sa, tuple(c[:, :, None] for c in w))
        S = dd_add(S, _bmm(dl.dd_transpose(cl.sa), t))
    # keep the upper triangle, mirror it (reference: symmetric!(S))
    iu = torch.triu(torch.ones((P, P), dtype=torch.bool, device=cl.device))
    return tuple(torch.where(iu, c, c.transpose(-1, -2)) for c in S)


def _dot_state(ds, A, B):
    tot = _scalar(torch.zeros((), dtype=F32, device=ds.device), ds.nw)
    for j, cl in enumerate(ds.clusters):
        for k, Xb, Yb in zip(cl.classes, A["X"][j], B["Y"][j]):
            tot = dd_add(tot, dl.dd_dot(_dd_scale(Xb, k.maskd), Yb))
        if cl.s_nb:
            tot = dd_add(tot, dl.dd_dot(_dd_scale(A["Xs"][j], cl.smask),
                                        B["Ys"][j]))
    return tot


def _max_abs_all(ds, Ms, Ms_s):
    v = torch.zeros((), dtype=F64, device=ds.device)
    for Mc in Ms:
        for Mb in Mc:
            v = torch.maximum(v, dl.dd_max_abs(Mb))
    for Mb in Ms_s:
        if Mb[0].shape[0]:
            v = torch.maximum(v, dl.dd_max_abs(Mb))
    return v


def _residuals(ds: DeviceSDP, state, panelsY=None):
    """P = sum_i x_i A_i - X - sign*C;  d = c - <A_*,Y> - By;
    p = sign*b - B^T x  (solver.jl:882-918); P masked to the real area."""
    x, y = state["x"], state["y"]
    Pres, Pres_s, dres = [], [], []
    for j, cl in enumerate(ds.clusters):
        wA, wA_s = _weighted_A_cluster(cl, x[j])
        Pres.append([_dd_scale(dd_sub(dd_sub(wA[ki], state["X"][j][ki]),
                                      _dd_scale(k.C, ds.sign)), k.maskd)
                     for ki, k in enumerate(cl.classes)])
        if cl.s_nb:
            Ps = dd_sub(dd_sub(wA_s, state["Xs"][j]),
                        _dd_scale(cl.sC, ds.sign))
            Pres_s.append(_dd_scale(Ps, cl.smask))
        else:
            Pres_s.append(dl.dd_zeros((cl.J, 0), ds.nw, ds.device))
        yb = tuple(c[None, :, None].expand(cl.J, c.shape[0], 1) for c in y)
        By = _bmm(cl.B, yb)
        d_j = dd_sub(dd_sub(cl.c, tuple(c[:, :, 0] for c in By)),
                     _trace_A_cluster(cl, state["Y"][j], state["Ys"][j],
                                      panels=None if panelsY is None
                                      else panelsY[j]))
        dres.append(d_j)
    pres = _dd_scale(ds.b, ds.sign)
    for j, cl in enumerate(ds.clusters):
        Bf = tuple(c.reshape(cl.J * cl.nrows, -1) for c in cl.B)
        xf = tuple(c.reshape(cl.J * cl.nrows, 1) for c in x[j])
        Btx = dl.dd_matmul(dl.dd_transpose(Bf), xf)
        pres = dd_sub(pres, _col0(Btx))
    return Pres, Pres_s, pres, dres


def _objectives(ds: DeviceSDP, state):
    x, y = state["x"], state["y"]
    zero = torch.zeros((), dtype=F32, device=ds.device)
    dot_cx = _scalar(zero, ds.nw)
    for j, cl in enumerate(ds.clusters):
        dot_cx = dd_add(dot_cx, dl.dd_dot(cl.c, x[j]))
    d_obj = dd_add(_dd_scale(dot_cx, ds.sign), ds.constant)
    CY = _scalar(zero, ds.nw)
    for j, cl in enumerate(ds.clusters):
        for k, Yb in zip(cl.classes, state["Y"][j]):
            CY = dd_add(CY, dl.dd_dot(k.C, Yb))       # C is zero on padding
        if cl.s_nb:
            CY = dd_add(CY, dl.dd_dot(cl.sC, state["Ys"][j]))
    by = dl.dd_dot(ds.b, y)
    p_obj = dd_add(dd_add(CY, by), ds.constant)
    diff = dd_sub(d_obj, p_obj)
    gap_num = _f64sum(diff).abs()
    denom = torch.clamp((_f64sum(d_obj) + _f64sum(p_obj)).abs(), min=1.0)
    return d_obj, p_obj, gap_num / denom


def _errors(ds, Pres, Pres_s, pres, dres):
    """P_error = max |P|, p_error = max |p|, primal error = max |d|;
    dual_error = max(P_error, p_error) (solver.jl:806-847)."""
    P_error = _max_abs_all(ds, Pres, Pres_s)
    p_error = dl.dd_max_abs(pres)
    dual_error = torch.maximum(P_error, p_error)
    primal_error = torch.zeros((), dtype=F64, device=ds.device)
    for d_j in dres:
        primal_error = torch.maximum(primal_error, dl.dd_max_abs(d_j))
    return dual_error, primal_error, P_error, p_error


def _eig_lo_bound(W2, eig_safety):
    """Lower eigenvalue bounds of symmetrized batches from float64
    eigvalsh, less eig_safety * (1 + |lambda_min|) (the JAX off-TPU route,
    clrs_tpu/solver/step.py:1146-1166)."""
    A64 = _f64sum(W2)
    A64 = 0.5 * (A64 + A64.transpose(-1, -2))
    lo = torch.linalg.eigvalsh(A64)[:, 0]
    return lo - eig_safety * (1.0 + lo.abs())


def _step_lengths(ds, state, dX, dXs, dY, dYs, cholX, cholY, gamma,
                  eig_safety):
    """(alpha_d, alpha_p): longest steps keeping X + a dX and Y + a dY PSD,
    from min eig of L^-1 dM L^-T with the factors of this iteration
    (solver.jl:1618-1693); the X and Y sides run as one [2L] batch."""
    inf = torch.tensor(float("inf"), dtype=F64, device=ds.device)
    min_d, min_p = inf, inf

    def scalar_min(cur, Mb, dMb, mask):
        e = (_f64sum(tuple(c[:, 0, 0] for c in dMb))
             / _f64sum(tuple(c[:, 0, 0] for c in Mb)))
        e = torch.where(mask > 0, e, inf)
        return torch.minimum(cur, e.min())

    for j, cl in enumerate(ds.clusters):
        for ki, k in enumerate(cl.classes):
            Xb, Yb = state["X"][j][ki], state["Y"][j][ki]
            dXb, dYb = dX[j][ki], dY[j][ki]
            if k.n == 1:
                min_d = scalar_min(min_d, Xb, dXb, k.maskdiag[:, 0])
                min_p = scalar_min(min_p, Yb, dYb, k.maskdiag[:, 0])
                continue
            L2 = _cat(cholX[j][ki], cholY[j][ki])
            W = dl.b_solve_tril(L2, _cat(dXb, dYb))
            W2 = dl.b_solve_tril(L2, dl.dd_transpose(W))
            lo = _eig_lo_bound(W2, eig_safety)
            min_d = torch.minimum(min_d, lo[:k.L].min())
            min_p = torch.minimum(min_p, lo[k.L:].min())
        if cl.s_nb:
            e = _f64sum(dXs[j]) / _f64sum(state["Xs"][j])
            min_d = torch.minimum(min_d, torch.where(cl.smask > 0, e, inf).min())
            e = _f64sum(dYs[j]) / _f64sum(state["Ys"][j])
            min_p = torch.minimum(min_p, torch.where(cl.smask > 0, e, inf).min())
    one = torch.ones((), dtype=F64, device=ds.device)
    a_d = torch.where(min_d > -gamma, one, -gamma / min_d)
    a_p = torch.where(min_p > -gamma, one, -gamma / min_p)
    return a_d, a_p


def _axpy_state(state, dx, dy, dX, dY, dXs, dYs, alpha_d, alpha_p):
    nw = len(state["y"])
    ad = _scalar_split(alpha_d, nw)
    ap = _scalar_split(alpha_p, nw)
    X = [[dd_add(Xb, dd_mul(dXb, ad)) for Xb, dXb in zip(Xc, dXc)]
         for Xc, dXc in zip(state["X"], dX)]
    Y = [[dd_add(Yb, dd_mul(dYb, ap)) for Yb, dYb in zip(Yc, dYc)]
         for Yc, dYc in zip(state["Y"], dY)]
    x = [dd_add(xj, dd_mul(dxj, ad)) for xj, dxj in zip(state["x"], dx)]
    y = dd_add(state["y"], dd_mul(dy, ap))
    Xs = [dd_add(a, dd_mul(b, ad)) for a, b in zip(state["Xs"], dXs)]
    Ys = [dd_add(a, dd_mul(b, ap)) for a, b in zip(state["Ys"], dYs)]
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
        K = torch.full((), float(ds.total_size), dtype=F32, device=ds.device)
        mu_dd = dd_div(_dot_state(ds, state, state), _scalar(K, ds.nw))
        return {"dual_error": dual_error, "primal_error": primal_error,
                "P_error": P_error, "p_error": p_error,
                "d_obj": _f64sum(d_obj), "p_obj": _f64sum(p_obj),
                "dual_gap": gap, "mu": _f64sum(mu_dd)}

    return assess


def make_step_body(ds: DeviceSDP, *, gamma: float, beta_feasible: float,
                   beta_infeasible: float, dual_error_threshold: float,
                   primal_error_threshold: float, safe_step: bool = True,
                   correctoronly: bool = False, eig_safety: float = 1e-12):
    """Build the one-iteration function ``step(state, pd_feas_prev) ->
    (new_state, info)``; info values are device tensors."""
    K = float(ds.total_size)
    nw = ds.nw
    dev = ds.device

    def f64(v):
        return torch.tensor(float(v), dtype=F64, device=dev)

    def step(state, pd_feas_prev):
        X, Y, Xs, Ys = state["X"], state["Y"], state["Xs"], state["Ys"]
        ok = torch.ones((), dtype=torch.bool, device=dev)
        ok_X = ok.clone()
        ok_S = ok.clone()
        if any(cl.row_shard for cl in ds.clusters):
            raise NotImplementedError("row-sharded clusters are not ported")

        # mu and mu_p
        Kt = torch.full((), K, dtype=F32, device=dev)
        mu = dd_div(_dot_state(ds, state, state), _scalar(Kt, nw))
        if correctoronly:
            mu_p = mu
        else:
            bw = _scalar_split(f64(beta_infeasible), nw)
            if bool(pd_feas_prev):
                bw = tuple(torch.zeros_like(w) for w in bw)
            mu_p = dd_mul(mu, bw)

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
                              for c in dl.dd_eye(k.n, nw, dev))
                inv = dl.b_solve_cholesky(Lc, eye_b)
                xi.append(dl.dd_symmetrize(inv))
                lc.append(Lc)
            Xinv.append(xi)
            cholX.append(lc)
            cholY.append(ly)
            if cl.s_nb:
                ok = ok & (Xs[j][0] > 0).all()
                Xinv_s.append(dd_div(_scalar(
                    torch.ones((cl.J, cl.s_nb), dtype=F32, device=dev), nw),
                    Xs[j]))
            else:
                Xinv_s.append(dl.dd_zeros((cl.J, 0), nw, dev))

        # XY products and the pairing panels (shared by Schur and d)
        XYs, panels = [], []
        for j, cl in enumerate(ds.clusters):
            xyc, pc = [], []
            for ki, k in enumerate(cl.classes):
                xyc.append(_bmm(X[j][ki], Y[j][ki]))
                if k.kind != "lowrank":
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
                    eye_b = tuple(c.expand(k.L, k.n, k.n)
                                  for c in dl.dd_eye(k.n, nw, dev))
                    Rb = dd_sub(dd_mul(mu_val, eye_b), XYs[j][ki])
                    if corr is not None:
                        Rb = dd_sub(Rb, _bmm(corr[0][j][ki], corr[1][j][ki]))
                    Rc.append(_dd_scale(Rb, k.maskd))
                Rs.append(Rc)
                if cl.s_nb:
                    ones = torch.ones((cl.J, cl.s_nb), dtype=F32, device=dev)
                    Rb = dd_sub(dd_mul(mu_val, _scalar(ones, nw)),
                                dd_mul(Xs[j], Ys[j]))
                    if corr is not None:
                        Rb = dd_sub(Rb, dd_mul(corr[2][j], corr[3][j]))
                    Rs_s.append(_dd_scale(Rb, cl.smask))
                else:
                    Rs_s.append(dl.dd_zeros((cl.J, 0), nw, dev))
            return Rs, Rs_s

        R, R_s = _residual_R(mu_p)

        # Schur complement per cluster + KKT decomposition
        cholSs, LinvBs = [], []
        for j, cl in enumerate(ds.clusters):
            S = _schur_cluster(cl, Xinv[j], Y[j], Xinv_s[j], Ys[j],
                               panels=panels[j])
            L, okb = dl.b_cholesky(S)
            okb = okb.all()
            ok = ok & okb
            ok_S = ok_S & okb
            cholSs.append(L)
            LinvBs.append(dl.b_solve_tril(L, cl.B))
        Q = dl.dd_zeros((ds.nfree, ds.nfree), nw, dev)
        for LinvB in LinvBs:
            Bf = tuple(c.reshape(c.shape[0] * c.shape[1], c.shape[2])
                       for c in LinvB)
            Q = dd_add(Q, dl.dd_matmul(dl.dd_transpose(Bf), Bf))
        cholQ, okq = dl.s_cholesky(Q)
        ok = ok & okq

        # residuals at the current point
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
                    Zs_s.append(dd_mul(Xinv_s[j], dd_sub(
                        dd_mul(Pres_s[j], Ys[j]), Rcur_s[j])))
                else:
                    Zs_s.append(dl.dd_zeros((cl.J, 0), nw, dev))
            # rhs_x = -d - <A_*, Z>
            rhs_x = [dd_sub(dd_neg(dres[j]),
                            _trace_A_cluster(cl, Zs[j], Zs_s[j]))
                     for j, cl in enumerate(ds.clusters)]
            # 3-stage triangular solve, batched over each group's [J]
            temp_x, temp_y = [], []
            for j, cl in enumerate(ds.clusters):
                tx = dl.b_solve_tril(cholSs[j],
                                     tuple(c[:, :, None] for c in rhs_x[j]))
                temp_x.append(tx)
                temp_y.append(_bmm(dl.dd_transpose(LinvBs[j]), tx))
            dy = _col(pres)
            for ty in temp_y:
                dy = dd_sub(dy, dl.dd_sum(ty, axis=0))
            dy = dl.s_solve_cholesky(cholQ, dy)
            dx = []
            for j, cl in enumerate(ds.clusters):
                dyb = tuple(c[None].expand((cl.J,) + c.shape) for c in dy)
                t = dd_add(temp_x[j], _bmm(LinvBs[j], dyb))
                dxj = dl.b_solve_tril_t(cholSs[j], t)
                dx.append(tuple(c[:, :, 0] for c in dxj))
            dy = _col0(dy)
            # dX = sum_i dx_i A_i + P
            dX, dXs = [], []
            for j, cl in enumerate(ds.clusters):
                wA, wA_s = _weighted_A_cluster(cl, dx[j])
                dX.append([dd_add(w, Pb) for w, Pb in zip(wA, Pres[j])])
                dXs.append(dd_add(wA_s, Pres_s[j]) if cl.s_nb
                           else dl.dd_zeros((cl.J, 0), nw, dev))
            # dY = X^-1 (R - dX Y), symmetrized
            dY, dYs = [], []
            for j, cl in enumerate(ds.clusters):
                dY.append([dl.dd_symmetrize(_bmm(
                    Xinv[j][ki], dd_sub(Rcur[j][ki],
                                        _bmm(dX[j][ki], Y[j][ki]))))
                    for ki in range(len(cl.classes))])
                if cl.s_nb:
                    dYs.append(dd_mul(Xinv_s[j], dd_sub(
                        Rcur_s[j], dd_mul(dXs[j], Ys[j]))))
                else:
                    dYs.append(dl.dd_zeros((cl.J, 0), nw, dev))
            return dx, dy, dX, dY, dXs, dYs

        # predictor
        dx, dy, dX, dY, dXs, dYs = search_direction(R, R_s)

        # corrector mu: r = <X+dX, Y+dY>/(mu K)
        sstate = {
            "X": [[dd_add(a, b) for a, b in zip(Xc, dXc)]
                  for Xc, dXc in zip(state["X"], dX)],
            "Y": [[dd_add(a, b) for a, b in zip(Yc, dYc)]
                  for Yc, dYc in zip(state["Y"], dY)],
            "Xs": [dd_add(a, b) for a, b in zip(state["Xs"], dXs)],
            "Ys": [dd_add(a, b) for a, b in zip(state["Ys"], dYs)],
        }
        r_val = _f64sum(_dot_state(ds, sstate, sstate)) / (_f64sum(mu) * K)
        beta = torch.where(r_val < 1.0, r_val ** 2, r_val)
        beta_c = torch.where(
            pd_feas_now,
            torch.clamp(torch.maximum(f64(beta_feasible), beta), max=1.0),
            torch.maximum(f64(beta_infeasible), beta))
        mu_c = dd_mul(mu, _scalar_split(beta_c, nw))

        # corrector direction
        Rc, Rc_s = _residual_R(mu_c, corr=(dX, dY, dXs, dYs))
        dx, dy, dX, dY, dXs, dYs = search_direction(Rc, Rc_s)

        # step lengths
        alpha_d, alpha_p = _step_lengths(ds, state, dX, dXs, dY, dYs,
                                         cholX, cholY, gamma, eig_safety)
        if safe_step:
            a = torch.minimum(alpha_p, alpha_d)
            alpha_p = torch.where(pd_feas_now, a, alpha_p)
            alpha_d = torch.where(pd_feas_now, a, alpha_d)

        new_state = _axpy_state(state, dx, dy, dX, dY, dXs, dYs,
                                alpha_d, alpha_p)
        d_obj, p_obj, gap = _objectives(ds, new_state)
        info = {
            "mu": _f64sum(mu), "dual_error": dual_error,
            "primal_error": primal_error, "P_error": P_error,
            "p_error": p_error, "pd_feas": pd_feas_now,
            "alpha_d": alpha_d, "alpha_p": alpha_p, "beta_c": beta_c,
            "d_obj": _f64sum(d_obj), "p_obj": _f64sum(p_obj),
            "dual_gap": gap, "ok": ok, "ok_X": ok_X, "ok_S": ok_S,
            "ok_Q": okq,
        }
        return new_state, info

    return step


def make_run_chunk(ds: DeviceSDP, **kw):
    """The on-device multi-iteration loop of the JAX package (a CUDA graph
    of the step body here) is not ported yet: one step per host
    iteration."""
    raise NotImplementedError("make_run_chunk is not ported; use one step "
                              "per host iteration (make_step_body)")
