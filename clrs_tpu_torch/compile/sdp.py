"""Problem -> ClusteredLowRankSDP compiler.

TPU-first re-design of `ClusteredLowRankSolver.jl/src/interface.jl:807-1112`:

- clustering by shared PSD variables (union-merge, deterministic ordering;
  interface.jl:849-912),
- sample evaluation of all coefficients into double-word float64
  (interface.jl:926-991 evaluates into Arb),
- per-block *embedded* low-rank vector panels: each rank-1 factor of a
  subblock (r,s) is embedded into the full block height, columns dedup'd,
  and every constraint row gets a static term table
  (lambda, left-index, right-index) pointing into the panel.  These tables
  are the gather indices that drive the batched Schur/trace/weighted-sum
  einsums on device — the TPU equivalent of the reference's pointer dicts
  (solver.jl:985-1059).

The assembled matrix for constraint row p in block l is taken literally as
sum_t lambda_t u_t w_t^T over all user-supplied subblocks; since users supply
both (r,s) and (s,r) subblocks (A[r,s] = A[s,r]^T, solver.jl:1009), this
equals the reference's lower-triangle-times-two accounting.
"""

from __future__ import annotations

import dataclasses
import warnings
from fractions import Fraction
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..model.problem import (
    Block,
    Constraint,
    LowRankMatPol,
    Problem,
    name_of,
    sortkey,
    subblock_of,
)
from ..utils.hp import DDScalar, hp_add, hp_mul, to_dd

__all__ = ["ClusteredLowRankSDP", "BlockData", "ClusterData", "sample_eval",
           "convert_to_prec"]


def sample_eval(x, sample, scaling=1):
    """Evaluate a coefficient at one sample point into a host scalar.

    Mirrors the `sampleevaluate` overloads in interface.jl:381-435.
    """
    from ..poly.mpoly import MPoly
    from ..poly.sampled import SampledPoly

    if isinstance(x, LowRankMatPol):
        lams = [sample_eval(v, sample, scaling) for v in x.lam]
        vs = [[sample_eval(e, sample) for e in v] for v in x.vs]
        ws = [[sample_eval(e, sample) for e in w] for w in x.ws]
        return lams, vs, ws
    if isinstance(x, np.ndarray):
        out = np.empty(x.shape, dtype=object)
        for idx in np.ndindex(*x.shape):
            out[idx] = sample_eval(x[idx], sample, scaling)
        return out
    if isinstance(x, MPoly):
        args = sample if isinstance(sample, (list, tuple)) else [sample]
        return hp_mul(scaling, x(*args))
    if isinstance(x, SampledPoly):
        return hp_mul(scaling, x.evaluations[x.ring.index_of(sample)])
    # plain scalar
    return hp_mul(scaling, x)


def _dd_obj_array(a: np.ndarray):
    """object array of host scalars -> (hi, lo) float64 arrays."""
    hi = np.empty(a.shape, dtype=np.float64)
    lo = np.empty(a.shape, dtype=np.float64)
    for idx in np.ndindex(*a.shape):
        h, l = to_dd(a[idx])
        hi[idx] = h
        lo[idx] = l
    return hi, lo


@dataclasses.dataclass
class BlockData:
    """One PSD block (j,l): either low-rank term tables or dense matrices."""

    name: Any
    use_block: bool          # whether the user used Block(...) keys
    nsubblocks: int          # R: the block is (R*delta) x (R*delta)
    delta: int               # subblock size
    kind: str                # 'lowrank' | 'dense'
    C: Tuple[np.ndarray, np.ndarray]                 # dd [n, n]
    # low-rank data
    V: Optional[Tuple[np.ndarray, np.ndarray]] = None  # dd [n, m] panel
    lam: Optional[Tuple[np.ndarray, np.ndarray]] = None  # dd [P, T]
    li: Optional[np.ndarray] = None   # int32 [P, T]  (w / left panel column)
    ri: Optional[np.ndarray] = None   # int32 [P, T]  (u / right panel column)
    tmask: Optional[np.ndarray] = None  # f64 [P, T] 1.0 where term valid
    # dense data
    A: Optional[Tuple[np.ndarray, np.ndarray]] = None  # dd [P, n, n]

    @property
    def n(self):
        return self.nsubblocks * self.delta


@dataclasses.dataclass
class ScalarPack:
    """All 1x1 dense blocks of a cluster, batched into one subgraph.

    An LP-cone specialization: the reference treats 1x1 PSD blocks like any
    other Arb matrix; batching them makes every per-block op a vector op
    (a big win for compile time and TPU utilization on problems like
    Delsarte where most blocks are 1x1 scalars).
    """

    names: List[Any]                                 # B block names
    a: Tuple[np.ndarray, np.ndarray]                 # dd [B_pad, P] coefficients
    C: Tuple[np.ndarray, np.ndarray]                 # dd [B_pad] objective coeffs
    mask: np.ndarray = None                          # f64 [B_pad]: 1 real, 0 pad
    # exact power-of-two per-variable equilibration: device data carries
    # a/scale and C/scale; the true solution entries are Y = Y'/scale,
    # X = X'*scale (undone at extraction). This keeps high-degree
    # coefficient growth (e.g. gegenbauer packs reach 1e45 at degree ~250)
    # inside the f32 exponent window of the TPU substrate — the compiler
    # role the reference delegates to Arb's unbounded exponents and the
    # user-facing `scalings` (interface.jl sampleevaluate)
    scale: np.ndarray = None                         # f64 [B_pad] powers of 2

    def __post_init__(self):
        if self.mask is None:
            self.mask = np.ones(self.a[0].shape[0])
        if self.scale is None:
            self.scale = np.ones(self.a[0].shape[0])

    @property
    def nblocks(self):
        return self.a[0].shape[0]

    @property
    def nreal(self):
        return len(self.names)


@dataclasses.dataclass
class ClusterData:
    nrows: int                                      # P_j
    c: Tuple[np.ndarray, np.ndarray]                # dd [P]
    B: Tuple[np.ndarray, np.ndarray]                # dd [P, N]
    blocks: List[BlockData]
    scalars: Optional[ScalarPack] = None


class ClusteredLowRankSDP:
    """Compiled clustered low-rank SDP (interface.jl:807-819 equivalent)."""

    def __init__(self, problem: Problem, verbose: bool = False,
                 scalar_pad: int = 1, equilibrate_free: bool = True):
        """scalar_pad: pad each cluster's scalar-pack axis to a multiple of
        this (for sharding the pack axis over a device mesh).

        equilibrate_free: rescale each free variable by an exact power of two
        so the columns of B have comparable magnitude. This bounds the
        condition number of Q = B^T S^-1 B independently of the user's
        variable scaling (e.g. the Cohn-Elkies k!/pi^k coefficients span
        1e48, which would otherwise need ~512-bit arithmetic like the
        reference uses; see examples/SpherePacking.jl's own comment about
        "extremely large" numbers). Solutions are unscaled on extraction,
        so this is invisible to the user.
        """
        self.maximize = problem.maximize
        self.constant = DDScalar(problem.objective.constant)
        (self.clusters, self.b, self.free_names, self.order_c,
         self.matrix_coeff_names, self.matrix_coeff_blocks) = _compile(
             problem, verbose, scalar_pad)
        n = self.b[0].shape[0]
        self.free_scale = np.ones(n)
        if equilibrate_free and n:
            colmax = np.zeros(n)
            for cl in self.clusters:
                if cl.B[0].size:
                    colmax = np.maximum(
                        colmax, np.abs(cl.B[0]).max(axis=0))
            colmax = np.maximum(colmax, 1e-300)
            self.free_scale = 2.0 ** np.round(np.log2(colmax))
            for cl in self.clusters:
                cl.B = (cl.B[0] / self.free_scale, cl.B[1] / self.free_scale)
            self.b = (self.b[0] / self.free_scale, self.b[1] / self.free_scale)

    @property
    def nfree(self):
        return self.b[0].shape[0]

    def total_rows(self):
        return sum(cl.nrows for cl in self.clusters)


def convert_to_prec(sdp, prec=106):
    """Set the SDP's device precision tier (interface.jl:1078-1112 analogue).

    The compiled host data is already exact double-word f64 (~106 bits) and
    never needs re-rounding; the tier choice materializes when the solver
    decomposes it into device expansion words. This records the preferred
    tier on the SDP; ``solvesdp(prec=None)`` honors it (prec <= 106 -> the
    fast tier, larger -> the quad-word/f32x8 tier)."""
    sdp.prec = prec
    return sdp


def _block_grid_info(constraints_in_cluster, problem):
    """subblock sizes, counts, denseness, Block-usage per variable name."""
    subblocksizes: Dict[str, int] = {}
    nsub: Dict[str, int] = {}
    dense: Dict[str, bool] = {}
    useblock: Dict[str, bool] = {}
    names: Dict[str, Any] = {}
    for ci in constraints_in_cluster:
        con = problem.constraints[ci]
        for bl, m in con.matrixcoeff.items():
            nm = sortkey(name_of(bl))
            names[nm] = name_of(bl)
            r, s = subblock_of(bl)
            sz = m.shape[0]
            subblocksizes[nm] = max(sz, subblocksizes.get(nm, 0))
            nsub[nm] = max(r, s, nsub.get(nm, 0))
            is_dense = not isinstance(m, LowRankMatPol)
            if nm in dense and dense[nm] != is_dense:
                warnings.warn(
                    f"Please use LowRankMatPol consistently for variable "
                    f"{name_of(bl)!r}; converting to dense matrices.")
            dense[nm] = dense.get(nm, False) or is_dense
            if nm in useblock and useblock[nm] != isinstance(bl, Block):
                warnings.warn(
                    f"Please use Block consistently for variable "
                    f"{name_of(bl)!r}.")
                useblock[nm] = True
            else:
                useblock[nm] = isinstance(bl, Block)
    return subblocksizes, nsub, dense, useblock, names


def _compile(problem: Problem, verbose: bool, scalar_pad: int = 1):
    cons = problem.constraints
    # ---- clustering (interface.jl:849-912) -------------------------------
    clusters_names: List[set] = []
    empty_cons, free_cons = [], []
    for ci, con in enumerate(cons):
        if not con.matrixcoeff and not con.freecoeff and _iszero(con.constant):
            empty_cons.append(ci)
            continue
        if not con.matrixcoeff:
            free_cons.append(ci)
            continue
        mynames = {sortkey(name_of(k)) for k in con.matrixcoeff}
        hit = [i for i, cl in enumerate(clusters_names) if cl & mynames]
        merged = set(mynames)
        for i in reversed(hit):
            merged |= clusters_names.pop(i)
        clusters_names.append(merged)
    clusters_names.sort(key=lambda s: (len(s), tuple(sorted(s))))

    cluster_constraints: List[List[int]] = [[] for _ in clusters_names]
    for ci, con in enumerate(cons):
        if ci in empty_cons or ci in free_cons:
            continue
        nm = sortkey(name_of(next(iter(con.matrixcoeff))))
        for i, cl in enumerate(clusters_names):
            if nm in cl:
                cluster_constraints[i].append(ci)
                break
    if free_cons:
        warnings.warn("Constraints without PSD variables detected; they are "
                      "placed in the first cluster and require preprocessing.")
        if not cluster_constraints:
            cluster_constraints.append([])
            clusters_names.append(set())
        cluster_constraints[0].extend(free_cons)

    # ---- free variable ordering (interface.jl:1019-1033) -----------------
    free_labels = []
    seen = set()
    for con in cons:
        for k in con.freecoeff:
            sk = sortkey(k)
            if sk not in seen:
                seen.add(sk)
                free_labels.append(k)
    objective = problem.objective
    uncon = [k for k in objective.freecoeff if sortkey(k) not in seen]
    if uncon:
        warnings.warn(f"Unconstrained free variables in the objective: {uncon}; removing.")
        for k in uncon:
            del objective.freecoeff[k]
    free_labels.sort(key=sortkey)
    free_index = {sortkey(k): i for i, k in enumerate(free_labels)}
    nfree = len(free_labels)

    # objective b vector
    b_obj = np.empty(nfree, dtype=object)
    b_obj[:] = 0
    for k, v in objective.freecoeff.items():
        b_obj[free_index[sortkey(k)]] = v
    b = _dd_obj_array(b_obj)

    obj_blocks: Dict[str, List] = {}
    for bl, m in objective.matrixcoeff.items():
        obj_blocks.setdefault(sortkey(name_of(bl)), []).append((bl, m))

    clusters: List[ClusterData] = []
    order_c: Dict[Tuple[int, int], Tuple[int, int]] = {}
    matrix_coeff_names: List[List[Any]] = []
    matrix_coeff_blocks: List[List[Tuple[bool, int]]] = []

    for j, cidxs in enumerate(cluster_constraints):
        if verbose:
            print(f"compiling cluster {j} ({len(cidxs)} constraints)...")
        subsz, nsub, dense, useblock, names = _block_grid_info(cidxs, problem)
        block_keys = sorted(subsz.keys())
        nrows = sum(len(cons[ci].samples) for ci in cidxs)

        # constraint rows in order
        rowptr = {}
        row = 0
        for ci in cidxs:
            for si in range(len(cons[ci].samples)):
                order_c[(ci, si)] = (j, row)
                rowptr[(ci, si)] = row
                row += 1

        # ---- right-hand side c and free matrix B -------------------------
        c_obj = np.empty(nrows, dtype=object)
        B_obj = np.empty((nrows, nfree), dtype=object)
        B_obj[:, :] = 0
        for ci in cidxs:
            con = cons[ci]
            for si, sample in enumerate(con.samples):
                p = rowptr[(ci, si)]
                c_obj[p] = sample_eval(con.constant, sample, con.scalings[si])
                for k, v in con.freecoeff.items():
                    B_obj[p, free_index[sortkey(k)]] = sample_eval(
                        v, sample, con.scalings[si])
        c_dd = _dd_obj_array(c_obj)
        B_dd = _dd_obj_array(B_obj)

        # ---- scalar pack: 1x1 dense blocks, batched ------------------------
        scalar_names = [nm for nm in block_keys
                        if dense[nm] and nsub[nm] == 1 and subsz[nm] == 1]
        general_names = [nm for nm in block_keys if nm not in scalar_names]
        scalars = None
        if scalar_names:
            nb = len(scalar_names)
            sidx = {nm: i for i, nm in enumerate(scalar_names)}
            a_obj = np.empty((nb, nrows), dtype=object)
            a_obj[...] = 0
            for ci in cidxs:
                con = cons[ci]
                touching = [(bl, m) for bl, m in con.matrixcoeff.items()
                            if sortkey(name_of(bl)) in sidx]
                if not touching:
                    continue
                for si, sample in enumerate(con.samples):
                    p = rowptr[(ci, si)]
                    for bl, m in touching:
                        md = m.to_dense() if isinstance(m, LowRankMatPol) else m
                        ev = sample_eval(md[0, 0], sample, con.scalings[si])
                        bidx = sidx[sortkey(name_of(bl))]
                        a_obj[bidx, p] = hp_add(a_obj[bidx, p], ev)
            C0_obj = np.empty(nb, dtype=object)
            C0_obj[...] = 0
            for nm in scalar_names:
                for bl, m in obj_blocks.get(nm, []):
                    md = m.to_dense() if isinstance(m, LowRankMatPol) else (
                        m if isinstance(m, np.ndarray) else np.array(m, dtype=object))
                    C0_obj[sidx[nm]] = hp_add(C0_obj[sidx[nm]],
                                              md.reshape(-1)[0])
            a_dd = _dd_obj_array(a_obj)
            C0_dd = _dd_obj_array(C0_obj)
            # exact power-of-two equilibration of each 1x1 variable (see
            # ScalarPack.scale): t_k = 2^round(log2 max_p |a_kp|)
            mag = np.max(np.abs(a_dd[0] + a_dd[1]), axis=1)
            with np.errstate(divide="ignore"):
                ex = np.where(mag > 0, np.round(np.log2(
                    np.where(mag > 0, mag, 1.0))), 0.0)
            tscale = np.power(2.0, ex)
            a_dd = tuple(x / tscale[:, None] for x in a_dd)
            C0_dd = tuple(x / tscale for x in C0_dd)
            npad = (-nb) % scalar_pad
            mask = np.ones(nb + npad)
            if npad:
                mask[nb:] = 0.0
                a_dd = tuple(np.pad(x, ((0, npad), (0, 0))) for x in a_dd)
                C0_dd = tuple(np.pad(x, (0, npad)) for x in C0_dd)
                tscale = np.pad(tscale, (0, npad), constant_values=1.0)
            scalars = ScalarPack(
                names=[(names[nm], useblock[nm]) for nm in scalar_names],
                a=a_dd, C=C0_dd, mask=mask, scale=tscale)

        # ---- blocks -------------------------------------------------------
        blocks = []
        for nm in general_names:
            delta = subsz[nm]
            R = nsub[nm]
            n = delta * R
            if dense[nm]:
                n = delta * R  # dense blocks materialize the whole grid
                A_obj = np.empty((nrows, n, n), dtype=object)
                A_obj[...] = 0
                for ci in cidxs:
                    con = cons[ci]
                    touching = [(bl, m) for bl, m in con.matrixcoeff.items()
                                if sortkey(name_of(bl)) == nm]
                    if not touching:
                        continue
                    for si, sample in enumerate(con.samples):
                        p = rowptr[(ci, si)]
                        for bl, m in touching:
                            r, s = subblock_of(bl)
                            md = m.to_dense() if isinstance(m, LowRankMatPol) else m
                            ev = sample_eval(md, sample, con.scalings[si])
                            r0, s0 = (r - 1) * delta, (s - 1) * delta
                            for a in range(ev.shape[0]):
                                for bcol in range(ev.shape[1]):
                                    A_obj[p, r0 + a, s0 + bcol] = hp_add(
                                        A_obj[p, r0 + a, s0 + bcol], ev[a, bcol])
                # symmetrize each row matrix
                for p in range(nrows):
                    for a in range(n):
                        for bcol in range(a):
                            v = hp_mul(Fraction(1, 2),
                                       hp_add(A_obj[p, a, bcol], A_obj[p, bcol, a]))
                            A_obj[p, a, bcol] = v
                            A_obj[p, bcol, a] = v
                A_dd = _dd_obj_array(A_obj)
                blocks.append(BlockData(
                    name=names[nm], use_block=useblock[nm], nsubblocks=R,
                    delta=delta, kind="dense",
                    C=_obj_C(obj_blocks.get(nm, []), R, delta),
                    A=A_dd))
            else:
                # low-rank: dedup embedded columns, build term tables
                col_index: Dict[Tuple, int] = {}
                cols: List[Tuple[int, List]] = []  # (segment r, dd values)
                terms: List[List[Tuple]] = [[] for _ in range(nrows)]

                def _colid(seg: int, vals_dd: Tuple[Tuple[float, float], ...]) -> int:
                    key = (seg, vals_dd)
                    if key not in col_index:
                        col_index[key] = len(cols)
                        cols.append(key)
                    return col_index[key]

                for ci in cidxs:
                    con = cons[ci]
                    touching = [(bl, m) for bl, m in con.matrixcoeff.items()
                                if sortkey(name_of(bl)) == nm]
                    if not touching:
                        continue
                    for si, sample in enumerate(con.samples):
                        p = rowptr[(ci, si)]
                        for bl, m in touching:
                            r, s = subblock_of(bl)
                            lams, vs, ws = sample_eval(m, sample, con.scalings[si])
                            for lam_v, v_vec, w_vec in zip(lams, vs, ws):
                                u_dd = tuple(to_dd(e) for e in v_vec)
                                w_dd = tuple(to_dd(e) for e in w_vec)
                                uidx = _colid(r - 1, u_dd)
                                widx = _colid(s - 1, w_dd)
                                terms[p].append((to_dd(lam_v), widx, uidx))

                m_cols = len(cols)
                Vhi = np.zeros((n, m_cols))
                Vlo = np.zeros((n, m_cols))
                for idx, (seg, vals) in enumerate(cols):
                    for a, (h, l) in enumerate(vals):
                        Vhi[seg * delta + a, idx] = h
                        Vlo[seg * delta + a, idx] = l
                tmax = max((len(t) for t in terms), default=0)
                tmax = max(tmax, 1)
                lam_hi = np.zeros((nrows, tmax))
                lam_lo = np.zeros((nrows, tmax))
                li = np.zeros((nrows, tmax), dtype=np.int32)
                ri = np.zeros((nrows, tmax), dtype=np.int32)
                tmask = np.zeros((nrows, tmax))
                for p, tl in enumerate(terms):
                    for t, (lam_v, widx, uidx) in enumerate(tl):
                        lam_hi[p, t], lam_lo[p, t] = lam_v
                        li[p, t] = widx
                        ri[p, t] = uidx
                        tmask[p, t] = 1.0
                blocks.append(BlockData(
                    name=names[nm], use_block=useblock[nm], nsubblocks=R,
                    delta=delta, kind="lowrank",
                    C=_obj_C(obj_blocks.get(nm, []), R, delta),
                    V=(Vhi, Vlo), lam=(lam_hi, lam_lo), li=li, ri=ri,
                    tmask=tmask))

        clusters.append(ClusterData(nrows=nrows, c=c_dd, B=B_dd, blocks=blocks,
                                    scalars=scalars))
        matrix_coeff_names.append([bd.name for bd in blocks])
        matrix_coeff_blocks.append([(bd.use_block, bd.nsubblocks) for bd in blocks])

    return clusters, b, free_labels, order_c, matrix_coeff_names, matrix_coeff_blocks


def _obj_C(entries, R, delta):
    """Assemble and symmetrize the objective block C[j][l] (interface.jl:993-1012)."""
    n = R * delta
    C_obj = np.empty((n, n), dtype=object)
    C_obj[...] = 0
    for bl, m in entries:
        r, s = subblock_of(bl)
        md = m.to_dense() if isinstance(m, LowRankMatPol) else (
            m if isinstance(m, np.ndarray) else np.array(m, dtype=object))
        if md.ndim == 0:
            md = md.reshape(1, 1)
        r0, s0 = (r - 1) * delta, (s - 1) * delta
        for a in range(md.shape[0]):
            for bcol in range(md.shape[1]):
                C_obj[r0 + a, s0 + bcol] = hp_add(C_obj[r0 + a, s0 + bcol],
                                                  md[a, bcol])
    for a in range(n):
        for bcol in range(a):
            v = hp_mul(Fraction(1, 2), hp_add(C_obj[a, bcol], C_obj[bcol, a]))
            C_obj[a, bcol] = v
            C_obj[bcol, a] = v
    return _dd_obj_array(C_obj)


def _iszero(x):
    if hasattr(x, "is_zero"):
        try:
            return bool(x.is_zero())
        except Exception:
            return False
    try:
        return x == 0
    except Exception:
        return False
