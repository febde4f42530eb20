// eig: the step-length eigensolver of the IPM step on the card (sm_90a),
// with a plain C interface (clrs_eig_lowest, clrs_eig_pairs,
// clrs_eig_pairs_vec, clrs_eig_scratch) loaded by clrs_tpu_torch/dd/
// build.py through ctypes. Neither kernel replaces a Pallas kernel: they
// replace the XLA eigensolvers inside the JAX package's jitted step, so
// that the whole iteration is one CUDA graph with no host read (cuSOLVER,
// through torch.linalg, reads its info on the host).
//
// eig_lowest: the lowest eigenvalue of each float64 member of a [B, n, n]
// batch, the counterpart of jnp.linalg.eigvalsh(A64)[:, 0] (clrs_tpu/
// solver/step.py:1163-1165, the route off the TPU). One block of
// LO_THREADS threads a member:
//  - the member is scaled by 2^-e (e the exponent of max |a_ij|, clamped
//    to [-1000, 1000]), an exact scaling that keeps the squares below
//    overflow and above underflow;
//  - Householder tridiagonalization as LAPACK's dsytd2 does it, lower
//    form, on the full symmetric matrix (the rank-2 update keeps it
//    symmetric bit for bit: v_i w_j + w_i v_j is the same sum both ways);
//    per column: sigma = |x[1:]|^2 and the product S22 v as warp sums
//    (lane l adds the terms l, l + 32, ... from +0, then the halving tree
//    16, 8, 4, 2, 1 of the lanes), one warp a row;
//  - the lowest eigenvalue of the tridiagonal matrix by multisection, as
//    dstebz bisects: from the Gershgorin interval, widened, each round
//    puts 512 shifts x_t = lo + (t + 1) h, h = (hi - lo) / 513, one a
//    thread, counts the eigenvalues <= x_t by the Sturm recurrence
//    q_j = (d_j - e_{j-1}^2 / q_{j-1}) - x (|q| < pivmin taken as
//    -pivmin), and keeps [x_{t*-1}, x_{t*}] around the first shift whose
//    count is >= 1, until hi - lo <= 2^-52 |T| (six rounds from the
//    Gershgorin width) or ten rounds; the eigenvalue is the midpoint,
//    scaled back.
// A column costs two block barriers: one after the product p = tau S22 v,
// one after the rank-2 update. Warp w takes the product's rows w + 16 t,
// two at a time; lane l's terms of p . v are the rows l + 32 t, all of one
// warp, which adds them in order as it forms them, so after the first
// barrier every warp forms kk = (tau / 2) (p . v) from the 32 partials by
// the lane tree (the same bits). In the update warp 0 takes row 0 of S22,
// which is the next column's x, and then forms the next column's
// reflector (sigma, tau, den, e and v, into the other half of a
// double-buffered v) while warps 1-15 update the rest of S22. A lane keeps
// v_j and w_j of its columns in registers.
// The member lives in shared memory while n^2 + 6 n + LO_SCAL doubles fit
// in 227 KB (n <= 167), else in a global scratch slice (the same code
// through a generic pointer: the same op order).
//
// eig_pairs: float32 eigenpairs of each member of a [B, n, n] batch,
// ascending eigenvalues [B, n] and eigenvectors as columns [B, n, n], the
// counterpart of jnp.linalg.eigh(A32) (clrs_tpu/solver/step.py:1123: on
// the TPU, XLA's Jacobi eigensolver for n <= 256), n <= 2048. Two launches:
//  - eig_pairs, one block of 512 threads a member, runs the parallel
//    cyclic Jacobi method on A alone in round-robin order: n is padded to
//    even N with a zero row and column (its pairs have a_pq = 0 and never
//    rotate), and each of the N - 1 rounds of a sweep rotates N / 2
//    disjoint pairs (p, q) at once (positions 0 and ((i - 1 + r) mod
//    (N - 1)) + 1, pair k of positions k and N - 1 - k). A rotation is
//    formed in float64 from a_pp, a_qq, a_pq (Rutishauser: theta = (a_qq -
//    a_pp) / (2 a_pq), t = sign(theta) / (|theta| + sqrt(theta^2 + 1)),
//    c = 1 / sqrt(t^2 + 1), s = t c; identity where a_pq = 0), and each
//    thread owns whole 2 x 2 blocks (pair a's rows, pair b's columns,
//    a >= b): it reads the block, rotates its rows and then its columns in
//    float64, rounds once to float32, writes it and its transpose (so A
//    stays symmetric bit for bit, and no block is read by another thread
//    within the round); a diagonal block takes its closed form (a_pp -
//    t a_pq, a_qq + t a_pq, zeros). Before each sweep, off(A)^2 and, once,
//    ||A||_F^2 are summed in float64 (1024 partials, partial t of the
//    entries t, t + 1024, ..., then their halving tree; thread t holds
//    partials t and t + 512); the sweeps stop when
//    off^2 <= 2^-48 ||A||_F^2 or after 30. Each round's rotations,
//    identities included, go in order to a rotation log in global memory;
//    the kernel leaves there its sweep count and the rank of each
//    eigenvalue (stable: ties by index), and writes the eigenvalues sorted.
//  - eig_pairs_vec replays the log on V = I, in float64 (float32
//    rotations of V lose orthogonality as sqrt(rotations) eps, 2e-5 at
//    n 33): each row of V takes c v1 - s v2, s v1 + c v2 in the same round
//    order. Rows are independent, so a warp takes VR_ROWS rows and a block
//    VR_WARPS warps, over the card; the rotations reach shared memory a
//    chunk of rounds at a time (cp.async, two chunks in flight), so one
//    read serves the block's rows. Then each column goes to its sorted
//    place.
// One barrier a round in the sweep kernel: round r + 1's pair k is (the x
// of pair k + 1, the y of pair k - 1) of round r (edges: pair 0 keeps
// position 0 and takes the x of pair 1; pair P - 1 takes the y of pairs
// P - 1 and P - 2; with P = 2 both come from block (1, 0); with P = 1 the
// next a_pq is the zero the diagonal block wrote), so its a_pq is one entry
// of round r's block (k + 1, k - 1), and its a_pp and a_qq are the closed
// form diagonals of round r. The thread that rotates that block (thread
// k, which takes no other block) forms round r + 1's rotation k from the
// value it holds, with the diagonals that were stored beside round r's
// rotations, and stores the new diagonals beside it (the tables are double
// buffered). A rotation formed for a sweep that then stops is dropped. A
// sits in shared memory with a row stride of N + 1 (the mirrored writes of
// neighbouring blocks, column pa of rows pb, pb + 1, ..., then fall on
// distinct banks) while 4 N (N + 1) bytes and the tables fit (N <= 234),
// else in the log's global scratch. Each thread decodes its blocks once a
// launch (512 threads: 1024 would cap a thread at 64 registers, and the
// block tables spilled). Past N 512 every thread also takes a share of the
// other blocks, and past N 1024 thread k also forms rotation k + 512 (an
// instantiation of its own, so that smaller N keep their registers). The
// log takes 16 bytes a rotation for 30 sweeps: about 240 N^2 bytes a
// member (63 MB at N 512, 1 GB at N 2048).
//
// What bounds them: one SM a member. Each is a chain of dependent steps
// over one matrix, a block barrier between steps (eig_lowest: 2 a column,
// n columns, then n dependent divisions a multisection round; eig_pairs:
// 1 a round, N - 1 rounds a sweep, each round a block rotation and then a
// rotation's three divisions and two square roots on its path; the
// replay: N - 1 dependent rotations a sweep for each row), and each step's
// work is issued by one SM (a round of eig_pairs: P (P + 1) / 2 blocks of
// 24 float64 operations and 8 conversions; a column of eig_lowest: m
// lane trees and m^2 updates), not the bytes (a member is read once) nor
// the card's operations (O(n^3) a member at these n is a few microseconds
// of the card's float64 or float32 rate).
//
// Every operation is one IEEE operation in a fixed order (-fmad=false),
// so the plain versions (dd/kernels.py eig_lowest_plain, eig_pairs_plain,
// eig_pairs_vec_plain) give the same bits.

#include <cuda_runtime.h>

#include <cfloat>

#include "common.cuh"

using namespace clrs;

namespace {

constexpr int LO_THREADS = 512;            // also the shifts of a multisection round
constexpr int LO_WARPS = LO_THREADS / 32;  // 16: a warp's rows r, r + 16 hold two lanes' kk terms
constexpr int LO_COLS = 4;                 // columns j = lane + 32 c a lane keeps in registers
constexpr int LO_MAX_ROUNDS = 10;
constexpr int LO_SCAL = 8 + LO_WARPS + 10 + 32;  // reflector slots, warp partials, bounds, kk's
static_assert(2 * LO_WARPS == 32, "the kk partials follow the product's rows");
constexpr double EPS64 = 2.220446049250313e-16;   // 2^-52

constexpr int PR_SUM = 1024;               // the sums' order: PR_SUM strided partials, then their tree
constexpr int PR_THREADS = PR_SUM / 2;     // each thread adds two of the partials
constexpr int PR_MAX_SWEEPS = 30;
constexpr int PR_MAX_N = 2048;             // P <= 2 PR_THREADS; the replay's shared memory
constexpr int PR_MAXJ = 6;                 // blocks a thread keeps decoded
constexpr double PR_TOL2 = 3.552713678800501e-15;  // 2^-48: off <= 2^-24 ||A||_F

constexpr int VR_WARPS = 4;                // the replay: warps a block
constexpr int VR_ROWS = 2;                 // rows of V a warp
constexpr int VR_STAGE = 96 * 1024;        // bytes of the two staged chunks at most
constexpr int VR_MAX_CHUNK = 16;           // rounds a chunk

// 2^k, exact (k in [-1022, 1023]).
__device__ __forceinline__ double pow2(int k) {
  return __longlong_as_double(static_cast<long long>(1023 + k) << 52);
}

// The halving tree of a warp's lanes: lane 0 ends with
// (((v0 + v16) + (v8 + v24)) + ...), the pairing of off = 16, 8, 4, 2, 1.
__device__ __forceinline__ double lane_tree(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

size_t lo_smem_doubles(int n, bool s_shared) {
  return (s_shared ? static_cast<size_t>(n) * n : 0) + 6 * static_cast<size_t>(n) + LO_SCAL;
}

// Column k's reflector from x = row k of S from column k + 1 (m entries),
// by one warp: sigma = |x[1:]|^2 as a lane sum, then (every lane alike)
// mu, beta; lane 0 stores slot = (tau, den, skip) and e_k; v = (1,
// x[1:] / den).
__device__ __forceinline__ void reflector(const double* x, int m, int lane, double* slot,
                                          double* v, double* ek) {
  double s = 0.0;
  for (int i = 1 + lane; i < m; i += 32) s = s + x[i] * x[i];
  s = __shfl_sync(0xffffffffu, lane_tree(s), 0);
  const double alpha = x[0];
  if (s == 0.0) {
    if (lane == 0) {
      slot[2] = 1.0;
      *ek = alpha;
    }
    return;
  }
  const double mu = sqrt(alpha * alpha + s);
  const double beta = alpha >= 0.0 ? -mu : mu;
  const double den = alpha - beta;
  if (lane == 0) {
    slot[0] = (beta - alpha) / beta;
    slot[1] = den;
    slot[2] = 0.0;
    *ek = beta;
  }
  double xv[LO_COLS];   // loads first, so that the divisions overlap
#pragma unroll
  for (int c = 0; c < LO_COLS; ++c) xv[c] = lane + 32 * c < m ? x[lane + 32 * c] : 1.0;
#pragma unroll
  for (int c = 0; c < LO_COLS; ++c) {
    const int i = lane + 32 * c;
    if (i < m) v[i] = i == 0 ? 1.0 : xv[c] / den;
  }
  for (int i = lane + 32 * LO_COLS; i < m; i += 32) v[i] = x[i] / den;
}

// A block of LO_THREADS threads a member.
__global__ void __launch_bounds__(LO_THREADS, 1)
    eig_lowest(const double* __restrict__ a, double* __restrict__ lam, double* scratch, int n,
               int s_shared) {
  extern __shared__ double sm[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t nn = static_cast<size_t>(n) * n;
  const double* A = a + b * nn;
  if (n == 1) {
    if (tid == 0) lam[b] = A[0];
    return;
  }
  double* S = s_shared ? sm : scratch + b * nn;
  double* vb = s_shared ? sm + nn : sm;  // v of the even columns, then of the odd ones
  double* p = vb + 2 * n;
  double* d = p + n;
  double* e = d + n;
  double* e2 = e + n;
  double* sc = e2 + n;                   // [0..7]: two slots of (tau, den, skip, -)
  double* part = sc + 8;                 // warp partials
  double* bs = part + LO_WARPS;          // lo, hi, -, tol, pivmin, amax
  int* imin = reinterpret_cast<int*>(bs + 8);
  double* kpart = bs + 10;               // the 32 lane partials of p . v

  double m = 0.0;
  for (size_t t = tid; t < nn; t += LO_THREADS) m = fmax(m, fabs(A[t]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmax(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (tid == 0) {
    double mm = 0.0;
    for (int w = 0; w < LO_WARPS; ++w) mm = fmax(mm, part[w]);
    bs[5] = mm;
  }
  __syncthreads();
  const double amax = bs[5];
  if (amax == 0.0) {
    if (tid == 0) lam[b] = 0.0;
    return;
  }
  int ex;
  frexp(amax, &ex);
  ex = min(max(ex, -1000), 1000);
  const double scale = pow2(-ex);
  for (size_t t = tid; t < nn; t += LO_THREADS) S[t] = A[t] * scale;
  __syncthreads();

  // Householder tridiagonalization: column k's reflector from row k (the
  // matrix is symmetric), applied to the trailing (m x m) block S22
  if (warp == 0) reflector(S + 1, n - 1, lane, sc, vb, e);
  __syncthreads();
  for (int k = 0; k < n - 1; ++k) {
    const int m = n - 1 - k;
    const double* slot = sc + 4 * (k & 1);
    double* nslot = sc + 4 * ((k + 1) & 1);
    double* nv = vb + ((k + 1) & 1) * n;
    double* S22 = S + static_cast<size_t>(k + 1) * n + k + 1;
    const bool next = k + 1 < n - 1;
    if (slot[2] != 0.0) {   // no reflector: S22 stays, the next column's x is ready
      if (warp == 0 && next) reflector(S22 + 1, m - 1, lane, nslot, nv, e + k + 1);
      __syncthreads();
      continue;
    }
    const double tau = slot[0];
    const double* v = vb + (k & 1) * n;
    // p = tau S22 v: warp w the rows w + 32 t and w + 16 + 32 t, two at a
    // time; lane 0 also adds p_r v_r to the kk partial of lane r mod 32
    // (those rows all fall to warp w, in increasing order)
    // this lane's columns j = lane + 32 c keep v_j in registers
    double vl[LO_COLS];
#pragma unroll
    for (int c = 0; c < LO_COLS; ++c) vl[c] = lane + 32 * c < m ? v[lane + 32 * c] : 0.0;
    double kp0 = 0.0, kp1 = 0.0;
    for (int r = warp; r < m; r += 2 * LO_WARPS) {
      const int r2 = r + LO_WARPS;
      const bool two = r2 < m;
      const double* row = S22 + static_cast<size_t>(r) * n;
      const double* row2 = row + static_cast<size_t>(LO_WARPS) * n;
      double s = 0.0, s2 = 0.0;
#pragma unroll
      for (int c = 0; c < LO_COLS; ++c) {
        const int j = lane + 32 * c;
        if (j < m) {
          s = s + row[j] * vl[c];
          if (two) s2 = s2 + row2[j] * vl[c];
        }
      }
      for (int j = lane + 32 * LO_COLS; j < m; j += 32) {
        const double vj = v[j];
        s = s + row[j] * vj;
        if (two) s2 = s2 + row2[j] * vj;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {   // the two trees interleaved
        s = s + __shfl_down_sync(0xffffffffu, s, off);
        s2 = s2 + __shfl_down_sync(0xffffffffu, s2, off);
      }
      if (lane == 0) {
        const double pr = tau * s;
        p[r] = pr;
        kp0 = kp0 + pr * v[r];
        if (two) {
          const double pr2 = tau * s2;
          p[r2] = pr2;
          kp1 = kp1 + pr2 * v[r2];
        }
      }
    }
    if (lane == 0) {
      kpart[warp] = kp0;
      kpart[warp + LO_WARPS] = kp1;
    }
    __syncthreads();
    const double kk = (0.5 * tau) * __shfl_sync(0xffffffffu, lane_tree(kpart[lane]), 0);
    // the rank-2 update S22 - (v w^T + w v^T), w = p - kk v: this lane's
    // columns keep w_j in registers too
    double wl[LO_COLS];
#pragma unroll
    for (int c = 0; c < LO_COLS; ++c) wl[c] = lane + 32 * c < m ? p[lane + 32 * c] - kk * vl[c] : 0.0;
    auto update_row = [&](int i) {
      const double vi = v[i], wi = p[i] - kk * vi;
      double* row = S22 + static_cast<size_t>(i) * n;
#pragma unroll
      for (int c = 0; c < LO_COLS; ++c) {
        const int j = lane + 32 * c;
        if (j < m) row[j] = row[j] - (vi * wl[c] + wi * vl[c]);
      }
      for (int j = lane + 32 * LO_COLS; j < m; j += 32) {
        const double wj = p[j] - kk * v[j];
        row[j] = row[j] - (vi * wj + wi * v[j]);
      }
    };
    if (warp == 0) {   // row 0, the next column's x, then its reflector
      update_row(0);
      __syncwarp();
      if (next) reflector(S22 + 1, m - 1, lane, nslot, nv, e + k + 1);
    } else {
      for (int i = warp; i < m; i += LO_WARPS - 1) update_row(i);
    }
    __syncthreads();
  }

  // the tridiagonal matrix (d, e), its Gershgorin interval and pivmin
  double gl = INFINITY, gu = -INFINITY, me2 = 0.0;
  for (int i = tid; i < n; i += LO_THREADS) {
    d[i] = S[static_cast<size_t>(i) * n + i];
    const double el = i > 0 ? fabs(e[i - 1]) : 0.0;
    const double er = i < n - 1 ? fabs(e[i]) : 0.0;
    const double r = el + er;
    gl = fmin(gl, d[i] - r);
    gu = fmax(gu, d[i] + r);
    if (i < n - 1) {
      e2[i] = e[i] * e[i];
      me2 = fmax(me2, e2[i]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    gl = fmin(gl, __shfl_xor_sync(0xffffffffu, gl, off));
    gu = fmax(gu, __shfl_xor_sync(0xffffffffu, gu, off));
    me2 = fmax(me2, __shfl_xor_sync(0xffffffffu, me2, off));
  }
  if (lane == 0) part[warp] = gl;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < LO_WARPS; ++w) gl = fmin(gl, part[w]);
    bs[0] = gl;
  }
  __syncthreads();
  if (lane == 0) part[warp] = gu;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < LO_WARPS; ++w) gu = fmax(gu, part[w]);
    bs[1] = gu;
  }
  __syncthreads();
  if (lane == 0) part[warp] = me2;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < LO_WARPS; ++w) me2 = fmax(me2, part[w]);
    gl = bs[0];
    gu = bs[1];
    const double tnorm = fmax(fabs(gl), fabs(gu));
    const double pivmin = DBL_MIN * fmax(1.0, me2);
    const double wid = ((2.0 * EPS64) * tnorm) * static_cast<double>(n);
    bs[0] = (gl - wid) - 2.0 * pivmin;
    bs[1] = (gu + wid) + 2.0 * pivmin;
    bs[3] = EPS64 * tnorm;
    bs[4] = pivmin;
    *imin = LO_THREADS;
  }
  __syncthreads();

  // multisection: the lowest eigenvalue lies in (lo, hi]
  const double tol = bs[3], pivmin = bs[4];
  for (int round = 0; round < LO_MAX_ROUNDS; ++round) {
    const double lo = bs[0], hi = bs[1];
    if (hi - lo <= tol) break;
    const double h = (hi - lo) / static_cast<double>(LO_THREADS + 1);
    const double xs = lo + static_cast<double>(tid + 1) * h;
    double q = d[0] - xs;
    if (fabs(q) < pivmin) q = -pivmin;
    int c = q <= 0.0;
    for (int j = 1; j < n; ++j) {
      q = (d[j] - e2[j - 1] / q) - xs;
      if (fabs(q) < pivmin) q = -pivmin;
      c += q <= 0.0;
    }
    if (c >= 1) atomicMin(imin, tid);
    __syncthreads();
    if (tid == 0) {
      const int t = *imin;
      bs[1] = t < LO_THREADS ? lo + static_cast<double>(t + 1) * h : hi;
      bs[0] = t > 0 ? lo + static_cast<double>(t) * h : lo;
      *imin = LO_THREADS;
    }
    __syncthreads();
  }
  if (tid == 0) lam[b] = ((bs[0] + bs[1]) * 0.5) * pow2(ex);
}

// ---------------------------------------------------------------------------
// eig_pairs: the sweeps on A (eig_pairs) and the replay on V (eig_pairs_vec)
// ---------------------------------------------------------------------------

// Shared memory of the sweep kernel (bytes): the block sum's partials, two
// tables of a round's rotations (c, s as double2 and p | q << 16 a pair,
// the diagonal after the round a position), then A (float32, row stride
// N + 1) when it fits.
struct PairsLayout {
  size_t red, cs[2], pq[2], dn[2], a, bytes;
};

__host__ __device__ PairsLayout pairs_layout(int n, bool in_smem) {
  const int N = n + (n & 1), P = N / 2;
  PairsLayout L{};
  size_t o = 0;
  L.red = o;
  o += sizeof(double) * (PR_THREADS + 1);
  o = (o + 15) / 16 * 16;
  for (int h = 0; h < 2; ++h) {
    L.cs[h] = o;
    o += 2 * sizeof(double) * P;
  }
  for (int h = 0; h < 2; ++h) {
    L.pq[h] = o;
    o += sizeof(int) * P;
  }
  for (int h = 0; h < 2; ++h) {
    L.dn[h] = o;
    o += sizeof(float) * N;
  }
  o = (o + 15) / 16 * 16;
  L.a = o;
  if (in_smem) o += sizeof(float) * static_cast<size_t>(N) * (N + 1);
  L.bytes = o;
  return L;
}

// A member's slice of the rotation log (in doubles): (c, s) of round g's
// pair k at 2 (g P + k) for g < PR_MAX_SWEEPS (N - 1), then the sweep
// count, the n ranks, and A (float32, row stride N + 1) past shared memory.
struct LogLayout {
  long long meta, a, per;
};

__host__ __device__ LogLayout log_layout(int n, bool in_smem) {
  const long long N = n + (n & 1), P = N / 2;
  LogLayout L{};
  L.meta = 2 * PR_MAX_SWEEPS * (N - 1) * P;
  L.a = (L.meta + 1 + n + 1) / 2 * 2;
  L.per = L.a + (in_smem ? 0 : (N * (N + 1) + 3) / 4 * 2);
  return L;
}

bool pairs_in_smem(int n) { return pairs_layout(n, true).bytes <= SMEM_MAX; }

// The halving tree of PR_SUM partials p[t] (p[t] + p[t + 512] first,
// then shared levels down to 32, then a warp's lanes), thread t holding
// v = p[t] + p[t + 512]; every thread returns the sum.
__device__ double block_sum(double v, double* red) {
  constexpr int H = PR_THREADS;
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int off = H / 2; off >= 32; off >>= 1) {
    if (tid < off) red[tid] = red[tid] + red[tid + off];
    __syncthreads();
  }
  if (tid < 32) {
    const double r = lane_tree(red[tid]);
    if (tid == 0) red[H] = r;
  }
  __syncthreads();
  const double r = red[H];
  __syncthreads();
  return r;
}

// The position of slot i in round r (0 <= r < N - 1).
__device__ __forceinline__ int rr_pos(int i, int r, int N) {
  if (i == 0) return 0;
  int x = i - 1 + r;
  if (x >= N - 1) x -= N - 1;
  return x + 1;
}

// The block (ia >= ib) of round r that holds round r + 1's a_pq of pair k
// (dd/kernels.py jacobi_next_block).
__device__ __forceinline__ void next_block(int k, int P, int& ia, int& ib) {
  if (P == 1) {
    ia = ib = 0;
  } else if (k == 0) {
    ia = 1;
    ib = 0;
  } else if (k == P - 1) {
    ia = P - 1;
    ib = P - 2;
  } else {
    ia = k + 1;
    ib = k - 1;
  }
}

__device__ __forceinline__ bool is_next_block(int ia, int ib, int P) {
  return P == 1 || (ia == 1 && ib == 0) || (ia == P - 1 && ib == P - 2) || ia - ib == 2;
}

// Pair k's rotation of (p, q) from a_pp, a_qq, a_pq into table h, and the
// diagonal after it.
__device__ __forceinline__ void form(int k, int p, int q, double app, double aqq, double apq,
                                     double2* cs, int* pq, float* dn) {
  double c = 1.0, s = 0.0, t = 0.0;
  if (apq != 0.0) {
    const double theta = (aqq - app) / (2.0 * apq);
    const double at = fabs(theta);
    t = 1.0 / (at + sqrt(at * at + 1.0));
    if (theta < 0.0) t = -t;
    c = 1.0 / sqrt(t * t + 1.0);
    s = t * c;
  }
  cs[k] = make_double2(c, s);
  pq[k] = p | q << 16;
  dn[p] = static_cast<float>(app - t * apq);
  dn[q] = static_cast<float>(aqq + t * apq);
}

__device__ __forceinline__ void decode_block(int u, int& ia, int& ib) {
  ia = static_cast<int>((sqrtf(8.0f * u + 1.0f) - 1.0f) * 0.5f);
  while (ia * (ia + 1) / 2 > u) --ia;
  while ((ia + 1) * (ia + 2) / 2 <= u) ++ia;
  ib = u - ia * (ia + 1) / 2;
}

// An off-diagonal block (pair a's rows pa, qa, pair b's columns pb, qb)
// of a round: its rotations and its entries.
struct Blk {
  int pa, qa, pb, qb;
  double2 ra, rb;
  float x11, x12, x21, x22;
};

__device__ __forceinline__ Blk load_block(const float* As, int ld, int ia, int ib,
                                          const double2* cs, const int* pq) {
  Blk k;
  const int pqa = pq[ia], pqb = pq[ib];
  k.pa = pqa & 0xffff;
  k.qa = pqa >> 16;
  k.pb = pqb & 0xffff;
  k.qb = pqb >> 16;
  k.ra = cs[ia];
  k.rb = cs[ib];
  const float* rpa = As + static_cast<size_t>(k.pa) * ld;
  const float* rqa = As + static_cast<size_t>(k.qa) * ld;
  k.x11 = rpa[k.pb];
  k.x12 = rpa[k.qb];
  k.x21 = rqa[k.pb];
  k.x22 = rqa[k.qb];
  return k;
}

// The block rotated by rows, then columns, in float64, rounded once,
// written with its transpose and returned in z (z11, z12, z21, z22).
__device__ __forceinline__ void rotate_block(float* As, int ld, const Blk& k, float z[4]) {
  const double ca = k.ra.x, sa = k.ra.y, cb = k.rb.x, sb = k.rb.y;
  const double x11 = k.x11, x12 = k.x12, x21 = k.x21, x22 = k.x22;
  const double y11 = ca * x11 - sa * x21, y12 = ca * x12 - sa * x22;
  const double y21 = sa * x11 + ca * x21, y22 = sa * x12 + ca * x22;
  z[0] = static_cast<float>(cb * y11 - sb * y12);
  z[1] = static_cast<float>(sb * y11 + cb * y12);
  z[2] = static_cast<float>(cb * y21 - sb * y22);
  z[3] = static_cast<float>(sb * y21 + cb * y22);
  float* rpa = As + static_cast<size_t>(k.pa) * ld;
  float* rqa = As + static_cast<size_t>(k.qa) * ld;
  float* rpb = As + static_cast<size_t>(k.pb) * ld;
  float* rqb = As + static_cast<size_t>(k.qb) * ld;
  rpa[k.pb] = z[0];
  rpa[k.qb] = z[1];
  rqa[k.pb] = z[2];
  rqa[k.qb] = z[3];
  rpb[k.pa] = z[0];
  rqb[k.pa] = z[1];
  rpb[k.qa] = z[2];
  rqb[k.qa] = z[3];
}

// A diagonal block takes its closed form: the diagonals stored with the
// round's rotation, zeros off the diagonal.
__device__ __forceinline__ void diag_block(float* As, int ld, int ia, const int* pq,
                                           const float* dn) {
  const int pqa = pq[ia], pa = pqa & 0xffff, qa = pqa >> 16;
  float* rpa = As + static_cast<size_t>(pa) * ld;
  float* rqa = As + static_cast<size_t>(qa) * ld;
  rpa[pa] = dn[pa];
  rqa[qa] = dn[qa];
  rpa[qa] = 0.0f;
  rqa[pa] = 0.0f;
}

// One of a thread's other blocks (ia | ib << 16).
__device__ __forceinline__ void other_block(float* As, int ld, int c, const double2* cs,
                                            const int* pq, const float* dn) {
  const int ia = c & 0xffff, ib = c >> 16;
  if (ia == ib) {
    diag_block(As, ld, ia, pq, dn);
  } else {
    float z[4];
    rotate_block(As, ld, load_block(As, ld, ia, ib, cs, pq), z);
  }
}

// TWO: P > PR_THREADS, so that a thread forms two rotations a round.
template <bool TWO>
__global__ void __launch_bounds__(PR_THREADS)
    eig_pairs(const float* __restrict__ a, float* __restrict__ lam, double* rotlog, int n,
              long long per, int in_smem) {
  extern __shared__ __align__(16) unsigned char smb[];
  const int N = n + (n & 1), P = N / 2, ld = N + 1, b = blockIdx.x, tid = threadIdx.x;
  const size_t NN = static_cast<size_t>(N) * N;
  const PairsLayout L = pairs_layout(n, in_smem != 0);
  const LogLayout LL = log_layout(n, in_smem != 0);
  double* red = reinterpret_cast<double*>(smb + L.red);
  double* lg = rotlog + b * per;
  double2* rot = reinterpret_cast<double2*>(lg);
  double* meta = lg + LL.meta;
  float* As = in_smem ? reinterpret_cast<float*>(smb + L.a) : reinterpret_cast<float*>(lg + LL.a);
  const float* Ab = a + static_cast<size_t>(b) * n * n;

  // partials of the entries t + PR_SUM k and t + PR_THREADS + PR_SUM k
  auto load = [&](size_t t) {
    const int i = static_cast<int>(t / N), j = static_cast<int>(t % N);
    const float x = i < n && j < n ? Ab[static_cast<size_t>(i) * n + j] : 0.0f;
    As[static_cast<size_t>(i) * ld + j] = x;
    return static_cast<double>(x) * static_cast<double>(x);
  };
  double f0 = 0.0, f1 = 0.0;
  for (size_t t = tid; t < NN; t += PR_SUM) {
    f0 = f0 + load(t);
    if (t + PR_THREADS < NN) f1 = f1 + load(t + PR_THREADS);
  }
  const double fro2 = block_sum(f0 + f1, red);   // its barriers publish As
  auto off2 = [&](size_t t) {
    const int i = static_cast<int>(t / N), j = static_cast<int>(t % N);
    const double x = static_cast<double>(As[static_cast<size_t>(i) * ld + j]);
    return i != j ? x * x : 0.0;
  };
  {  // round 0's rotations from A, into table 0
    double2* cs = reinterpret_cast<double2*>(smb + L.cs[0]);
    int* pq = reinterpret_cast<int*>(smb + L.pq[0]);
    float* dn = reinterpret_cast<float*>(smb + L.dn[0]);
    for (int k = tid; k < P; k += PR_THREADS) {
      const int x = rr_pos(k, 0, N), y = rr_pos(N - 1 - k, 0, N);
      const int p = min(x, y), q = max(x, y);
      form(k, p, q, As[static_cast<size_t>(p) * ld + p], As[static_cast<size_t>(q) * ld + q],
           As[static_cast<size_t>(p) * ld + q], cs, pq, dn);
    }
  }
  // this thread's blocks: thread k the block of the next rotation k, and
  // of k + PR_THREADS past N 1024 (with P = 2 thread 0 forms both); the
  // rest in triangle order, one at a time (two in flight spilled), by the
  // threads from P up while P <= PR_THREADS / 2, else by every thread
  const int nblk = P * (P + 1) / 2;
  const bool wide = P > PR_THREADS / 2;
  const int first = wide ? tid : tid - P, stride = wide ? PR_THREADS : PR_THREADS - P;
  const bool others = wide || tid >= P;
  int kia = -1, kib = -1, kia2 = -1, kib2 = -1;
  if (tid < P && !(P == 2 && tid == 1)) next_block(tid, P, kia, kib);
  if (TWO && tid + PR_THREADS < P) next_block(tid + PR_THREADS, P, kia2, kib2);
  int blk[PR_MAXJ];
#pragma unroll
  for (int j = 0; j < PR_MAXJ; ++j) {
    const int u = first + j * stride;
    blk[j] = -1;
    if (others && u < nblk) {
      int ia, ib;
      decode_block(u, ia, ib);
      if (!is_next_block(ia, ib, P)) blk[j] = ia | ib << 16;
    }
  }

  int g = 0, sweeps = 0;
  for (int sweep = 0; sweep < PR_MAX_SWEEPS; ++sweep) {
    double o0 = 0.0, o1 = 0.0;
    for (size_t t = tid; t < NN; t += PR_SUM) {
      o0 = o0 + off2(t);
      if (t + PR_THREADS < NN) o1 = o1 + off2(t + PR_THREADS);
    }
    if (block_sum(o0 + o1, red) <= PR_TOL2 * fro2) break;
    ++sweeps;
    for (int r = 0; r < N - 1; ++r, ++g) {
      const int h = g & 1;
      const double2* cs = reinterpret_cast<const double2*>(smb + L.cs[h]);
      const int* pq = reinterpret_cast<const int*>(smb + L.pq[h]);
      const float* dn = reinterpret_cast<const float*>(smb + L.dn[h]);
      for (int k = PR_THREADS - 1 - tid; k < P; k += PR_THREADS)
        rot[static_cast<size_t>(g) * P + k] = cs[k];
      // the block of the next rotations k0..k1 of round r + 1, then those
      const int rn = r + 1 == N - 1 ? 0 : r + 1;
      auto ahead = [&](int ia, int ib, int k0, int k1) {
        float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        int pa = 0, qa = 0, pb = 0, qb = 0;
        if (ia == ib) {
          diag_block(As, ld, ia, pq, dn);
        } else {
          const Blk kb = load_block(As, ld, ia, ib, cs, pq);
          rotate_block(As, ld, kb, z);
          pa = kb.pa;
          qa = kb.qa;
          pb = kb.pb;
          qb = kb.qb;
        }
        double2* ncs = reinterpret_cast<double2*>(smb + L.cs[h ^ 1]);
        int* npq = reinterpret_cast<int*>(smb + L.pq[h ^ 1]);
        float* ndn = reinterpret_cast<float*>(smb + L.dn[h ^ 1]);
        for (int k = k0; k <= k1; ++k) {
          const int x = rr_pos(k, rn, N), y = rr_pos(N - 1 - k, rn, N);
          const bool xa = x == pa || x == qa;
          const int rw = xa ? x : y, cl = xa ? y : x;
          const float apq = rw == pa ? (cl == pb ? z[0] : z[1]) : (cl == pb ? z[2] : z[3]);
          const int p = min(x, y), q = max(x, y);
          form(k, p, q, dn[p], dn[q], ia == ib ? 0.0 : static_cast<double>(apq), ncs, npq, ndn);
        }
      };
      if (kia >= 0) ahead(kia, kib, tid, P == 2 ? 1 : tid);
      if (TWO && kia2 >= 0) ahead(kia2, kib2, tid + PR_THREADS, tid + PR_THREADS);
#pragma unroll
      for (int j = 0; j < PR_MAXJ; ++j)
        if (blk[j] >= 0) other_block(As, ld, blk[j], cs, pq, dn);
      for (int u = first + PR_MAXJ * stride; others && u < nblk; u += stride) {
        int ia, ib;
        decode_block(u, ia, ib);
        if (!is_next_block(ia, ib, P)) other_block(As, ld, ia | ib << 16, cs, pq, dn);
      }
      __syncthreads();
    }
  }

  // eigenvalues and their ranks (stable: ties by index)
  float* dg = reinterpret_cast<float*>(smb + L.dn[0]);
  for (int i = tid; i < n; i += PR_THREADS) dg[i] = As[static_cast<size_t>(i) * ld + i];
  __syncthreads();
  for (int i = tid; i < n; i += PR_THREADS) {
    const float li = dg[i];
    int r = 0;
    for (int j = 0; j < n; ++j) r += dg[j] < li || (dg[j] == li && j < i);
    meta[1 + i] = r;
    lam[static_cast<size_t>(b) * n + r] = li;
  }
  if (tid == 0) meta[0] = sweeps;
}

int vr_chunk(int P) {
  const int c = VR_STAGE / (2 * static_cast<int>(sizeof(double2)) * P);
  return c < 1 ? 1 : c > VR_MAX_CHUNK ? VR_MAX_CHUNK : c;
}

size_t vr_bytes(int n) {
  const int N = n + (n & 1), P = N / 2;
  return 2 * sizeof(double2) * vr_chunk(P) * P + sizeof(double) * VR_WARPS * VR_ROWS * N;
}

// The replay: block (x, b) takes rows x VR_WARPS VR_ROWS, ... of member b's
// V; each warp its VR_ROWS rows, lane l the pairs l, l + 32, ... of a round.
__global__ void __launch_bounds__(VR_WARPS * 32)
    eig_pairs_vec(const double* __restrict__ rotlog, float* __restrict__ vec, int n, long long per,
                  int chunk) {
  extern __shared__ __align__(16) unsigned char smb[];
  const int N = n + (n & 1), P = N / 2, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const double* lg = rotlog + b * per;
  const double2* rot = reinterpret_cast<const double2*>(lg);
  const double* meta = lg + log_layout(n, true).meta;
  const int rounds = static_cast<int>(meta[0]) * (N - 1);
  double2* stage = reinterpret_cast<double2*>(smb);
  double* R = reinterpret_cast<double*>(smb + 2 * sizeof(double2) * chunk * P) +
              warp * VR_ROWS * N;
  const int row0 = (blockIdx.x * VR_WARPS + warp) * VR_ROWS;
  for (int rr = 0; rr < VR_ROWS; ++rr)
    for (int j = lane; j < N; j += 32) R[rr * N + j] = row0 + rr == j ? 1.0 : 0.0;
  __syncwarp();
  const int per_chunk = chunk * P, total = rounds * P, nch = (rounds + chunk - 1) / chunk;
  auto issue = [&](int c) {
    const int base = c * per_chunk;
    double2* dst = stage + (c & 1) * per_chunk;
    for (int i = tid; i < per_chunk && base + i < total; i += VR_WARPS * 32)
      cp_async_zfill<16>(dst + i, rot + base + i, true);
    cp_async_commit();
  };
  if (nch > 0) issue(0);
  int rm = 0;   // the round mod N - 1
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      issue(c + 1);
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();
    const double2* st = stage + (c & 1) * per_chunk;
    const int nr = min(chunk, rounds - c * chunk);
    for (int r = 0; r < nr; ++r) {
      // lane l: pairs l and l + 32 of each 64 together, all loads first
      for (int k0 = lane; k0 < P; k0 += 64) {
        const int k1 = k0 + 32;
        const bool two = k1 < P;
        const double2 c0 = st[r * P + k0];
        const double2 c1 = two ? st[r * P + k1] : c0;
        int x = rr_pos(k0, rm, N), y = rr_pos(N - 1 - k0, rm, N);
        const int p0 = min(x, y), q0 = max(x, y);
        x = two ? rr_pos(k1, rm, N) : x;
        y = two ? rr_pos(N - 1 - k1, rm, N) : y;
        const int p1 = min(x, y), q1 = max(x, y);
        double v[VR_ROWS][4];
#pragma unroll
        for (int rr = 0; rr < VR_ROWS; ++rr) {
          v[rr][0] = R[rr * N + p0];
          v[rr][1] = R[rr * N + q0];
          v[rr][2] = R[rr * N + p1];
          v[rr][3] = R[rr * N + q1];
        }
#pragma unroll
        for (int rr = 0; rr < VR_ROWS; ++rr) {
          R[rr * N + p0] = c0.x * v[rr][0] - c0.y * v[rr][1];
          R[rr * N + q0] = c0.y * v[rr][0] + c0.x * v[rr][1];
          if (two) {
            R[rr * N + p1] = c1.x * v[rr][2] - c1.y * v[rr][3];
            R[rr * N + q1] = c1.y * v[rr][2] + c1.x * v[rr][3];
          }
        }
      }
      __syncwarp();
      rm = rm + 1 == N - 1 ? 0 : rm + 1;
    }
    __syncthreads();   // the chunk's buffer is free for chunk c + 2
  }
  float* Vb = vec + static_cast<size_t>(b) * n * n;
  for (int rr = 0; rr < VR_ROWS; ++rr) {
    const int row = row0 + rr;
    if (row >= n) break;
    for (int i = lane; i < n; i += 32)
      Vb[static_cast<size_t>(row) * n + static_cast<int>(meta[1 + i])] =
          static_cast<float>(R[rr * N + i]);
  }
}

}  // namespace

extern "C" {

// Scratch doubles a member needs in global memory. kind 0, eig_lowest: 0
// while shared memory holds the member, else n^2. kind 1, eig_pairs: the
// rotation log, the sweep count and the ranks, and A past shared memory
// (-1 past PR_MAX_N).
long long clrs_eig_scratch(int kind, int n) {
  if (kind == 0)
    return lo_smem_doubles(n, true) * sizeof(double) <= SMEM_MAX ? 0
                                                                 : static_cast<long long>(n) * n;
  if (n <= 0 || n > PR_MAX_N) return -1;
  return log_layout(n, pairs_in_smem(n)).per;
}

// a: [B, n, n] float64, finite and symmetric; lam: [B]; scratch: B x
// clrs_eig_scratch(0, n) doubles, or null when that is 0.
int clrs_eig_lowest(const double* a, double* lam, double* scratch, int B, int n, void* stream) {
  static unsigned long long opted = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool s_shared = clrs_eig_scratch(0, n) == 0;
  if (!s_shared && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaGetDevice(&dev);
  const cudaError_t e = smem_opt_in(eig_lowest, opted, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t bytes = lo_smem_doubles(n, s_shared) * sizeof(double);
  eig_lowest<<<B, LO_THREADS, bytes, s>>>(a, lam, scratch, n, s_shared ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// The sweeps. a: [B, n, n] float32, finite and symmetric, n <= PR_MAX_N;
// lam: [B, n], sorted; rotlog: B x clrs_eig_scratch(1, n) doubles (16-byte
// aligned), for clrs_eig_pairs_vec.
int clrs_eig_pairs(const float* a, float* lam, double* rotlog, int B, int n, void* stream) {
  static unsigned long long opted[2] = {0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n <= 0 || n > PR_MAX_N || rotlog == nullptr || !aligned(rotlog, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool in_smem = pairs_in_smem(n), two = (n + (n & 1)) / 2 > PR_THREADS;
  auto kernel = two ? eig_pairs<true> : eig_pairs<false>;
  int dev = 0;
  cudaGetDevice(&dev);
  const cudaError_t e = smem_opt_in(kernel, opted[two], dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, PR_THREADS, pairs_layout(n, in_smem).bytes, s>>>(
      a, lam, rotlog, n, log_layout(n, in_smem).per, in_smem ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// The replay. rotlog: what clrs_eig_pairs left for the same B and n; vec:
// [B, n, n], eigenvectors as columns in the eigenvalues' order.
int clrs_eig_pairs_vec(const double* rotlog, float* vec, int B, int n, void* stream) {
  static unsigned long long opted = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n <= 0 || n > PR_MAX_N || B > 65535 || rotlog == nullptr || !aligned(rotlog, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaGetDevice(&dev);
  const cudaError_t e = smem_opt_in(eig_pairs_vec, opted, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int N = n + (n & 1), rows = VR_WARPS * VR_ROWS;
  if (vr_bytes(n) > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + rows - 1) / rows, B);
  eig_pairs_vec<<<grid, VR_WARPS * 32, vr_bytes(n), s>>>(rotlog, vec, n, clrs_eig_scratch(1, n),
                                                        vr_chunk(N / 2));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
