// eig: the step-length eigensolver of the IPM step on the card (sm_90a),
// with a plain C interface (clrs_eig_lowest, clrs_eig_pairs,
// clrs_eig_scratch) loaded by clrs_tpu_torch/dd/build.py through ctypes.
// Neither kernel replaces a Pallas kernel: they replace the XLA
// eigensolvers inside the JAX package's jitted step, so that the whole
// iteration is one CUDA graph with no host read (cuSOLVER, through
// torch.linalg, reads its info on the host).
//
// eig_lowest: the lowest eigenvalue of each float64 member of a [B, n, n]
// batch, the counterpart of jnp.linalg.eigvalsh(A64)[:, 0] (clrs_tpu/
// solver/step.py:1163-1165, the route off the TPU). One block of 512
// threads a member:
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
//    thread, counts the eigenvalues <= x_t by the Sturm recurrence q_j =
//    (d_j - e_{j-1}^2 / q_{j-1}) - x (|q| < pivmin taken as -pivmin), and
//    keeps [x_{t*-1}, x_{t*}] around the first shift whose count is >= 1,
//    until hi - lo <= 2^-52 |T| (six rounds from the Gershgorin width) or
//    ten rounds; the eigenvalue is the midpoint, scaled back.
// The member lives in shared memory while n^2 + 5 n + 40 doubles fit in
// 227 KB (n <= 167), else in a global scratch slice (the same code
// through a generic pointer: the same op order).
//
// eig_pairs: float32 eigenpairs of each member of a [B, n, n] batch,
// ascending eigenvalues [B, n] and eigenvectors as columns [B, n, n], the
// counterpart of jnp.linalg.eigh(A32) (clrs_tpu/solver/step.py:1123: on
// the TPU, XLA's Jacobi eigensolver for n <= 256). One block of 1024
// threads a member; the parallel cyclic Jacobi method in round-robin
// order: n is padded to even N with a zero row and column (its pairs
// have a_pq = 0 and never rotate), and each of the N - 1 rounds of a
// sweep rotates N / 2 disjoint pairs (p, q) at once (positions 0 and
// ((i - 1 + r) mod (N - 1)) + 1, pair k of positions k and N - 1 - k):
//  - thread k forms pair k's rotation in float64 from a_pp, a_qq, a_pq
//    (Rutishauser: theta = (a_qq - a_pp) / (2 a_pq), t = sign(theta) /
//    (|theta| + sqrt(theta^2 + 1)), c = 1 / sqrt(t^2 + 1), s = t c;
//    identity where a_pq = 0);
//  - each thread then owns whole 2 x 2 blocks (pair a's rows, pair b's
//    columns, a >= b): it reads the block, rotates its rows and then its
//    columns in float64, rounds once to float32, writes it and its
//    transpose (so A stays symmetric bit for bit, and no block is read by
//    another thread within the round); a diagonal block takes its closed
//    form (a_pp - t a_pq, a_qq + t a_pq, zeros); and it rotates pairs of
//    columns of V, which is kept in float64: float32 rotations of V lose
//    orthogonality as sqrt(rotations) eps (2e-5 at n 33), float64 ones
//    leave only the final rounding (about sqrt(n) 2^-24);
//  - before each sweep, off(A)^2 and, once, ||A||_F^2 are summed in
//    float64 (thread t adds entries t, t + 1024, ..., then the halving
//    tree of the threads); the sweeps stop when off^2 <= 2^-48 ||A||_F^2
//    or after 30;
//  - the eigenvalues are sorted by rank (stable: ties by index) and each
//    eigenvector moves with its eigenvalue.
// A (float32) and V (float64) live in shared memory while 12 N^2 bytes
// and the block's reduction and pair tables fit (N <= 134), else in a
// global scratch.
//
// What bounds them: both are chains of dependent steps over one matrix,
// a block barrier between steps (eig_lowest: about 4 a column, n columns,
// then n dependent divisions a multisection round; eig_pairs: 2 a round,
// N - 1 rounds a sweep), not the bytes (a member is read once) nor the
// operations (O(n^3) a member at these n is a few microseconds of the
// card's float64 or float32 rate). The design keeps each step's work
// spread over the block and the matrix in shared memory; a member a block,
// so a batch of B members fills B SMs.
//
// Every operation is one IEEE operation in a fixed order (-fmad=false),
// so the plain versions (dd/kernels.py eig_lowest_plain, eig_pairs_plain)
// give the same bits.

#include <cuda_runtime.h>

#include <cfloat>

#include "common.cuh"

using namespace clrs;

namespace {

constexpr int LO_THREADS = 512;            // also the shifts of a round
constexpr int LO_WARPS = LO_THREADS / 32;
constexpr int LO_MAX_ROUNDS = 10;
constexpr int LO_SCAL = 40;                // scalars and warp partials
constexpr double EPS64 = 2.220446049250313e-16;   // 2^-52

constexpr int PR_THREADS = 1024;
constexpr int PR_MAX_SWEEPS = 30;
constexpr double PR_TOL2 = 3.552713678800501e-15;  // 2^-48: off <= 2^-24 ||A||_F

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
  return (s_shared ? static_cast<size_t>(n) * n : 0) + 5 * static_cast<size_t>(n) + LO_SCAL;
}

// A block of LO_THREADS threads a member.
__global__ void __launch_bounds__(LO_THREADS)
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
  double* v = s_shared ? sm + nn : sm;
  double* p = v + n;
  double* d = p + n;
  double* e = d + n;
  double* e2 = e + n;
  double* sc = e2 + n;   // [0..7]: two slots of (tau, den, skip, kk); [8..23] warp partials
  double* part = sc + 8;
  double* bs = sc + 24;  // lo, hi, h, tol, pivmin, amax
  int* imin = reinterpret_cast<int*>(sc + 32);

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
  // matrix is symmetric), applied to the trailing (m x m) block
  for (int k = 0; k < n - 1; ++k) {
    const int m = n - 1 - k;
    const double* x = S + static_cast<size_t>(k) * n + k + 1;
    double* slot = sc + 4 * (k & 1);
    if (warp == 0) {
      double s = 0.0;
      for (int i = 1 + lane; i < m; i += 32) s = s + x[i] * x[i];
      s = lane_tree(s);
      if (lane == 0) {
        const double alpha = x[0];
        if (s == 0.0) {
          slot[2] = 1.0;
          e[k] = alpha;
        } else {
          const double mu = sqrt(alpha * alpha + s);
          const double beta = alpha >= 0.0 ? -mu : mu;
          slot[0] = (beta - alpha) / beta;
          slot[1] = alpha - beta;
          slot[2] = 0.0;
          e[k] = beta;
        }
      }
    }
    __syncthreads();
    if (slot[2] != 0.0) continue;
    const double tau = slot[0], den = slot[1];
    for (int i = tid; i < m; i += LO_THREADS) v[i] = i == 0 ? 1.0 : x[i] / den;
    __syncthreads();
    double* S22 = S + static_cast<size_t>(k + 1) * n + k + 1;
    for (int r = warp; r < m; r += LO_WARPS) {
      const double* row = S22 + static_cast<size_t>(r) * n;
      double s = 0.0;
      for (int j = lane; j < m; j += 32) s = s + row[j] * v[j];
      s = lane_tree(s);
      if (lane == 0) p[r] = tau * s;
    }
    __syncthreads();
    if (warp == 0) {
      double s = 0.0;
      for (int i = lane; i < m; i += 32) s = s + p[i] * v[i];
      s = lane_tree(s);
      if (lane == 0) slot[3] = (0.5 * tau) * s;
    }
    __syncthreads();
    const double kk = slot[3];
    for (int t = tid; t < m * m; t += LO_THREADS) {
      const int i = t / m, j = t - i * m;
      const double wi = p[i] - kk * v[i];
      const double wj = p[j] - kk * v[j];
      double* q = S22 + static_cast<size_t>(i) * n + j;
      *q = *q - (v[i] * wj + wi * v[j]);
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
  __syncthreads();  // part[] was read by tid 0 above
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
// eig_pairs
// ---------------------------------------------------------------------------

struct PairsLayout {
  size_t red, pc, ps, pt, pp, pq, dg, rk, v, a, bytes;
};

__host__ __device__ PairsLayout pairs_layout(int n, bool in_smem) {
  const int N = n + (n & 1), P = N / 2;
  const size_t NN = static_cast<size_t>(N) * N;
  PairsLayout L{};
  size_t o = 0;
  L.red = o; o += sizeof(double) * (PR_THREADS + 8);
  L.pc = o; o += sizeof(double) * P;
  L.ps = o; o += sizeof(double) * P;
  L.pt = o; o += sizeof(double) * P;
  L.pp = o; o += sizeof(int) * P;
  L.pq = o; o += sizeof(int) * P;
  L.dg = o; o += sizeof(float) * N;
  L.rk = o; o += sizeof(int) * N;
  o = (o + 15) / 16 * 16;
  L.v = o;
  L.a = o + sizeof(double) * NN;
  if (in_smem) o += (sizeof(double) + sizeof(float)) * NN;
  L.bytes = o;
  return L;
}

// The sum of one double a thread over the block: the halving tree of
// PR_THREADS partials (shared levels down to 32, then a warp's lanes);
// every thread returns it.
__device__ double block_sum(double v, double* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int off = PR_THREADS / 2; off >= 32; off >>= 1) {
    if (tid < off) red[tid] = red[tid] + red[tid + off];
    __syncthreads();
  }
  if (tid < 32) {
    const double r = lane_tree(red[tid]);
    if (tid == 0) red[PR_THREADS] = r;
  }
  __syncthreads();
  const double r = red[PR_THREADS];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(PR_THREADS)
    eig_pairs(const float* __restrict__ a, float* __restrict__ lam, float* __restrict__ vec,
              double* scratch, int n, int in_smem) {
  extern __shared__ __align__(16) unsigned char smb[];
  const int N = n + (n & 1), P = N / 2, b = blockIdx.x, tid = threadIdx.x;
  const size_t NN = static_cast<size_t>(N) * N;
  const PairsLayout L = pairs_layout(n, in_smem != 0);
  double* red = reinterpret_cast<double*>(smb + L.red);
  double* pc = reinterpret_cast<double*>(smb + L.pc);
  double* ps = reinterpret_cast<double*>(smb + L.ps);
  double* pt = reinterpret_cast<double*>(smb + L.pt);
  int* pp = reinterpret_cast<int*>(smb + L.pp);
  int* pq = reinterpret_cast<int*>(smb + L.pq);
  float* dg = reinterpret_cast<float*>(smb + L.dg);
  int* rk = reinterpret_cast<int*>(smb + L.rk);
  // V: float64 [N, N], then A: float32 [N, N]
  double* Vs = in_smem ? reinterpret_cast<double*>(smb + L.v) : scratch + b * 2 * NN;
  float* As = in_smem ? reinterpret_cast<float*>(smb + L.a) : reinterpret_cast<float*>(Vs + NN);
  const float* Ab = a + static_cast<size_t>(b) * n * n;

  double fro = 0.0;
  for (size_t t = tid; t < NN; t += PR_THREADS) {
    const int i = static_cast<int>(t / N), j = static_cast<int>(t % N);
    const float x = i < n && j < n ? Ab[static_cast<size_t>(i) * n + j] : 0.0f;
    As[t] = x;
    Vs[t] = i == j ? 1.0 : 0.0;
    fro = fro + static_cast<double>(x) * static_cast<double>(x);
  }
  const double fro2 = block_sum(fro, red);   // its barriers publish As, Vs
  const int nblk = P * (P + 1) / 2;

  for (int sweep = 0; sweep < PR_MAX_SWEEPS; ++sweep) {
    double off = 0.0;
    for (size_t t = tid; t < NN; t += PR_THREADS) {
      const double x = static_cast<double>(As[t]);
      off = off + (t / N != t % N ? x * x : 0.0);
    }
    if (block_sum(off, red) <= PR_TOL2 * fro2) break;
    for (int r = 0; r < N - 1; ++r) {
      if (tid < P) {
        const int i2 = N - 1 - tid;
        const int x = tid == 0 ? 0 : (tid - 1 + r) % (N - 1) + 1;
        const int y = (i2 - 1 + r) % (N - 1) + 1;
        const int p = min(x, y), q = max(x, y);
        const double app = As[static_cast<size_t>(p) * N + p];
        const double aqq = As[static_cast<size_t>(q) * N + q];
        const double apq = As[static_cast<size_t>(p) * N + q];
        double c = 1.0, s = 0.0, t = 0.0;
        if (apq != 0.0) {
          const double theta = (aqq - app) / (2.0 * apq);
          const double at = fabs(theta);
          t = 1.0 / (at + sqrt(at * at + 1.0));
          if (theta < 0.0) t = -t;
          c = 1.0 / sqrt(t * t + 1.0);
          s = t * c;
        }
        pc[tid] = c;
        ps[tid] = s;
        pt[tid] = t;
        pp[tid] = p;
        pq[tid] = q;
      }
      __syncthreads();
      for (int u = tid; u < nblk + N * P; u += PR_THREADS) {
        if (u < nblk) {
          int ia = static_cast<int>((sqrtf(8.0f * u + 1.0f) - 1.0f) * 0.5f);
          while (ia * (ia + 1) / 2 > u) --ia;
          while ((ia + 1) * (ia + 2) / 2 <= u) ++ia;
          const int ib = u - ia * (ia + 1) / 2;
          const int pa = pp[ia], qa = pq[ia];
          float* rpa = As + static_cast<size_t>(pa) * N;
          float* rqa = As + static_cast<size_t>(qa) * N;
          if (ia == ib) {
            const double apq = rpa[qa], t = pt[ia];
            rpa[pa] = static_cast<float>(static_cast<double>(rpa[pa]) - t * apq);
            rqa[qa] = static_cast<float>(static_cast<double>(rqa[qa]) + t * apq);
            rpa[qa] = 0.0f;
            rqa[pa] = 0.0f;
            continue;
          }
          const int pb = pp[ib], qb = pq[ib];
          float* rpb = As + static_cast<size_t>(pb) * N;
          float* rqb = As + static_cast<size_t>(qb) * N;
          const double ca = pc[ia], sa = ps[ia], cb = pc[ib], sb = ps[ib];
          const double x11 = rpa[pb], x12 = rpa[qb], x21 = rqa[pb], x22 = rqa[qb];
          const double y11 = ca * x11 - sa * x21, y12 = ca * x12 - sa * x22;
          const double y21 = sa * x11 + ca * x21, y22 = sa * x12 + ca * x22;
          const float z11 = static_cast<float>(cb * y11 - sb * y12);
          const float z12 = static_cast<float>(sb * y11 + cb * y12);
          const float z21 = static_cast<float>(cb * y21 - sb * y22);
          const float z22 = static_cast<float>(sb * y21 + cb * y22);
          rpa[pb] = z11;
          rpa[qb] = z12;
          rqa[pb] = z21;
          rqa[qb] = z22;
          rpb[pa] = z11;
          rqb[pa] = z12;
          rpb[qa] = z21;
          rqb[qa] = z22;
        } else {
          const int w = u - nblk, row = w / P, k = w - row * P;
          const int p = pp[k], q = pq[k];
          const double c = pc[k], s = ps[k];
          double* vr = Vs + static_cast<size_t>(row) * N;
          const double v1 = vr[p], v2 = vr[q];
          vr[p] = c * v1 - s * v2;
          vr[q] = s * v1 + c * v2;
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < n; i += PR_THREADS) dg[i] = As[static_cast<size_t>(i) * N + i];
  __syncthreads();
  for (int i = tid; i < n; i += PR_THREADS) {
    const float li = dg[i];
    int r = 0;
    for (int j = 0; j < n; ++j) r += dg[j] < li || (dg[j] == li && j < i);
    rk[i] = r;
    lam[static_cast<size_t>(b) * n + r] = li;
  }
  __syncthreads();
  float* Vb = vec + static_cast<size_t>(b) * n * n;
  for (size_t t = tid; t < static_cast<size_t>(n) * n; t += PR_THREADS) {
    const int row = static_cast<int>(t / n), i = static_cast<int>(t % n);
    Vb[static_cast<size_t>(row) * n + rk[i]] =
        static_cast<float>(Vs[static_cast<size_t>(row) * N + i]);
  }
}

}  // namespace

extern "C" {

// Scratch doubles a member needs in global memory (0: shared memory
// holds it): kind 0 eig_lowest, kind 1 eig_pairs (V, then A's floats).
long long clrs_eig_scratch(int kind, int n) {
  if (kind == 0)
    return lo_smem_doubles(n, true) * sizeof(double) <= SMEM_MAX ? 0
                                                                 : static_cast<long long>(n) * n;
  const int N = n + (n & 1);
  return pairs_layout(n, true).bytes <= SMEM_MAX ? 0 : 2LL * N * N;   // >= NN + NN / 2
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

// a: [B, n, n] float32, finite and symmetric; lam: [B, n]; vec: [B, n, n];
// scratch: B x clrs_eig_scratch(1, n) doubles, or null when that is 0.
int clrs_eig_pairs(const float* a, float* lam, float* vec, double* scratch, int B, int n,
                   void* stream) {
  static unsigned long long opted = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool in_smem = clrs_eig_scratch(1, n) == 0;
  if (!in_smem && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaGetDevice(&dev);
  const cudaError_t e = smem_opt_in(eig_pairs, opted, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t bytes = pairs_layout(n, in_smem).bytes;
  eig_pairs<<<B, PR_THREADS, bytes, s>>>(a, lam, vec, scratch, n, in_smem ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
