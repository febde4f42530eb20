// The limb form of an f32 expansion and the diagonal cascade, shared by the
// kernels that end in the cascade (cascade<FROM_C>, cascade<FROM_DIAGS> in
// kernels.cu and limb_gemm_fused in limb_gemm.cu), so that they agree bit
// for bit by construction.
#pragma once

#include "expansion.cuh"

namespace clrs {

constexpr int LIMB_BITS = 7;

// L limbs of an nw-word operand and the ND significance diagonals of a
// product that are kept (clrs_tpu/dd/limb_gemm.py:233-241).
__host__ __device__ constexpr int limb_count(int nw) {
  return (24 * nw + 21 + LIMB_BITS - 1) / LIMB_BITS;
}
__host__ __device__ constexpr int ndiag_count(int nw) {
  return (2 * limb_count(nw) - 1) < ((24 * nw + 21) / LIMB_BITS + 1)
             ? (2 * limb_count(nw) - 1)
             : ((24 * nw + 21) / LIMB_BITS + 1);
}

// The cascade (pallas_linalg.py _cascade_fold / _cascade_out) of E output
// elements at once: folds the int32 diagonal sums diag(d, e), d = 0..ND-1,
// most significant first, into an (NW+2)-word carry per element: each sum is
// split into two exactly-f32 halves, scaled by 2^(eab[e] - 7(d+2)) and swept
// in with one vec_sum. Then two sweeps and the sequential tail fold give NW
// words, out[e]. The elements' chains are independent, so E > 1 interleaves
// them.
template <int NW, int E, typename Diag>
__device__ __forceinline__ void cascade_fold(Diag diag, const int* eab, float (*out)[NW]) {
  constexpr int ND = ndiag_count(NW);
  float acc[E][NW + 2];
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int w = 0; w < NW + 2; ++w) acc[e][w] = 0.0f;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int tile = diag(d, e);
      const int hi_i = tile >> 15;  // floor shift
      const int lo_i = tile - (hi_i << 15);
      const int sc = eab[e] - LIMB_BITS * (d + 2);
      float cs[NW + 4];
#pragma unroll
      for (int w = 0; w < NW + 2; ++w) cs[w] = acc[e][w];
      cs[NW + 2] = mul_pow2_word<4>(fmul(__int2float_rn(hi_i), 32768.0f), sc);
      cs[NW + 3] = mul_pow2_word<4>(__int2float_rn(lo_i), sc);
      vec_sum<NW + 4>(cs);
      const float low = fadd(cs[NW + 2], cs[NW + 3]);
#pragma unroll
      for (int w = 0; w < NW + 2; ++w) acc[e][w] = cs[w];
      acc[e][NW + 1] = fadd(acc[e][NW + 1], low);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    vec_sum<NW + 2>(acc[e]);
    vec_sum<NW + 2>(acc[e]);
#pragma unroll
    for (int w = 0; w < NW - 1; ++w) out[e][w] = acc[e][w];
    const float last = fadd(acc[e][NW - 1], acc[e][NW]);
    out[e][NW - 1] = fadd(last, acc[e][NW + 1]);
  }
}

}  // namespace clrs
