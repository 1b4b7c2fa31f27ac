// Pieces shared by the two fleet scorer kernels (esm_fleet_l.cu,
// esm_fleet_tl.cu): one problem's K^-1 staged in shared memory with its rows
// padded to a multiple of four floats, the gaussian cross-kernel of one grid
// point against the problem's rows, and the quadratic forms k^T K^-1 k and
// k^T |K^-1| k as full-float32 FMA chains.
//
// Layout: `sK` is [NP][NPS] row-major with NPS = NP rounded up to 4 and zeros
// in the pad columns; a thread's k vector is `kb[j * T]`, j < NPS, with zeros
// in the pad rows, so a warp reads consecutive floats at every j and a row of
// K^-1 is read as float4 broadcasts (one shared-memory transaction for four
// matrix entries).

#pragma once

#include <cuda_runtime.h>

namespace tpubq_dev {

__device__ __forceinline__ int round_up4(int n) { return (n + 3) & ~3; }

// Every thread of the block takes part; the caller synchronizes afterwards.
__device__ inline void load_padded_rows(const float* __restrict__ K, float* sK, int NP, int NPS,
                                        int tid, int T) {
  for (int t = tid; t < NP * NPS; t += T) {
    const int i = t / NPS;
    const int j = t - i * NPS;
    sK[t] = j < NP ? K[(size_t)i * NP + j] : 0.f;
  }
}

// r^2 = sum_c (x_c - xa_c)^2 * w2inv_c and the sup-norm distance of one row.
template <int D>
__device__ __forceinline__ float scaled_sqdist(const float* __restrict__ x, const float* xa,
                                               const float* __restrict__ w2inv, float& dmax) {
  float r2 = 0.f;
  dmax = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const float dj = x[c] - xa[c];
    r2 += dj * dj * w2inv[c];
    dmax = fmaxf(dmax, fabsf(dj));
  }
  return r2;
}

// s1 = k^T K^-1 k and, with ABS, bound = k^T |K^-1| k (k >= 0 for the gaussian
// kernel). Row i of the sum is accumulated on its own and then weighted by
// k_i, as the matrix-vector form (K^-1 k)_i k_i does.
template <bool ABS>
__device__ __forceinline__ void quad_forms(const float* sK, const float* kb, int NP, int NPS,
                                           int T, float& s1, float& bound) {
  s1 = 0.f;
  bound = 0.f;
  for (int i = 0; i < NP; ++i) {
    const float4* row = reinterpret_cast<const float4*>(sK + i * NPS);
    float vi = 0.f, ei = 0.f;
    for (int j4 = 0; j4 < NPS / 4; ++j4) {
      const float4 a = row[j4];
      const float* kj = kb + 4 * j4 * T;
      const float k0 = kj[0], k1 = kj[T], k2 = kj[2 * T], k3 = kj[3 * T];
      vi += a.x * k0;
      vi += a.y * k1;
      vi += a.z * k2;
      vi += a.w * k3;
      if (ABS) {
        ei += fabsf(a.x) * k0;
        ei += fabsf(a.y) * k1;
        ei += fabsf(a.z) * k2;
        ei += fabsf(a.w) * k3;
      }
    }
    const float ki = kb[i * T];
    s1 += ki * vi;
    if (ABS) bound += ki * ei;
  }
}

}  // namespace tpubq_dev
