// Linear-GP half of the fleet expected-squared-mean scorer: B independent BQ
// problems scored on one shared grid of G points in a single launch.
//
// Replaces the TPU kernel `esm_fleet_l` (tpubq/ops/pallas_kernels.py,
// `_esm_fleet_l_kernel_factory`). Per (problem b, grid point x_a):
//   k_i   = h^2 exp(-sum_c (x_i - x_a)_c^2 (1/2 w_c^-2)) m_i
//   s1    = k^T K^-1 k,  bound = k^T |K^-1| k,  zv = uz^T k,  ka = alpha^T k
//   near  = any live row within `thresh` of x_a (sup-norm; in 1-D the test is
//           r^2 < thresh^2 (1/2 w^-2), which reuses r^2)
//   gam   = kappa - s1
//   degen = near or gam <= max(eps kappa, lam bound)
//   zeta  = zc exp(-(x_a - mu)^T [1/2 (W_l + Sigma)^-1] (x_a - mu))
//   B = (zeta - zv) / (degen ? 1 : gam),  A = z^T alpha - B ka
// and the outputs are A, B and degen (0/1), each (B, G). The lognormal
// combine that turns them and esm_fleet_tl's moments into scores stays in
// tensor ops, as the TPU version leaves it to its compiler.
//
// What the TPU kernel does for its matrix unit is not carried over: packing
// several problems block-diagonally into 128 rows, the bf16 hi/lo split of
// the dot, padding G to a tile and B to a multiple of the packing. Here the
// problem is the second grid axis and the inverses are read as they lie in
// the estimator state, (B, NP, NP), with no repacking.
//
// What bounds it on Hopper: the float32 FMA rate. A point costs 2 NP^2
// multiply-adds for the two quadratic forms and about 12 NP operations for k
// and the dots, against about 4 d + 12 bytes of device memory (its grid
// coordinates in, A, B and the mask out; the problem's rows and inverse are
// read once per 512 points). The first design gave each thread one point and
// ran the forms as chains over K^-1's rows: every four multiply-adds cost
// five shared-memory loads (a float4 row broadcast and four k values), so
// shared memory, not the FMA units, set its pace (27% of the bound). This
// design (esm_fleet_common.cuh) runs them as a tiled product of 128 points by
// a tile of K^-1's rows, each thread an 8 x 4 register tile with both forms'
// accumulators: three float4 shared-memory loads per 64 FMAs. The column tile
// is NP rounded up to 16 (48 at NP 44: 9% of the FMAs are padding). The k
// pass (an expf per point and row) and the per-tile barriers are the rest of
// the time (PERF.md). The grid's ragged edge is masked, not padded.

#include <cfloat>

#include "esm_fleet_common.cuh"

namespace {

using namespace tpubq_fleet;

constexpr int kParams = 16;  // kappa, z^T alpha, zc, mu[3], Ah[9] (stride D), h^2

template <int D, int CT>
__global__ void __launch_bounds__(threads_of(CT), min_blocks(CT))
esm_fleet_l_kernel(const float* __restrict__ params, const float* __restrict__ w2inv,
                   const float* __restrict__ grid, int G, const float* __restrict__ xsc,
                   const float* __restrict__ msc, const float* __restrict__ Kinv,
                   const float* __restrict__ uz, const float* __restrict__ alpha, int NP, float thresh,
                   float lam, float* __restrict__ outA, float* __restrict__ outB,
                   float* __restrict__ outD) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const float* pb = params + (size_t)b * kParams;
  const size_t rows = (size_t)b * NP;
  FleetBlock<D, CT, true> fb(smem, Kinv + rows * NP, NP);
  fb.prologue(xsc + rows * D, msc + rows, uz + rows, alpha + rows);
  const float kappa = __ldg(pb), zTa = __ldg(pb + 1), zc = __ldg(pb + 2), h2 = __ldg(pb + 15);
  for (int t = blockIdx.x; t * kPT < G; t += gridDim.x) {
    fb.tile(t, grid, G, h2, w2inv + (size_t)b * D, thresh);
    for (int p = threadIdx.x; p < kPT && t * kPT + p < G; p += blockDim.x) {  // the ragged edge is masked
      const int g = t * kPT + p;
      const Forms f = fb.forms(p);
      const float gam = kappa - f.s1;
      const bool degen = f.near || gam <= fmaxf(FLT_EPSILON * kappa, lam * f.bound);
      float da[D];
#pragma unroll
      for (int c = 0; c < D; ++c) da[c] = __ldg(grid + (size_t)g * D + c) - __ldg(pb + 3 + c);
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
#pragma unroll
        for (int j = 0; j < D; ++j) q += __ldg(pb + 6 + i * D + j) * da[i] * da[j];
      }
      const float zeta = zc * expf(-q);
      const float Bc = (zeta - f.zv) / (degen ? 1.f : gam);
      const size_t o = (size_t)b * G + g;
      outA[o] = zTa - Bc * f.ka;
      outB[o] = Bc;
      outD[o] = degen ? 1.f : 0.f;
    }
    __syncthreads();  // the next tile's k pass overwrites the partials
  }
}

}  // namespace

// threads and smem_bytes are the wrapper's: threads_of(col_width(NP)) and at
// least 4 smem_floats(NP, d) bytes (esm_fleet_common.cuh); anything else is refused.
extern "C" int tpubq_esm_fleet_l(const float* params, const float* w2inv, const float* grid,
                                 int G, int d, const float* xsc, const float* msc,
                                 const float* Kinv, const float* uz, const float* alpha, int B,
                                 int NP, float thresh, float lam, int threads, int smem_bytes,
                                 float* outA, float* outB, float* outD, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_fleet(d, NP, G, B, threads, smem_bytes, [&](auto dc, auto ctc) {
    constexpr int D = decltype(dc)::value, CT = decltype(ctc)::value;
    return launch_grid(esm_fleet_l_kernel<D, CT>, G, B, threads, smem_bytes, s, params, w2inv, grid, G,
                       xsc, msc, Kinv, uz, alpha, NP, thresh, lam, outA, outB, outD);
  });
}
