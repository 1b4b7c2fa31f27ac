// Log-GP half of the fleet expected-squared-mean scorer: the posterior mean
// and variance of every problem's log-likelihood GP on one shared grid.
//
// Replaces the TPU kernel `esm_fleet_tl` (tpubq/ops/pallas_kernels.py,
// `_esm_fleet_tl_kernel_factory`). Per (problem b, grid point x_a):
//   k_i = h^2 exp(-sum_c (x_i - x_a)_c^2 (1/2 w_c^-2)) m_i
//   m_a = alpha^T k,   c_a = max(h^2 - k^T K^-1 k, 0)
// with outputs m_a and c_a, each (B, G).
//
// What bounds it on Hopper: the float32 FMA rate. A point costs NP2^2
// multiply-adds for the quadratic form and about 8 NP2 operations for k and
// the dot, against about 4 d + 8 bytes of device memory (the problem's rows
// and inverse are read once per 512 points). The first design ran the form
// as a chain per point over float4 broadcasts of K_tl^-1's rows with four k
// loads each, five shared-memory loads per four multiply-adds (15% of the
// bound). Here it is the tiled product of esm_fleet_common.cuh: 128 points by
// a tile of K_tl^-1's rows, NP2 rounded up to 16 (32 at NP2 32, no padding), 8 x 4
// register tiles, three float4 shared-memory loads per 32 FMAs. At such small
// NP2 the k pass (an expf per point and row) is a third of the work the form
// is, so it is spread over every warp of the block; with one accumulator set
// a block holds fewer registers than esm_fleet_l's, so an SM holds one more.

#include "esm_fleet_common.cuh"

namespace {

using namespace tpubq_fleet;

template <int D, int CT>
__global__ void __launch_bounds__(threads_of(CT), min_blocks(CT) + 1)  // one accumulator set: room for a block more
esm_fleet_tl_kernel(const float* __restrict__ h2s, const float* __restrict__ w2inv,
                    const float* __restrict__ grid, int G, const float* __restrict__ xs,
                    const float* __restrict__ ms, const float* __restrict__ Kinv,
                    const float* __restrict__ alpha, int NP, float* __restrict__ outM,
                    float* __restrict__ outC) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const float h2 = __ldg(h2s + b);
  const size_t rows = (size_t)b * NP;
  FleetBlock<D, CT, false> fb(smem, Kinv + rows * NP, NP);
  fb.prologue(xs + rows * D, ms + rows, nullptr, alpha + rows);
  for (int t = blockIdx.x; t * kPT < G; t += gridDim.x) {
    fb.tile(t, grid, G, h2, w2inv + (size_t)b * D, 0.f);
    for (int p = threadIdx.x; p < kPT && t * kPT + p < G; p += blockDim.x) {  // the ragged edge is masked
      const Forms f = fb.forms(p);
      const size_t o = (size_t)b * G + t * kPT + p;
      outM[o] = f.ka;
      outC[o] = fmaxf(h2 - f.s1, 0.f);
    }
    __syncthreads();  // the next tile's k pass overwrites the partials
  }
}

}  // namespace

// threads and smem_bytes as for tpubq_esm_fleet_l (one layout for both kernels).
extern "C" int tpubq_esm_fleet_tl(const float* h2s, const float* w2inv, const float* grid,
                                  int G, int d, const float* xs, const float* ms,
                                  const float* Kinv, const float* alpha, int B, int NP2,
                                  int threads, int smem_bytes, float* outM, float* outC,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_fleet(d, NP2, G, B, threads, smem_bytes, [&](auto dc, auto ctc) {
    constexpr int D = decltype(dc)::value, CT = decltype(ctc)::value;
    return launch_grid(esm_fleet_tl_kernel<D, CT>, G, B, threads, smem_bytes, s, h2s, w2inv, grid, G, xs,
                       ms, Kinv, alpha, NP2, outM, outC);
  });
}
