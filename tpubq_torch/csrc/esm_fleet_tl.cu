// Log-GP half of the fleet expected-squared-mean scorer: the posterior mean
// and variance of every problem's log-likelihood GP on one shared grid.
//
// Replaces the TPU kernel `esm_fleet_tl` (tpubq/ops/pallas_kernels.py,
// `_esm_fleet_tl_kernel_factory`). Per (problem b, grid point x_a):
//   k_i = h^2 exp(-sum_c (x_i - x_a)_c^2 (1/2 w_c^-2)) m_i
//   m_a = alpha^T k,   c_a = max(h^2 - k^T K^-1 k, 0)
// with outputs m_a and c_a, each (B, G).
//
// Design and bound as esm_fleet_l.cu: block (tile, b) holds problem b's
// K_tl^-1 (rows padded to float4), observations, mask and alpha in shared
// memory, a thread owns one grid point, and the quadratic form is a float32
// FMA chain fed by float4 broadcasts of the matrix rows: about 2 NP2^2
// operations per point against 4 d bytes in and 8 bytes out, so shared-memory
// bandwidth and the FMA rate bound it, not device memory.

#include "esm_fleet_common.cuh"

namespace {

template <int D>
__global__ void esm_fleet_tl_kernel(const float* __restrict__ h2s,
                                    const float* __restrict__ w2inv,
                                    const float* __restrict__ grid, int G,
                                    const float* __restrict__ xs,
                                    const float* __restrict__ ms,
                                    const float* __restrict__ Kinv,
                                    const float* __restrict__ alpha, int NP,
                                    float* __restrict__ outM, float* __restrict__ outC) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int NPS = tpubq_dev::round_up4(NP);

  float* sK = smem;               // [NP][NPS]
  float* kbuf = sK + NPS * NPS;   // [NPS][T]
  float* sx = kbuf + NPS * T;     // [NP][D]
  float* sm = sx + NP * D;        // [NP]
  float* sal = sm + NP;           // [NP]
  float* sw = sal + NP;           // [D]

  tpubq_dev::load_padded_rows(Kinv + (size_t)b * NP * NP, sK, NP, NPS, tid, T);
  for (int i = tid; i < NP * D; i += T) sx[i] = xs[(size_t)b * NP * D + i];
  for (int i = tid; i < NP; i += T) {
    sm[i] = ms[(size_t)b * NP + i];
    sal[i] = alpha[(size_t)b * NP + i];
  }
  if (tid < D) sw[tid] = w2inv[(size_t)b * D + tid];
  __syncthreads();

  const int g = blockIdx.x * T + tid;
  if (g >= G) return;  // ragged edge: no barrier follows

  const float h2 = h2s[b];
  float xa[D];
#pragma unroll
  for (int c = 0; c < D; ++c) xa[c] = grid[(size_t)g * D + c];
  float* kb = kbuf + tid;

  float mean = 0.f;
  for (int j = 0; j < NP; ++j) {
    float dmax;
    const float r2 = tpubq_dev::scaled_sqdist<D>(sx + j * D, xa, sw, dmax);
    const float k = h2 * expf(-r2) * sm[j];
    kb[j * T] = k;
    mean += sal[j] * k;
  }
  for (int j = NP; j < NPS; ++j) kb[j * T] = 0.f;

  float quad, unused;
  tpubq_dev::quad_forms<false>(sK, kb, NP, NPS, T, quad, unused);
  const size_t o = (size_t)b * G + g;
  outM[o] = mean;
  outC[o] = fmaxf(h2 - quad, 0.f);
}

template <int D>
int launch(const float* h2s, const float* w2inv, const float* grid, int G, const float* xs,
           const float* ms, const float* Kinv, const float* alpha, int B, int NP, int threads,
           int smem_bytes, float* outM, float* outC, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        esm_fleet_tl_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 blocks((G + threads - 1) / threads, B);
  esm_fleet_tl_kernel<D><<<blocks, threads, smem_bytes, stream>>>(
      h2s, w2inv, grid, G, xs, ms, Kinv, alpha, NP, outM, outC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// smem_bytes as for tpubq_esm_fleet_l (the wrapper sizes both alike).
extern "C" int tpubq_esm_fleet_tl(const float* h2s, const float* w2inv, const float* grid,
                                  int G, int d, const float* xs, const float* ms,
                                  const float* Kinv, const float* alpha, int B, int NP2,
                                  int threads, int smem_bytes, float* outM, float* outC,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1:
      return launch<1>(h2s, w2inv, grid, G, xs, ms, Kinv, alpha, B, NP2, threads, smem_bytes,
                       outM, outC, s);
    case 2:
      return launch<2>(h2s, w2inv, grid, G, xs, ms, Kinv, alpha, B, NP2, threads, smem_bytes,
                       outM, outC, s);
    case 3:
      return launch<3>(h2s, w2inv, grid, G, xs, ms, Kinv, alpha, B, NP2, threads, smem_bytes,
                       outM, outC, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
