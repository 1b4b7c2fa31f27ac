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
// problem is the second grid axis: block (tile, b) stages problem b's K^-1,
// rows, vectors and 16 scalars in shared memory once, each thread owns one
// grid point, and the two quadratic forms are float32 FMA chains. The inverses
// are read as they lie in the estimator state, (B, NP, NP), with no repacking.
//
// What bounds it on Hopper: shared-memory bandwidth and the FMA rate, not device
// memory. A point costs about 4 NP^2 + 12 NP operations against 4 d bytes in
// and 12 bytes out. Every (i, j) term needs one matrix entry and one k value
// from shared memory; the matrix row is read as float4 broadcasts and k as
// consecutive floats across the warp, 1.25 transactions per term. Many small
// blocks per SM (a problem at NP = 44 takes 31 KB) hide the latency of the
// chains. The grid's ragged edge is masked.

#include <cfloat>

#include "esm_fleet_common.cuh"

namespace {

constexpr int kParams = 16;  // kappa, z^T alpha, zc, mu[3], Ah[9] (stride D), h^2

template <int D>
__global__ void esm_fleet_l_kernel(const float* __restrict__ params,
                                   const float* __restrict__ w2inv,
                                   const float* __restrict__ grid, int G,
                                   const float* __restrict__ xsc,
                                   const float* __restrict__ msc,
                                   const float* __restrict__ Kinv,
                                   const float* __restrict__ uz,
                                   const float* __restrict__ alpha, int NP, float thresh,
                                   float lam, float* __restrict__ outA,
                                   float* __restrict__ outB, float* __restrict__ outD) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int NPS = tpubq_dev::round_up4(NP);

  float* sK = smem;               // [NP][NPS]
  float* kbuf = sK + NPS * NPS;   // [NPS][T]   (sK is given NPS rows of room)
  float* sx = kbuf + NPS * T;     // [NP][D]
  float* sm = sx + NP * D;        // [NP]
  float* suz = sm + NP;           // [NP]
  float* sal = suz + NP;          // [NP]
  float* sp = sal + NP;           // [kParams]
  float* sw = sp + kParams;       // [D]

  tpubq_dev::load_padded_rows(Kinv + (size_t)b * NP * NP, sK, NP, NPS, tid, T);
  for (int i = tid; i < NP * D; i += T) sx[i] = xsc[(size_t)b * NP * D + i];
  for (int i = tid; i < NP; i += T) {
    sm[i] = msc[(size_t)b * NP + i];
    suz[i] = uz[(size_t)b * NP + i];
    sal[i] = alpha[(size_t)b * NP + i];
  }
  if (tid < kParams) sp[tid] = params[(size_t)b * kParams + tid];
  if (tid < D) sw[tid] = w2inv[(size_t)b * D + tid];
  __syncthreads();

  const int g = blockIdx.x * T + tid;
  if (g >= G) return;  // ragged edge: no barrier follows

  const float kappa = sp[0], zTa = sp[1], zc = sp[2], h2 = sp[15];
  const float* mu = sp + 3;
  const float* Ah = sp + 6;

  float xa[D];
#pragma unroll
  for (int c = 0; c < D; ++c) xa[c] = grid[(size_t)g * D + c];
  float* kb = kbuf + tid;

  bool near = false;
  float zv = 0.f, ka = 0.f;
  const float near_r2 = thresh * thresh * sw[0];
  for (int j = 0; j < NP; ++j) {
    float dmax;
    const float r2 = tpubq_dev::scaled_sqdist<D>(sx + j * D, xa, sw, dmax);
    const float m = sm[j];
    const float k = h2 * expf(-r2) * m;
    kb[j * T] = k;
    zv += suz[j] * k;
    ka += sal[j] * k;
    const bool close = D == 1 ? r2 < near_r2 : dmax < thresh;
    near = near || (m > 0.f && close);
  }
  for (int j = NP; j < NPS; ++j) kb[j * T] = 0.f;

  float s1, bound;
  tpubq_dev::quad_forms<true>(sK, kb, NP, NPS, T, s1, bound);
  const float gam = kappa - s1;
  const bool degen = near || gam <= fmaxf(FLT_EPSILON * kappa, lam * bound);

  float q = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) q += Ah[i * D + j] * (xa[i] - mu[i]) * (xa[j] - mu[j]);
  }
  const float zeta = zc * expf(-q);

  const float Bc = (zeta - zv) / (degen ? 1.f : gam);
  const size_t o = (size_t)b * G + g;
  outA[o] = zTa - Bc * ka;
  outB[o] = Bc;
  outD[o] = degen ? 1.f : 0.f;
}

template <int D>
int launch(const float* params, const float* w2inv, const float* grid, int G, const float* xsc,
           const float* msc, const float* Kinv, const float* uz, const float* alpha, int B,
           int NP, float thresh, float lam, int threads, int smem_bytes, float* outA,
           float* outB, float* outD, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        esm_fleet_l_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 blocks((G + threads - 1) / threads, B);
  esm_fleet_l_kernel<D><<<blocks, threads, smem_bytes, stream>>>(
      params, w2inv, grid, G, xsc, msc, Kinv, uz, alpha, NP, thresh, lam, outA, outB, outD);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// smem_bytes = 4 (NPS^2 + NPS threads + NP (d + 3) + 16 + d), NPS = NP rounded up to 4.
extern "C" int tpubq_esm_fleet_l(const float* params, const float* w2inv, const float* grid,
                                 int G, int d, const float* xsc, const float* msc,
                                 const float* Kinv, const float* uz, const float* alpha, int B,
                                 int NP, float thresh, float lam, int threads, int smem_bytes,
                                 float* outA, float* outB, float* outD, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1:
      return launch<1>(params, w2inv, grid, G, xsc, msc, Kinv, uz, alpha, B, NP, thresh, lam,
                       threads, smem_bytes, outA, outB, outD, s);
    case 2:
      return launch<2>(params, w2inv, grid, G, xsc, msc, Kinv, uz, alpha, B, NP, thresh, lam,
                       threads, smem_bytes, outA, outB, outD, s);
    case 3:
      return launch<3>(params, w2inv, grid, G, xsc, msc, Kinv, uz, alpha, B, NP, thresh, lam,
                       threads, smem_bytes, outA, outB, outD, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
