// Fused expected-squared-mean (ESM) scorer for one gaussian-kernel BQ problem.
//
// Replaces the TPU kernel `esm_fused` (tpubq/ops/pallas_kernels.py,
// `_esm_kernel_factory`): per candidate point x_a it computes the linear-GP
// cross-kernel k and the sup-norm distance to every live point, the Schur
// complement gamma = kappa - k^T K^-1 k, z^T K^-1 k and k^T alpha, the
// measure integral zeta(x_a), the log-GP posterior moments (m_a, c_a) through
// K_tl^-1, and the clamped lognormal moments, and returns
// ESM = A^2 + 2AB E1 + B^2 E2 with degenerate points set to (z^T alpha)^2.
// One addition over the TPU kernel: the degenerate test is
// gamma <= max(eps * kappa, noise_mult * sum(k)), so the caller can pass the
// production adaptive guard noise_mult = lambda * rho * kappa (noise_mult = 0
// is the TPU kernel's own guard).
//
// What bounds it on Hopper: arithmetic and shared-memory bandwidth. Each point
// costs about NP^2 + NP2^2 FMAs for the two quadratic forms plus NP + NP2
// exponentials, and moves only 4*d bytes in and 4 bytes out of device memory.
// The design therefore keeps everything per-problem on chip: one thread per
// grid point, the problem's vectors and (when they fit) K^-1 and K_tl^-1 in
// shared memory, read by every thread of a warp at the same address
// (broadcast, no bank conflicts), and each thread's k vector in shared memory
// laid out [j][thread] so that a warp's accesses are consecutive. Where the
// two inverses do not fit beside the k buffers, they are read from device
// memory through L1 instead (same broadcast pattern). The wrapper chooses
// the block size and the placement (hopper_kernels._esm_launch_config).
// The grid's ragged edge is masked, not padded.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

template <int D>
__global__ void esm_fused_kernel(const float* __restrict__ params,
                                 const float* __restrict__ grid, int G,
                                 const float* __restrict__ xsc,
                                 const float* __restrict__ msc,
                                 const float* __restrict__ Kinv,
                                 const float* __restrict__ uz,
                                 const float* __restrict__ alpha, int NP,
                                 const float* __restrict__ xs,
                                 const float* __restrict__ ms,
                                 const float* __restrict__ Kinv_tl,
                                 const float* __restrict__ alpha_tl, int NP2,
                                 int kinv_in_smem, float* __restrict__ out) {
  constexpr int NPAR = 9 + 3 * D + D * D;
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int npmax = NP > NP2 ? NP : NP2;

  float* kbuf = smem;                    // [npmax][T]
  float* sp = kbuf + npmax * T;          // [NPAR]
  float* sxsc = sp + NPAR;               // [NP][D]
  float* smsc = sxsc + NP * D;           // [NP]
  float* suz = smsc + NP;                // [NP]
  float* sal = suz + NP;                 // [NP]
  float* sxs = sal + NP;                 // [NP2][D]
  float* sms = sxs + NP2 * D;            // [NP2]
  float* satl = sms + NP2;               // [NP2]
  float* sK = satl + NP2;                // [NP][NP]   (kinv_in_smem)
  float* sK2 = sK + NP * NP;             // [NP2][NP2] (kinv_in_smem)

  for (int i = tid; i < NPAR; i += T) sp[i] = params[i];
  for (int i = tid; i < NP * D; i += T) sxsc[i] = xsc[i];
  for (int i = tid; i < NP; i += T) {
    smsc[i] = msc[i];
    suz[i] = uz[i];
    sal[i] = alpha[i];
  }
  for (int i = tid; i < NP2 * D; i += T) sxs[i] = xs[i];
  for (int i = tid; i < NP2; i += T) {
    sms[i] = ms[i];
    satl[i] = alpha_tl[i];
  }
  const float* Ki = Kinv;
  const float* Ki2 = Kinv_tl;
  if (kinv_in_smem) {
    for (int i = tid; i < NP * NP; i += T) sK[i] = Kinv[i];
    for (int i = tid; i < NP2 * NP2; i += T) sK2[i] = Kinv_tl[i];
    Ki = sK;
    Ki2 = sK2;
  }
  __syncthreads();

  const int g = blockIdx.x * T + tid;
  if (g >= G) return;  // ragged edge: no barrier follows

  const float h_l2 = sp[0], kappa = sp[1], zc = sp[2], gamma = sp[3];
  const float thresh = sp[4], zTa = sp[5], h_tl2 = sp[6], cap = sp[7];
  const float* wl = sp + 8;             // 0.5 / w_l^2
  const float* wtl = sp + 8 + D;        // 0.5 / w_tl^2
  const float* mu = sp + 8 + 2 * D;     // measure mean
  const float* Ah = sp + 8 + 3 * D;     // 0.5 (W_l + Sigma)^-1, row-major
  const float noise_mult = sp[8 + 3 * D + D * D];

  float xa[D];
#pragma unroll
  for (int c = 0; c < D; ++c) xa[c] = grid[(size_t)g * D + c];
  float* kb = kbuf + tid;

  // linear-GP cross-kernel, sup-norm proximity, and the two dot products
  bool near = false;
  float ksum = 0.f, zv = 0.f, ka = 0.f;
  for (int j = 0; j < NP; ++j) {
    float r2 = 0.f, dmax = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float dj = sxsc[j * D + c] - xa[c];
      r2 += dj * dj * wl[c];
      dmax = fmaxf(dmax, fabsf(dj));
    }
    const float m = smsc[j];
    const float k = h_l2 * expf(-r2) * m;
    kb[j * T] = k;
    ksum += k;
    zv += suz[j] * k;
    ka += sal[j] * k;
    near = near || (m > 0.f && dmax < thresh);
  }
  // gamma = kappa - k^T K^-1 k
  float quad = 0.f;
  for (int i = 0; i < NP; ++i) {
    const float* row = Ki + i * NP;
    float vi = 0.f;
    for (int j = 0; j < NP; ++j) vi += row[j] * kb[j * T];
    quad += kb[i * T] * vi;
  }
  const float gam = kappa - quad;

  // zeta(x_a) = zc * exp(-(x_a - mu)^T [0.5 (W_l + Sigma)^-1] (x_a - mu))
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) q += Ah[i * D + j] * (xa[i] - mu[i]) * (xa[j] - mu[j]);
  }
  const float zeta = zc * expf(-q);

  const bool degen = near || gam <= fmaxf(FLT_EPSILON * kappa, noise_mult * ksum);
  const float B = (zeta - zv) / (degen ? 1.f : gam);
  const float A = zTa - B * ka;

  // log-GP posterior moments at x_a (the k buffer is reused)
  float mt = 0.f;
  for (int j = 0; j < NP2; ++j) {
    float r2 = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float dj = sxs[j * D + c] - xa[c];
      r2 += dj * dj * wtl[c];
    }
    const float k = h_tl2 * expf(-r2) * sms[j];
    kb[j * T] = k;
    mt += satl[j] * k;
  }
  float quad2 = 0.f;
  for (int i = 0; i < NP2; ++i) {
    const float* row = Ki2 + i * NP2;
    float vi = 0.f;
    for (int j = 0; j < NP2; ++j) vi += row[j] * kb[j * T];
    quad2 += kb[i * T] * vi;
  }
  const float c = fmaxf(h_tl2 - quad2, 0.f);
  const float e1 = expf(fminf(mt + 0.5f * c, cap));
  const float e2 = expf(fminf(2.f * mt + 2.f * c, cap));
  const float E1 = gamma * (e1 - 1.f);
  const float E2 = gamma * gamma * (e2 - 2.f * e1 + 1.f);
  const float esm = A * A + 2.f * A * B * E1 + B * B * E2;
  out[g] = degen ? zTa * zTa : esm;
}

template <int D>
int launch(const float* params, const float* grid, int G, const float* xsc,
           const float* msc, const float* Kinv, const float* uz,
           const float* alpha, int NP, const float* xs, const float* ms,
           const float* Kinv_tl, const float* alpha_tl, int NP2, int threads,
           int kinv_in_smem, int smem_bytes, float* out, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        esm_fused_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (G + threads - 1) / threads;
  esm_fused_kernel<D><<<blocks, threads, smem_bytes, stream>>>(
      params, grid, G, xsc, msc, Kinv, uz, alpha, NP, xs, ms, Kinv_tl, alpha_tl,
      NP2, kinv_in_smem, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tpubq_esm_fused(const float* params, const float* grid, int G, int d,
                               const float* xsc, const float* msc, const float* Kinv,
                               const float* uz, const float* alpha, int NP,
                               const float* xs, const float* ms, const float* Kinv_tl,
                               const float* alpha_tl, int NP2, int threads,
                               int kinv_in_smem, int smem_bytes, float* out,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1:
      return launch<1>(params, grid, G, xsc, msc, Kinv, uz, alpha, NP, xs, ms, Kinv_tl,
                       alpha_tl, NP2, threads, kinv_in_smem, smem_bytes, out, s);
    case 2:
      return launch<2>(params, grid, G, xsc, msc, Kinv, uz, alpha, NP, xs, ms, Kinv_tl,
                       alpha_tl, NP2, threads, kinv_in_smem, smem_bytes, out, s);
    case 3:
      return launch<3>(params, grid, G, xsc, msc, Kinv, uz, alpha, NP, xs, ms, Kinv_tl,
                       alpha_tl, NP2, threads, kinv_in_smem, smem_bytes, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
