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
// The two quadratic forms as tiled products, as the TPU kernel forms them
// (jnp.dot(Kinv, k)), in two launches, with no shared-memory cap on NP:
// (a) esm_tile_kernel: one block per (64 grid points, 64 columns c of K^-1,
//     GP) forms V[p][c] = sum_j k_p[j] K^-1[j][c] over 32-row chunks of j:
//     the chunk's k tile is computed in place (expf, the points in shared
//     memory) and K^-1's rows are read from device memory, both staged in
//     shared memory through registers loaded while the previous chunk's
//     4 x 4 register-blocked float32 FMA tile runs. The epilogue multiplies
//     by the points' own k[c] and reduces across the 64 columns, giving a
//     partial k^T K^-1 k per point and column tile, and the per-tile partials
//     of sum(k), z^T K^-1 k (through uz), k^T alpha, the sup-norm `near` flag
//     and m_a = k_tl^T alpha_tl.
// (b) esm_finish_kernel: one thread per point sums its partials over the
//     column tiles in a fixed order, then forms zeta, the guard, the log-GP
//     moments and the ESM.
// No float atomics: repeated calls give the same bits. The cancellation in
// gamma = kappa - k^T K^-1 k stays float32 FMA throughout (no TF32).
//
// What bounds it on Hopper: the G (NP^2 + NP2^2) multiply-adds of the two
// quadratic forms against the float32 FMA rate (the device-memory traffic is
// the inverses, read once per 64 grid points, and 4 d + 4 bytes per point).
// The grid's ragged edge is masked, not padded.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

// The per-point finish: the guard, B, A, the log-GP posterior variance
// c = max(h_tl^2 - quad2, 0), the clamped lognormal moments and the ESM.
__device__ __forceinline__ float esm_point(float kappa, float gamma, float zTa, float h_tl2, float cap,
                                           float noise_mult, float zeta, float gam, float ksum, float zv,
                                           float ka, bool near, float mt, float quad2) {
  const bool degen = near || gam <= fmaxf(FLT_EPSILON * kappa, noise_mult * ksum);
  const float B = (zeta - zv) / (degen ? 1.f : gam);
  const float A = zTa - B * ka;
  const float c = fmaxf(h_tl2 - quad2, 0.f);
  const float e1 = expf(fminf(mt + 0.5f * c, cap));
  const float e2 = expf(fminf(2.f * mt + 2.f * c, cap));
  const float E1 = gamma * (e1 - 1.f);
  const float E2 = gamma * gamma * (e2 - 2.f * e1 + 1.f);
  const float esm = A * A + 2.f * A * B * E1 + B * B * E2;
  return degen ? zTa * zTa : esm;
}

// zeta(x_a) = zc * exp(-(x_a - mu)^T [0.5 (W_l + Sigma)^-1] (x_a - mu))
template <int D>
__device__ __forceinline__ float esm_zeta(const float* xa, float zc, const float* mu, const float* Ah) {
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) q += Ah[i * D + j] * (xa[i] - mu[i]) * (xa[j] - mu[j]);
  }
  return zc * expf(-q);
}

constexpr int kPT = 64;        // grid points per block
constexpr int kCT = 64;        // columns of K^-1 per block
constexpr int kJC = 32;        // rows j per chunk
constexpr int kTThreads = 256;
constexpr int kLD = 68;        // shared-memory stride: 16-byte rows
constexpr int kFields0 = 5;    // linear GP partials: quad, sum(k), uz.k, alpha.k, near
constexpr int kFields1 = 2;    // log-GP partials: quad2, alpha_tl.k_tl
constexpr int kStage = kPT * kJC / kTThreads;  // chunk entries per thread (8)

// Partial f of GP gp, column tile ct, point g in the scratch `part`
// (ct0 = column tiles of the linear GP; Gp = points rounded up to kPT).
__device__ __forceinline__ size_t part_at(int gp, int ct, int f, int g, int ct0, int Gp) {
  return gp == 0 ? ((size_t)ct * kFields0 + f) * Gp + g
                 : ((size_t)ct0 * kFields0 + (size_t)ct * kFields1 + f) * Gp + g;
}

template <int D>
__global__ void __launch_bounds__(kTThreads)
esm_tile_kernel(const float* __restrict__ params, const float* __restrict__ grid, int G,
                const float* __restrict__ xsc, const float* __restrict__ msc,
                const float* __restrict__ Kinv, const float* __restrict__ uz,
                const float* __restrict__ alpha, int NP, const float* __restrict__ xs,
                const float* __restrict__ ms, const float* __restrict__ Kinv_tl,
                const float* __restrict__ alpha_tl, int NP2, float* __restrict__ part, int Gp) {
  __shared__ __align__(16) float As[kJC * kLD];  // As[jj][p] = k_p[j0 + jj]
  __shared__ __align__(16) float Bs[kJC * kLD];  // Bs[jj][c] = K^-1[j0 + jj][c0 + c]
  __shared__ __align__(16) float kC[kCT * kLD];  // kC[c][p] = k_p[c0 + c]
  __shared__ float sg[kPT * D];                  // the block's grid points
  const int gp = blockIdx.z;
  const int n = gp == 0 ? NP : NP2;
  const int c0 = blockIdx.y * kCT;
  if (c0 >= n) return;  // a column tile past this GP's rows (uniform over the block)
  const float* X = gp == 0 ? xsc : xs;
  const float* M = gp == 0 ? msc : ms;
  const float* Ki = gp == 0 ? Kinv : Kinv_tl;
  const float h2 = __ldg(params + (gp == 0 ? 0 : 6));
  float w[D];
#pragma unroll
  for (int c = 0; c < D; ++c) w[c] = __ldg(params + 8 + gp * D + c);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int g0 = blockIdx.x * kPT;
  for (int e = tid; e < kPT * D; e += kTThreads)
    sg[e] = g0 + e / D < G ? __ldg(grid + (size_t)g0 * D + e) : 0.f;
  __syncthreads();

  // this thread's point of every chunk entry it stages, and its k at row j
  const int sp = tid % kPT;
  float xp[D];
#pragma unroll
  for (int c = 0; c < D; ++c) xp[c] = sg[sp * D + c];
  auto kval = [&](const float* xj, float mj) {
    float r2 = 0.f;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float dj = xj[c] - xp[c];
      r2 += dj * dj * w[c];
    }
    return h2 * expf(-r2) * mj;
  };

  // k at this tile's own columns, for the epilogue
  for (int s = 0; s < kCT * kPT / kTThreads; ++s) {
    const int c = tid / kPT + s * (kTThreads / kPT);
    const int j = c0 + c;
    float xj[D];
#pragma unroll
    for (int cc = 0; cc < D; ++cc) xj[cc] = j < n ? __ldg(X + (size_t)j * D + cc) : 0.f;
    kC[c * kLD + sp] = j < n ? kval(xj, __ldg(M + j)) : 0.f;
  }

  // V[p][c] = sum_j k_p[j] K^-1[j][c], 32 rows j per chunk; the next chunk's
  // rows of X, M and K^-1 are loaded into registers while this one's FMA runs
  float xr[kStage][D], mr[kStage], br[kStage];
  auto load_chunk = [&](int j0) {
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int e = tid + s * kTThreads;
      const int j = j0 + e / kPT;  // the X rows (this thread's point is fixed)
#pragma unroll
      for (int cc = 0; cc < D; ++cc) xr[s][cc] = j < n ? __ldg(X + (size_t)j * D + cc) : 0.f;
      mr[s] = j < n ? __ldg(M + j) : 0.f;
      const int jb = j0 + e / kCT;  // the K^-1 entries
      const int cb = c0 + e % kCT;
      br[s] = (jb < n && cb < n) ? __ldg(Ki + (size_t)jb * n + cb) : 0.f;
    }
  };
  auto store_chunk = [&]() {
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int e = tid + s * kTThreads;
      As[(e / kPT) * kLD + sp] = kval(xr[s], mr[s]);
      Bs[(e / kCT) * kLD + e % kCT] = br[s];
    }
  };
  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[q][p] = 0.f;
  load_chunk(0);
  store_chunk();
  __syncthreads();
  for (int j0 = 0; j0 < n; j0 += kJC) {
    const bool more = j0 + kJC < n;
    if (more) load_chunk(j0 + kJC);
#pragma unroll 8
    for (int jj = 0; jj < kJC; ++jj) {
      const float4 a = *reinterpret_cast<const float4*>(As + jj * kLD + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(Bs + jj * kLD + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < 4; ++p) acc[q][p] = fmaf(av[q], bv[p], acc[q][p]);
    }
    __syncthreads();
    if (more) store_chunk();
    __syncthreads();
  }

  // epilogue: the partial quadratic form of points 4 ty + q over this tile's
  // columns, reduced across the 16 threads of a row by a fixed butterfly
  float quad[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float v = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) v = fmaf(acc[q][p], kC[(4 * tx + p) * kLD + 4 * ty + q], v);
#pragma unroll
    for (int m = 1; m < 16; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    quad[q] = v;
  }
  const int ct0 = (NP + kCT - 1) / kCT;
  if (tx == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) part[part_at(gp, blockIdx.y, 0, g0 + 4 * ty + q, ct0, Gp)] = quad[q];
  }
  // the per-tile sums: four threads per point, 16 columns each, then a butterfly
  const int pp = tid >> 2;
  const int cq = (tid & 3) * (kCT / 4);
  const float thresh = __ldg(params + 4);
  float f1 = 0.f, f2 = 0.f, f3 = 0.f, f4 = 0.f;
  for (int c = cq; c < cq + kCT / 4; ++c) {
    const int j = c0 + c;
    if (j >= n) break;
    const float k = kC[c * kLD + pp];
    if (gp == 0) {
      f1 += k;
      f2 += __ldg(uz + j) * k;
      f3 += __ldg(alpha + j) * k;
      float dmax = 0.f;
#pragma unroll
      for (int cc = 0; cc < D; ++cc) dmax = fmaxf(dmax, fabsf(__ldg(X + (size_t)j * D + cc) - sg[pp * D + cc]));
      if (__ldg(M + j) > 0.f && dmax < thresh) f4 = 1.f;
    } else {
      f1 += __ldg(alpha_tl + j) * k;
    }
  }
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    f1 += __shfl_xor_sync(0xffffffffu, f1, m);
    f2 += __shfl_xor_sync(0xffffffffu, f2, m);
    f3 += __shfl_xor_sync(0xffffffffu, f3, m);
    f4 = fmaxf(f4, __shfl_xor_sync(0xffffffffu, f4, m));
  }
  if ((tid & 3) == 0) {
    const int g = g0 + pp;
    part[part_at(gp, blockIdx.y, 1, g, ct0, Gp)] = f1;
    if (gp == 0) {
      part[part_at(0, blockIdx.y, 2, g, ct0, Gp)] = f2;
      part[part_at(0, blockIdx.y, 3, g, ct0, Gp)] = f3;
      part[part_at(0, blockIdx.y, 4, g, ct0, Gp)] = f4;
    }
  }
}

template <int D>
__global__ void esm_finish_kernel(const float* __restrict__ params, const float* __restrict__ grid, int G,
                                  int NP, int NP2, const float* __restrict__ part, int Gp,
                                  float* __restrict__ out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int ct0 = (NP + kCT - 1) / kCT;
  const int ct1 = (NP2 + kCT - 1) / kCT;
  float quad = 0.f, ksum = 0.f, zv = 0.f, ka = 0.f, quad2 = 0.f, mt = 0.f;
  bool near = false;
  for (int ct = 0; ct < ct0; ++ct) {
    quad += part[part_at(0, ct, 0, g, ct0, Gp)];
    ksum += part[part_at(0, ct, 1, g, ct0, Gp)];
    zv += part[part_at(0, ct, 2, g, ct0, Gp)];
    ka += part[part_at(0, ct, 3, g, ct0, Gp)];
    near = near || part[part_at(0, ct, 4, g, ct0, Gp)] != 0.f;
  }
  for (int ct = 0; ct < ct1; ++ct) {
    quad2 += part[part_at(1, ct, 0, g, ct0, Gp)];
    mt += part[part_at(1, ct, 1, g, ct0, Gp)];
  }
  float xa[D];
#pragma unroll
  for (int c = 0; c < D; ++c) xa[c] = grid[(size_t)g * D + c];
  const float kappa = params[1];
  const float zeta = esm_zeta<D>(xa, params[2], params + 8 + 2 * D, params + 8 + 3 * D);
  out[g] = esm_point(kappa, params[3], params[5], params[6], params[7], params[8 + 3 * D + D * D], zeta,
                     kappa - quad, ksum, zv, ka, near, mt, quad2);
}

template <int D>
int launch(const float* params, const float* grid, int G, const float* xsc, const float* msc,
                 const float* Kinv, const float* uz, const float* alpha, int NP, const float* xs,
                 const float* ms, const float* Kinv_tl, const float* alpha_tl, int NP2, float* part,
                 float* out, cudaStream_t stream) {
  const int ptiles = (G + kPT - 1) / kPT;
  const int nmax = NP > NP2 ? NP : NP2;
  const dim3 tiles(ptiles, (nmax + kCT - 1) / kCT, 2);
  esm_tile_kernel<D><<<tiles, kTThreads, 0, stream>>>(params, grid, G, xsc, msc, Kinv, uz, alpha, NP, xs, ms,
                                                      Kinv_tl, alpha_tl, NP2, part, ptiles * kPT);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  esm_finish_kernel<D><<<(G + 127) / 128, 128, 0, stream>>>(params, grid, G, NP, NP2, part, ptiles * kPT, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `part` is scratch of (5 ceil(NP/64) + 2 ceil(NP2/64)) x Gp floats,
// Gp = G rounded up to 64, allocated by the caller. Two launches.
extern "C" int tpubq_esm_fused(const float* params, const float* grid, int G, int d, const float* xsc,
                               const float* msc, const float* Kinv, const float* uz, const float* alpha,
                               int NP, const float* xs, const float* ms, const float* Kinv_tl,
                               const float* alpha_tl, int NP2, float* part, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1:
      return launch<1>(params, grid, G, xsc, msc, Kinv, uz, alpha, NP, xs, ms, Kinv_tl, alpha_tl, NP2,
                             part, out, s);
    case 2:
      return launch<2>(params, grid, G, xsc, msc, Kinv, uz, alpha, NP, xs, ms, Kinv_tl, alpha_tl, NP2,
                             part, out, s);
    case 3:
      return launch<3>(params, grid, G, xsc, msc, Kinv, uz, alpha, NP, xs, ms, Kinv_tl, alpha_tl, NP2,
                             part, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
