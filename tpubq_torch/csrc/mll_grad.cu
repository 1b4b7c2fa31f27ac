// Masked GP log marginal likelihood and its (h, w) gradient for a batch of
// hyperparameter rows: thetas (B, 2) -> mll (B,), grad (B, 2). The rows share
// one 1-D data set, or each run of `rows_per_problem` consecutive rows has a
// data set (x, y, mask, s) of its own, `data_stride` elements after the one
// before (the fleet fit: every problem's restarts in one launch). With shared
// data the strides are 0 and every block reads the same addresses.
//
// Replaces the TPU kernel `mll_grad_batched` (tpubq/ops/pallas_kernels.py,
// `_mll_kernel` with `_chol_body` and `_tri_inv_body`), the engine of the
// fused multi-restart hyperparameter fit: every optimizer iteration is one
// launch that evaluates all restarts.
//
// Per row (h, w), with m the live mask and y zeroed at pads:
//   K0 = h^2 exp(-(x_i - x_j)^2 / (2 w^2)) m_i m_j
//   K  = K0 + I (1 - m) + I (s^2 + jitter h^2) m      (pads are identity)
//   L  = chol(K), pivot clamped at FLT_MIN;  Y = L^-1;  K^-1 = Y^T Y
//   alpha = K^-1 y
//   mll = -1/2 (y^T alpha + 2 sum_live log L_ii + n_live log 2 pi)
//   d mll / d theta = -1/2 sum_ij (K^-1 - alpha alpha^T)_ij dK_ij / d theta
//   dK/dh = (2/h) K0 + 2 jitter h I m,   dK/dw = K0 r^2 / w,  r = (x_i - x_j)/w
//
// What bounds it: latency, not bytes or FLOPs. A launch moves a few hundred
// bytes and does ~3 n^3 flops per row (0.25 MFLOP at n = 44), but the
// factorization is n dependent column steps and the inverse another chain of
// dependent sums. The design: one block per row (the rows of a fit are few,
// so blocks never share an SM's barrier waits with much else), the Gram built
// in shared memory from x, factored in place by the recursion shared with
// chol_batch.cu, inverted one column per thread without any barrier (each
// column of L^-1 is its own forward substitution), K^-1 written over the
// factor, and K0 and r^2 recomputed from x in the last pass, so two n x n
// matrices of shared memory are enough. What the TPU version does for the
// TPU only is dropped: rounding n up to 8, iota-and-select row extraction,
// HIGHEST-precision dots, scalars in SMEM.
//
// Determinism: every sum has a fixed order (a strided per-thread partial sum,
// then a fixed tree over the block), so the same inputs give the same bits in
// every launch.

#include <cuda_runtime.h>

#include "chol_columns.cuh"

namespace {

constexpr float kLog2Pi = 1.8378770664093453f;
constexpr int kSums = 5;  // dmll/dh, dmll/dw, y^T alpha, sum log L_ii, n_live

__global__ void mll_grad_kernel(const float* __restrict__ thetas, const float* __restrict__ s_ptr,
                                const float* __restrict__ x, const float* __restrict__ y,
                                const unsigned char* __restrict__ mask, float jitter, int n,
                                int rows_per_problem, int data_stride, int s_stride,
                                float* __restrict__ mll, float* __restrict__ grad) {
  extern __shared__ float smem[];
  float* a = smem;          // [n][n] Gram, then L below the diagonal, then K^-1
  float* Y = a + n * n;     // [n][n] L^-1 (lower triangle written)
  float* xs = Y + n * n;    // [n]
  float* ys = xs + n;       // [n] targets, zero at pads
  float* ms = ys + n;       // [n] mask as 0/1
  float* dg = ms + n;       // [n] diagonal of L
  float* al = dg + n;       // [n] alpha
  float* red = al + n;      // [kSums][T] partial sums
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int problem = b / rows_per_problem;
  x += (size_t)problem * data_stride;
  y += (size_t)problem * data_stride;
  mask += (size_t)problem * data_stride;
  const float h = thetas[2 * b];
  const float w = thetas[2 * b + 1];
  const float h2 = h * h;
  const float s = s_ptr[(size_t)problem * s_stride];
  const float s2 = s * s;

  for (int i = tid; i < n; i += T) {
    const float m = mask[i] ? 1.f : 0.f;
    xs[i] = x[i];
    ms[i] = m;
    ys[i] = mask[i] ? y[i] : 0.f;
  }
  __syncthreads();

  for (int t = tid; t < n * n; t += T) {
    const int i = t / n;
    const int j = t % n;
    const float diff = (xs[i] - xs[j]) / w;
    float k = h2 * expf(-0.5f * (diff * diff)) * (ms[i] * ms[j]);
    if (i == j) k += (1.f - ms[i]) + (s2 + jitter * h2) * ms[i];
    a[t] = k;
  }
  __syncthreads();

  tpubq_dev::chol_columns<true>(a, dg, n, tid, T);

  // Y = L^-1: column c solves L y = e_c by forward substitution, on its own
  // thread. At step i every thread is at row c + i with an inner sum of i
  // terms, so a warp does not diverge, and it reads L and Y at a stride of
  // n + 1 floats (conflict-free for even n).
  for (int c = tid; c < n; c += T) {
    for (int j = c; j < n; ++j) {
      float acc = j == c ? 1.f : 0.f;
      for (int k = c; k < j; ++k) acc -= a[j * n + k] * Y[k * n + c];
      Y[j * n + c] = acc / dg[j];
    }
  }
  __syncthreads();

  // K^-1 = Y^T Y over the factor (no longer needed). Entry (i, j) and entry
  // (j, i) run the same sum in the same order, so K^-1 is symmetric to the bit.
  for (int t = tid; t < n * n; t += T) {
    const int i = t / n;
    const int j = t % n;
    float acc = 0.f;
    for (int k = i > j ? i : j; k < n; ++k) acc += Y[k * n + i] * Y[k * n + j];
    a[t] = acc;
  }
  __syncthreads();

  // alpha = K^-1 y, read down the columns (K^-1 is symmetric): conflict-free.
  for (int i = tid; i < n; i += T) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc += a[j * n + i] * ys[j];
    al[i] = acc;
  }
  __syncthreads();

  float p[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int t = tid; t < n * n; t += T) {
    const int i = t / n;
    const int j = t % n;
    const float g = a[t] - al[i] * al[j];
    const float diff = (xs[i] - xs[j]) / w;
    const float r2 = diff * diff;
    const float k0 = h2 * expf(-0.5f * r2) * (ms[i] * ms[j]);
    float dkdh = (2.f / h) * k0;
    if (i == j) dkdh += (2.f * jitter * h) * ms[i];
    p[0] += g * dkdh;
    p[1] += g * (k0 * r2 / w);
  }
  for (int i = tid; i < n; i += T) {
    p[2] += ys[i] * al[i];
    p[3] += ms[i] > 0.f ? logf(dg[i]) : 0.f;
    p[4] += ms[i];
  }
  for (int q = 0; q < kSums; ++q) red[q * T + tid] = p[q];
  __syncthreads();
  for (int half = T / 2; half > 0; half >>= 1) {  // T is a power of two
    if (tid < half) {
      for (int q = 0; q < kSums; ++q) red[q * T + tid] += red[q * T + tid + half];
    }
    __syncthreads();
  }
  if (tid == 0) {
    grad[2 * b] = -0.5f * red[0];
    grad[2 * b + 1] = -0.5f * red[T];
    mll[b] = -0.5f * (red[2 * T] + 2.f * red[3 * T] + red[4 * T] * kLog2Pi);
  }
}

}  // namespace

// `threads` must be a power of two; smem_bytes = 4 (2 n^2 + 5 n + 5 threads).
// Shared data: rows_per_problem = B, data_stride = s_stride = 0. Per-problem
// data: data_stride = n, s_stride = 1 (0 for one shared noise).
extern "C" int tpubq_mll_grad(const float* thetas, const float* s, const float* x, const float* y,
                              const unsigned char* mask, float jitter, int B, int n,
                              int rows_per_problem, int data_stride, int s_stride, int threads,
                              int smem_bytes, float* mll, float* grad, void* stream) {
  if (rows_per_problem < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mll_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mll_grad_kernel<<<B, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      thetas, s, x, y, mask, jitter, n, rows_per_problem, data_stride, s_stride, mll, grad);
  return static_cast<int>(cudaGetLastError());
}
