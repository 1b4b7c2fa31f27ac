// Blocked lower Cholesky factor of one N x N float32 matrix: A -> L (row-major,
// exact zeros above the diagonal), and a flag set when a pivot was clamped.
//
// Replaces the TPU kernel `cholesky_blocked` (tpubq/ops/pallas_kernels.py,
// `_chol_blocked_kernel_factory`): a right-looking blocked Cholesky with
// 128-wide panels. For each panel k, in the order of the TPU kernel's body:
//   1. factor the diagonal block A_kk by the column recursion with the pivot
//      clamped at FLT_MIN (`_chol_body`), and form Y_kk = L_kk^-1
//      (`_tri_inv_body`)                                  - diag_block_kernel
//   2. the panel below it, L_ik = A_ik Y_kk^T             - gemm_nt_kernel
//   3. the trailing update, A_ii -= L_ik L_ik^T (lower tiles only)
//                                                         - gemm_nt_kernel
// The TPU kernel runs all of it as one program in VMEM; blocks of one CUDA
// launch cannot wait for each other, so each phase of each panel is one
// launch on the stream: 1 for N <= 128, and 3 ceil(N/128) - 2 in all.
// The last panel may be narrower than 128 rows (no identity padding: every
// kernel masks its ragged edge).
//
// What bounds it: the N diagonal pivots are a chain of dependent steps, each
// ending in a block-wide barrier of the one block that factors the diagonal
// block, while the panel and trailing products (N^3 / 3 multiply-adds in
// all) are hand-written 64 x 64 float32 FMA tiles, 4 x 4 entries per thread,
// that fill the card only while the trailing matrix is large. The design
// keeps the diagonal block and its inverse in shared memory (2 x 64 KB) and
// reuses one 128 x 128 scratch for Y_kk; the working copy of A and the output
// L live in device memory.
//
// Contract: a pivot below FLT_MIN (or NaN) is clamped, so the factor stays
// finite for the caller to reject: the flag says so, and the wrapper turns a
// flagged factor into NaN (the contract of the library Cholesky that the
// jitter ladder reads). Only the lower triangle of A is read.

#include <cuda_runtime.h>

#include "chol_columns.cuh"

namespace {

constexpr int kPanel = 128;
constexpr int kDiagThreads = 256;
constexpr int kTile = 64;    // output tile of gemm_nt_kernel
constexpr int kTileK = 16;   // depth of one shared-memory stage

// Factor the diagonal block at (k0, k0), nb <= kPanel rows, of `work`
// (N x N); write L_kk into L and, if want_inverse, Y_kk = L_kk^-1 (zeros
// above the diagonal) into Yd (kPanel x kPanel).
__global__ void __launch_bounds__(kDiagThreads)
diag_block_kernel(const float* __restrict__ work, int N, int k0, int nb, float* __restrict__ L,
                  float* __restrict__ Yd, int* __restrict__ flag, int want_inverse) {
  extern __shared__ float smem[];
  float* a = smem;              // [nb][nb]
  float* Y = a + nb * nb;       // [nb][nb]
  float* dg = Y + nb * nb;      // [nb]
  float* col = dg + nb;         // [nb]
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  for (int t = tid; t < nb * nb; t += T) a[t] = work[(size_t)(k0 + t / nb) * N + k0 + t % nb];
  __syncthreads();
  tpubq_dev::chol_columns_by_rows(a, dg, col, nb, tid, T, flag);
  for (int t = tid; t < nb * nb; t += T) {
    const int i = t / nb;
    const int k = t % nb;
    L[(size_t)(k0 + i) * N + k0 + k] = k < i ? a[t] : (k == i ? dg[i] : 0.f);
  }
  if (!want_inverse) return;
  tpubq_dev::lower_inverse_columns(a, dg, Y, nb, nb, tid, T);
  __syncthreads();
  for (int t = tid; t < nb * nb; t += T) Yd[(t / nb) * kPanel + t % nb] = Y[t];
}

// C (M x Nc) = [C +] alpha * A B^T, with A (M x K) and B (Nc x K) row-major at
// leading dimensions lda, ldb, ldc. lower_only skips the tiles that lie
// wholly above the diagonal of C. 256 threads: thread (tx, ty) owns the 4 x 4
// entries (ty + 16 q, tx + 16 p) of the 64 x 64 tile; A and B stages are kept
// k-major in shared memory, so a warp reads 16 consecutive B values and 2
// broadcast A values per step.
__global__ void __launch_bounds__(256)
gemm_nt_kernel(const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
               float* __restrict__ C, int ldc, int M, int Nc, int K, float alpha, int accumulate,
               int lower_only) {
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  if (lower_only && col0 > row0 + kTile - 1) return;
  __shared__ float As[kTileK][kTile + 4];
  __shared__ float Bs[kTileK][kTile + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[q][p] = 0.f;

  for (int kk = 0; kk < K; kk += kTileK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + 256 * q;
      const int r = e >> 4;
      const int k = e & 15;
      const int gk = kk + k;
      const int gr = row0 + r;
      const int gc = col0 + r;
      As[k][r] = (gr < M && gk < K) ? A[(size_t)gr * lda + gk] : 0.f;
      Bs[k][r] = (gc < Nc && gk < K) ? B[(size_t)gc * ldb + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) av[q] = As[k][ty + 16 * q];
#pragma unroll
      for (int p = 0; p < 4; ++p) bv[p] = Bs[k][tx + 16 * p];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < 4; ++p) acc[q][p] = fmaf(av[q], bv[p], acc[q][p]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = row0 + ty + 16 * q;
    if (r >= M) continue;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int c = col0 + tx + 16 * p;
      if (c >= Nc) continue;
      const float v = alpha * acc[q][p];
      float* dst = C + (size_t)r * ldc + c;
      *dst = accumulate ? *dst + v : v;
    }
  }
}

}  // namespace

// work (N x N), L (N x N), Yd (kPanel x kPanel) and flag (1 int) are scratch
// and output the caller allocated; A is not written. *launches receives the
// number of kernel launches made.
extern "C" int tpubq_chol_blocked(const float* A, float* work, float* L, float* Yd, int* flag, int N,
                                  int* launches, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  *launches = 0;
  const size_t bytes = (size_t)N * N * sizeof(float);
  cudaError_t e = cudaMemcpyAsync(work, A, bytes, cudaMemcpyDeviceToDevice, stream);
  if (e == cudaSuccess) e = cudaMemsetAsync(L, 0, bytes, stream);
  if (e == cudaSuccess) e = cudaMemsetAsync(flag, 0, sizeof(int), stream);
  const int smem = (2 * kPanel * kPanel + 2 * kPanel) * static_cast<int>(sizeof(float));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(diag_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int k0 = 0; k0 < N; k0 += kPanel) {
    const int nb = N - k0 < kPanel ? N - k0 : kPanel;
    const int rem = N - k0 - nb;
    const int dsmem = (2 * nb * nb + 2 * nb) * static_cast<int>(sizeof(float));
    diag_block_kernel<<<1, kDiagThreads, dsmem, stream>>>(work, N, k0, nb, L, Yd, flag, rem > 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    if (rem == 0) break;
    float* Lik = L + (size_t)(k0 + nb) * N + k0;
    const dim3 panel_grid((nb + kTile - 1) / kTile, (rem + kTile - 1) / kTile);
    gemm_nt_kernel<<<panel_grid, 256, 0, stream>>>(work + (size_t)(k0 + nb) * N + k0, N, Yd, kPanel,
                                                   Lik, N, rem, nb, nb, 1.f, 0, 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    const dim3 trail_grid((rem + kTile - 1) / kTile, (rem + kTile - 1) / kTile);
    gemm_nt_kernel<<<trail_grid, 256, 0, stream>>>(Lik, N, Lik, N,
                                                   work + (size_t)(k0 + nb) * N + k0 + nb, N, rem,
                                                   rem, nb, -1.f, 1, 1);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ++*launches;
  }
  return 0;
}
