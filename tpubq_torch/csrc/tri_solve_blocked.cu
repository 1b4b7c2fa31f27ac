// Blocked forward substitution X = L^-1 R: L (N, N) lower triangular, R and X
// (N, M), float32 row-major.
//
// Replaces the TPU kernel `tri_solve_blocked` (tpubq/ops/pallas_kernels.py,
// `_tri_solve_blocked_kernel_factory`). For each 128-row block k, as the TPU
// kernel's body does:
//   X_k = Y_kk (R_k - L_k,<k X_<k),   Y_kk = L_kk^-1.
// The inverses of the diagonal blocks depend on L alone, so one launch forms
// all of them at once (diag_inverse_kernel, one block per diagonal block);
// then one launch per row block (block_solve_kernel) computes its X_k, one
// thread block per 32 right-hand-side columns: the product with the rows
// already solved as 32-deep shared-memory stages (thread (tx, ty) owns rows
// ty + 8 q of column tx), then the product with Y_kk from shared memory.
// Row blocks run in stream order, since block k reads X_<k. 1 + ceil(N/128)
// launches in all; the last block may be narrower than 128 rows, and M is not
// padded.
//
// What bounds it: the row blocks are a chain of ceil(N/128) dependent
// launches, and within each the ceil(M/32) thread blocks are few for small M
// (one for a vector): latency, not the N^2 M multiply-adds or the bytes.

#include <cuda_runtime.h>

#include "chol_columns.cuh"

namespace {

constexpr int kPanel = 128;
constexpr int kCols = 32;    // right-hand-side columns per thread block
constexpr int kDepth = 32;   // depth of one stage of the off-diagonal product
constexpr int kSolveThreads = 256;

// Y_kk = L_kk^-1 of every diagonal block into Yd[kb] (kPanel x kPanel each).
__global__ void __launch_bounds__(kPanel)
diag_inverse_kernel(const float* __restrict__ L, int N, float* __restrict__ Yd) {
  extern __shared__ float smem[];
  const int k0 = blockIdx.x * kPanel;
  const int nb = N - k0 < kPanel ? N - k0 : kPanel;
  float* a = smem;            // [nb][nb]
  float* Y = a + nb * nb;     // [nb][nb]
  float* dg = Y + nb * nb;    // [nb]
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  for (int t = tid; t < nb * nb; t += T) a[t] = L[(size_t)(k0 + t / nb) * N + k0 + t % nb];
  for (int i = tid; i < nb; i += T) dg[i] = L[(size_t)(k0 + i) * N + k0 + i];
  __syncthreads();
  tpubq_dev::lower_inverse_columns(a, dg, Y, nb, nb, tid, T);
  __syncthreads();
  float* out = Yd + (size_t)blockIdx.x * kPanel * kPanel;
  for (int t = tid; t < nb * nb; t += T) out[(t / nb) * kPanel + t % nb] = Y[t];
}

__global__ void __launch_bounds__(kSolveThreads)
block_solve_kernel(const float* __restrict__ L, int N, const float* __restrict__ R, int M,
                   float* __restrict__ X, const float* __restrict__ Yk, int k0, int nb) {
  extern __shared__ float smem[];
  float* Ys = smem;                           // [kPanel][kPanel + 1]
  float* acc = Ys + kPanel * (kPanel + 1);    // [kPanel][kCols + 1]
  float* Ls = acc + kPanel * (kCols + 1);     // [kPanel][kDepth + 1]
  float* Xs = Ls + kPanel * (kDepth + 1);     // [kDepth][kCols]
  const int tid = threadIdx.x;
  const int tx = tid % kCols;
  const int ty = tid / kCols;                 // 0..7
  constexpr int kRowsPerThread = kPanel / (kSolveThreads / kCols);  // 16
  const int c = blockIdx.x * kCols + tx;
  const bool col_ok = c < M;

  float part[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int r = ty + 8 * q;
    part[q] = (r < nb && col_ok) ? R[(size_t)(k0 + r) * M + c] : 0.f;
  }
  // part -= L[k0 + r, :k0] X[:k0, c], kDepth columns of L at a time (k0 is a
  // multiple of kPanel, so of kDepth)
  for (int m0 = 0; m0 < k0; m0 += kDepth) {
    for (int e = tid; e < kPanel * kDepth; e += kSolveThreads) {
      const int r = e / kDepth;
      const int m = e % kDepth;
      Ls[r * (kDepth + 1) + m] = r < nb ? L[(size_t)(k0 + r) * N + m0 + m] : 0.f;
    }
    for (int e = tid; e < kDepth * kCols; e += kSolveThreads) {
      const int m = e / kCols;
      const int cc = blockIdx.x * kCols + e % kCols;
      Xs[e] = cc < M ? X[(size_t)(m0 + m) * M + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int m = 0; m < kDepth; ++m) {
      const float xv = Xs[m * kCols + tx];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) part[q] -= Ls[(ty + 8 * q) * (kDepth + 1) + m] * xv;
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) acc[(ty + 8 * q) * (kCols + 1) + tx] = part[q];
  for (int t = tid; t < nb * nb; t += kSolveThreads)
    Ys[(t / nb) * (kPanel + 1) + t % nb] = Yk[(t / nb) * kPanel + t % nb];
  __syncthreads();
  // X_k = Y_kk acc (Y_kk lower triangular)
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int r = ty + 8 * q;
    if (r >= nb || !col_ok) continue;
    float s = 0.f;
    for (int p = 0; p <= r; ++p) s += Ys[r * (kPanel + 1) + p] * acc[p * (kCols + 1) + tx];
    X[(size_t)(k0 + r) * M + c] = s;
  }
}

}  // namespace

// Yd (ceil(N/128) x 128 x 128) is scratch the caller allocated. *launches
// receives the number of kernel launches made.
extern "C" int tpubq_tri_solve_blocked(const float* L, const float* R, float* X, float* Yd, int N,
                                       int M, int* launches, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  *launches = 0;
  const int nblocks = (N + kPanel - 1) / kPanel;
  const int inv_smem = (2 * kPanel * kPanel + kPanel) * static_cast<int>(sizeof(float));
  const int solve_smem = (kPanel * (kPanel + 1) + kPanel * (kCols + 1) + kPanel * (kDepth + 1) +
                          kDepth * kCols) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(diag_inverse_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, inv_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(block_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             solve_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  diag_inverse_kernel<<<nblocks, kPanel, inv_smem, stream>>>(L, N, Yd);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  ++*launches;
  const int col_blocks = (M + kCols - 1) / kCols;
  for (int kb = 0; kb < nblocks; ++kb) {
    const int k0 = kb * kPanel;
    const int nb = N - k0 < kPanel ? N - k0 : kPanel;
    block_solve_kernel<<<col_blocks, kSolveThreads, solve_smem, stream>>>(
        L, N, R, M, X, Yd + (size_t)kb * kPanel * kPanel, k0, nb);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ++*launches;
  }
  return 0;
}
