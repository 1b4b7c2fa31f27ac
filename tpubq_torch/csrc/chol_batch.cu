// Batched Cholesky of identity-padded float32 Grams: (B, n, n) -> lower L.
//
// Replaces the TPU kernel `cholesky_batch_major` (tpubq/ops/pallas_kernels.py,
// `_chol_bm_kernel`), which put the batch in the vector lanes because XLA's
// batched Cholesky ran one serialized call per matrix. On Hopper the batch
// maps to thread blocks instead: one block per matrix, the whole matrix in
// shared memory, and the textbook right-looking column recursion. The TPU's
// transposes, 128-lane batch padding and identity fill are not needed.
//
// What bounds it: latency and synchronization, not bytes or FLOPs. A batch of
// (200, 44, 44) is ~1.5 MB and ~0.5 MFLOP per matrix, but the recursion is n
// sequential column steps, each ending in a block-wide barrier. The design
// keeps every step in shared memory (no device-memory round trip between
// steps), uses two barriers per column, and runs many small blocks per SM so
// that the matrices' barrier waits overlap one another.
//
// Contract kept from the TPU kernel: the pivot is NOT clamped, so a matrix
// that is not positive definite gets NaN (sqrt of a negative pivot) in its
// own output only, which the float32 jitter ladder reads. Entries above the
// diagonal are exact zeros. Only the lower triangle of the input is read.
// The column recursion itself lives in chol_columns.cuh.

#include <cuda_runtime.h>

#include "chol_columns.cuh"

namespace {

__global__ void chol_batch_kernel(const float* __restrict__ A, float* __restrict__ L, int n) {
  extern __shared__ float smem[];
  float* a = smem;          // [n][n], row-major, lower triangle live
  float* dg = smem + n * n; // [n] pivots (the diagonal of L)
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  const float* Ab = A + off;
  float* Lb = L + off;

  for (int i = tid; i < n * n; i += T) a[i] = Ab[i];
  __syncthreads();

  tpubq_dev::chol_columns(a, dg, n, tid, T);

  for (int t = tid; t < n * n; t += T) {
    const int i = t / n;
    const int k = t % n;
    Lb[t] = k < i ? a[t] : (k == i ? dg[i] : 0.f);
  }
}

}  // namespace

extern "C" int tpubq_chol_batch(const float* A, float* L, int B, int n, int threads,
                                int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        chol_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  chol_batch_kernel<<<B, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(A, L, n);
  return static_cast<int>(cudaGetLastError());
}
