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
// The column recursion itself lives in chol_columns.cuh, which mll_grad.cu
// shares (there with a clamped pivot).
//
// The second kernel of this file, chol_batched_kernel, replaces the TPU
// kernel `cholesky_batched` (`_chol_kernel` over `_chol_body`): one program
// per matrix, the column recursion with the pivot clamped at FLT_MIN, for a
// stack of any n. It is the batched factorization above chol_batch's
// shared-memory limit (n > 240: marginalize at max_obs >= 256). One block of
// 1024 threads per matrix runs chol_columns_by_rows; for n <= 240 the matrix
// sits in shared memory, above that the working matrix is the output itself,
// in device memory (served from L2 as far as it holds it), and only the
// staged column and the pivots are in shared memory. What bounds it at large
// n: every column step streams the trailing lower triangle through device
// memory (~n^3 / 3 floats read and written per matrix), n dependent steps.
// A clamped (or NaN) pivot sets the matrix's flag, which the wrapper turns
// into NaN in that matrix only.

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

  tpubq_dev::chol_columns<false>(a, dg, n, tid, T);

  for (int t = tid; t < n * n; t += T) {
    const int i = t / n;
    const int k = t % n;
    Lb[t] = k < i ? a[t] : (k == i ? dg[i] : 0.f);
  }
}

template <bool kInShared>
__global__ void __launch_bounds__(1024)
chol_batched_kernel(const float* __restrict__ A, float* __restrict__ L, int* __restrict__ flags, int n) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  float* dg = smem;           // [n]
  float* col = smem + n;      // [n]
  float* a = kInShared ? smem + 2 * n : L + off;  // [n][n], row-major
  const float* Ab = A + off;
  float* Lb = L + off;
  for (int i = tid; i < n * n; i += T) a[i] = Ab[i];
  if (tid == 0) flags[blockIdx.x] = 0;
  __syncthreads();

  tpubq_dev::chol_columns_by_rows(a, dg, col, n, tid, T, flags + blockIdx.x);

  for (int t = tid; t < n * n; t += T) {
    const int i = t / n;
    const int k = t % n;
    Lb[t] = k < i ? a[t] : (k == i ? dg[i] : 0.f);
  }
}

}  // namespace

// smem_bytes = 4 (2 n + n^2) with in_shared, 4 (2 n) without.
extern "C" int tpubq_chol_batched(const float* A, float* L, int* flags, int B, int n, int in_shared,
                                  int threads, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_shared) {
    cudaError_t e = cudaFuncSetAttribute(chol_batched_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    chol_batched_kernel<true><<<B, threads, smem_bytes, s>>>(A, L, flags, n);
  } else {
    cudaError_t e = cudaFuncSetAttribute(chol_batched_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    chol_batched_kernel<false><<<B, threads, smem_bytes, s>>>(A, L, flags, n);
  }
  return static_cast<int>(cudaGetLastError());
}

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
