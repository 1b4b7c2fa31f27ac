// Gaussian (RBF) Gram matrix: theta = [h, w_1..w_d], x1 (n1, d), x2 (n2, d)
// -> K (n1, n2), K_ij = h^2 exp(-1/2 sum_k (x1_ik / w_k - x2_jk / w_k)^2),
// all float32 and row-major.
//
// Replaces the TPU kernel `gaussian_gram` (tpubq/ops/pallas_kernels.py,
// `_gram_kernel`), which builds the Gram one (128 x 128) VMEM tile per grid
// step from inputs pre-scaled by 1/w.
//
// What bounds it: the bytes written, 4 n1 n2 (1036^2: 4.3 MB, 1.28 us at
// 3.35 TB/s); the inputs are (n1 + n2) d floats, and once its coordinates
// are scaled an entry costs an expf and a few operations, so the design
// scales each coordinate once per thread rather than per entry, and stores
// 16 bytes at a time. Each thread takes 4 consecutive columns of kRowsPerThread
// = 2 consecutive rows, and the 128 threads of a block form a TX x TY grid
// with TX = 32 column groups where the Gram is that wide and fewer where it
// is not (a Gram of one column puts all of a block's threads on rows): a
// warp's stores are contiguous runs of rows. (Timed against 64 and 256
// threads a block and 1 and 4 rows a thread: PERF.md §6.) Every index
// comes from the block and thread indices, with no integer division, so
// the loads start at once. A thread reads theta once and scales its
// columns and rows by 1/w once, in registers, with the same IEEE x / w as the
// plain version (so the differences are bit-identical to the plain
// version's), 6 d divisions for 8 entries, and writes each row as one 16-byte
// store where its 4 entries are 16-byte aligned (every row when n2 % 4 == 0),
// as scalar stores on other rows and past n2. The sum over k runs in order,
// as in the plain version; the two differ only in expf against torch.exp and
// the rounding of the sum (an FMA per term).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 2;

__global__ void __launch_bounds__(kThreads) gaussian_gram_kernel(const float* __restrict__ theta,
                                                                 const float* __restrict__ x1,
                                                                 const float* __restrict__ x2, int n1, int n2,
                                                                 int d, int tx_log2, float* __restrict__ K) {
  const int tx = threadIdx.x & ((1 << tx_log2) - 1);
  const int ty = threadIdx.x >> tx_log2;
  const int j0 = 4 * ((blockIdx.y << tx_log2) + tx);
  const int i0 = kRowsPerThread * (blockIdx.x * (kThreads >> tx_log2) + ty);
  if (j0 >= n2 || i0 >= n1) return;
  float r2[kRowsPerThread][4] = {};
  for (int k = 0; k < d; ++k) {
    const float w = __ldg(theta + 1 + k);
    float a[kRowsPerThread], b[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) b[t] = j0 + t < n2 ? __ldg(x2 + static_cast<size_t>(j0 + t) * d + k) / w : 0.f;
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q)
      a[q] = i0 + q < n1 ? __ldg(x1 + static_cast<size_t>(i0 + q) * d + k) / w : 0.f;
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float diff = a[q] - b[t];
        r2[q][t] = fmaf(diff, diff, r2[q][t]);
      }
  }
  const float h = __ldg(theta);
  const float h2 = h * h;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    if (i0 + q >= n1) continue;
    float* out = K + static_cast<size_t>(i0 + q) * n2 + j0;
    if (j0 + 3 < n2 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
      *reinterpret_cast<float4*>(out) = make_float4(h2 * expf(-0.5f * r2[q][0]), h2 * expf(-0.5f * r2[q][1]),
                                                    h2 * expf(-0.5f * r2[q][2]), h2 * expf(-0.5f * r2[q][3]));
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (j0 + t < n2) out[t] = h2 * expf(-0.5f * r2[q][t]);
    }
  }
}

}  // namespace

// Row groups on the grid's x axis, column tiles of 4 TX columns on its y
// axis: n2 <= 8,388,480 (65535 tiles of 128 columns).
extern "C" int tpubq_gaussian_gram(const float* theta, const float* x1, const float* x2, int n1, int n2, int d,
                                   float* K, void* stream) {
  if (n1 < 1 || n2 < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (n2 + 3) / 4;
  int tx_log2 = 0;
  while ((1 << tx_log2) < groups && tx_log2 < 5) ++tx_log2;
  const int ty = kThreads >> tx_log2;
  const long long row_groups = (n1 + kRowsPerThread - 1) / kRowsPerThread;
  const dim3 grid(static_cast<unsigned>((row_groups + ty - 1) / ty), (groups + (1 << tx_log2) - 1) >> tx_log2);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  gaussian_gram_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(theta, x1, x2, n1, n2, d, tx_log2,
                                                                                 K);
  return static_cast<int>(cudaGetLastError());
}
