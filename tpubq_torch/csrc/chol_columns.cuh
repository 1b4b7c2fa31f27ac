// The right-looking column Cholesky recursion of chol_batch.cu, one matrix
// per thread block.

#pragma once

namespace tpubq_dev {

// Factor the n x n row-major matrix `a` (lower triangle live) in place, with
// all T threads of the block. On return the strict lower triangle of `a`
// holds L below its diagonal and dg[j] = L[j][j]; a[j][j] and the upper
// triangle are not meaningful. The caller has synchronized the block after
// writing `a`; the block is synchronized again on return.
//
// The pivot is sqrt(c_jj) as it comes, so a matrix that is not positive
// definite turns NaN from its first bad pivot on.
__device__ __forceinline__ void chol_columns(float* a, float* dg, int n, int tid, int T) {
  for (int j = 0; j < n; ++j) {
    // column j: pivot, then scale the entries below it (a[j][j] is not
    // written here, so every thread reads the same pivot without a barrier)
    const float d = sqrtf(a[j * n + j]);
    for (int i = j + 1 + tid; i < n; i += T) a[i * n + j] = a[i * n + j] / d;
    if (tid == 0) dg[j] = d;
    __syncthreads();
    // rank-1 update of the trailing lower triangle
    const int m = n - j - 1;
    for (int t = tid; t < m * m; t += T) {
      const int i = j + 1 + t / m;
      const int k = j + 1 + t % m;
      if (k <= i) a[i * n + k] -= a[i * n + j] * a[k * n + j];
    }
    __syncthreads();
  }
}

}  // namespace tpubq_dev
