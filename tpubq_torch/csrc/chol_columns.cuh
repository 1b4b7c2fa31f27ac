// The right-looking column Cholesky recursion shared by the kernels that
// factor one matrix per thread block (chol_batch.cu, mll_grad.cu,
// chol_blocked.cu), and the column-per-thread triangular inverse of
// chol_blocked.cu and tri_solve_blocked.cu.

#pragma once

#include <cfloat>

namespace tpubq_dev {

// Factor the n x n row-major matrix `a` (lower triangle live) in place, with
// all T threads of the block. On return the strict lower triangle of `a`
// holds L below its diagonal and dg[j] = L[j][j]; a[j][j] and the upper
// triangle are not meaningful. The caller has synchronized the block after
// writing `a`; the block is synchronized again on return.
//
// kClampPivot = false: the pivot is sqrt(c_jj) as it comes, so a matrix that
// is not positive definite turns NaN from its first bad pivot on.
// kClampPivot = true: the pivot is sqrt(max(c_jj, FLT_MIN)) with a NaN c_jj
// kept, so such a matrix gives huge or non-finite numbers for the caller to
// filter, and a log of the pivot stays finite.
template <bool kClampPivot>
__device__ __forceinline__ void chol_columns(float* a, float* dg, int n, int tid, int T) {
  for (int j = 0; j < n; ++j) {
    // column j: pivot, then scale the entries below it (a[j][j] is not
    // written here, so every thread reads the same pivot without a barrier)
    float c = a[j * n + j];
    if (kClampPivot) c = c < FLT_MIN ? FLT_MIN : c;
    const float d = sqrtf(c);
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

namespace tpubq_dev {

// The same recursion with the rows of each rank-1 update spread over the
// warps (lanes along a row, so no index division) and the scaled column j
// staged in `col` (n floats of shared memory). `a` may lie in shared or in
// device memory: __syncthreads orders both within the block. The pivot is
// clamped at FLT_MIN as in chol_columns<true>, and `*clamped` (if not null)
// is set to 1 when a pivot was below FLT_MIN or NaN, so that the caller can
// tell a clamped factor from a true one. Every entry gets the same operation
// on the same values, step by step, as in chol_columns<true>.
__device__ __forceinline__ void chol_columns_by_rows(float* a, float* dg, float* col, int n, int tid,
                                                     int T, int* clamped) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  for (int j = 0; j < n; ++j) {
    float c = a[j * n + j];
    if (!(c >= FLT_MIN) && clamped != nullptr && tid == 0) *clamped = 1;
    c = c < FLT_MIN ? FLT_MIN : c;
    const float d = sqrtf(c);
    for (int i = j + 1 + tid; i < n; i += T) {
      const float v = a[i * n + j] / d;
      a[i * n + j] = v;
      col[i] = v;
    }
    if (tid == 0) dg[j] = d;
    __syncthreads();
    for (int i = j + 1 + warp; i < n; i += nwarps) {
      const float lij = col[i];
      for (int k = j + 1 + lane; k <= i; k += 32) a[i * n + k] -= lij * col[k];
    }
    __syncthreads();
  }
}

// Y = L^-1 of an n x n lower factor whose strict lower triangle is in `a`
// (row-major, stride n) and whose diagonal is in `dg`: column c solves
// L y = e_c by forward substitution on its own thread, with no barrier (the
// scheme of mll_grad.cu). Y is written row-major with stride ldy, zeros above
// the diagonal included. The caller synchronizes the block afterwards.
__device__ __forceinline__ void lower_inverse_columns(const float* a, const float* dg, float* Y,
                                                      int ldy, int n, int tid, int T) {
  for (int c = tid; c < n; c += T) {
    for (int j = 0; j < c; ++j) Y[j * ldy + c] = 0.f;
    for (int j = c; j < n; ++j) {
      float acc = j == c ? 1.f : 0.f;
      for (int k = c; k < j; ++k) acc -= a[j * n + k] * Y[k * ldy + c];
      Y[j * ldy + c] = acc / dg[j];
    }
  }
}

}  // namespace tpubq_dev
