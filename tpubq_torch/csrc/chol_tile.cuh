// The pieces of a 64 x 64 tile Cholesky that the one-launch kernels share
// (chol_blocked.cu, mll_grad.cu): the factor and inverse of a diagonal block
// in one pass by 2 x 2 blocking down to 16 x 16 warp leaves, small products
// over the block, and the flags and tile loads through which work items of
// one launch wait for each other. Every function here is called by all
// kThreads threads of a block.

#pragma once

#include <cfloat>

#include "tri_block.cuh"

namespace tpubq_tile {

constexpr int kT = 64;          // tile
constexpr int kThreads = 256;
constexpr int kLDA = kT + 1;    // stride of the diagonal tile and its inverse
constexpr int kLD4 = kT + 4;    // stride of the k-major product operands (16-byte rows)

// Factor a 16 x 16 block `a` (row-major, stride lda, lower triangle live)
// in place and write its inverse, Y(r, c) at Y[r rs + c cs] (zeros above the
// diagonal), with one warp: lane l < 16 holds row l of the block and column
// l of Y in registers. Step j takes the pivot from lane j by a shuffle,
// scales column j by r = rsqrt(pivot) and stages it in `cols` (16 x 16
// floats of shared memory, 16-byte aligned); after a warp barrier every lane
// reads the column back as float4 broadcasts, once, for both its rank-1
// update (row_k -= l_lj l_kj) and the substitution step of Y (y_j *= r, then
// y_k -= l_kj y_j for k > j), so the inverse rides along the factor's steps.
// The pivot is clamped at FLT_MIN with a NaN kept; the return value says
// whether a pivot was clamped or NaN (the same on every lane). Not inlined:
// the four leaves of a diagonal tile share one copy of the unrolled code.
static __device__ __noinline__ bool chol16_warp(float* a, int lda, float* Y, int rs, int cs, float* cols) {
  const unsigned full = 0xffffffffu;
  const int l = threadIdx.x & 31;
  const bool live = l < 16;
  bool clamped = false;
  float row[16], y[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    row[k] = live && k <= l ? a[l * lda + k] : 0.f;
    y[k] = k == l ? 1.f : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float c = __shfl_sync(full, row[j], j);
    clamped = clamped || !(c >= FLT_MIN);
    c = c < FLT_MIN ? FLT_MIN : c;
    const float r = rsqrtf(c);
    row[j] = l > j ? row[j] * r : (l == j ? c * r : row[j]);
    y[j] *= r;
    if (live) cols[j * 16 + l] = row[j];
    __syncwarp();
#pragma unroll
    for (int k4 = (j + 1) / 4 * 4; k4 < 16; k4 += 4) {
      const float4 v = *reinterpret_cast<const float4*>(cols + j * 16 + k4);
      const float lk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (k4 + t <= j) continue;
        if (l >= k4 + t) row[k4 + t] = fmaf(-row[j], lk[t], row[k4 + t]);
        y[k4 + t] = fmaf(-lk[t], y[j], y[k4 + t]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k <= l) a[l * lda + k] = row[k];
      Y[k * rs + l * cs] = y[k];
    }
  }
  __syncwarp();  // the staged columns are read before the next call writes them
  return clamped;
}

// out(r, c) = sum_m A(r, m) B(c, m) over m < H for all H x H outputs, with
// A(r, m) = pa[r ra + m ma], B(c, m) = pb[c rb + m mb], summed in order of m.
// At H = 32 and 64 each thread keeps an R x R block of outputs, R = H / 16
// (rows R (t / 16) + u, columns R (t % 16) + w), so each loaded value feeds R
// FMAs; at H = 16 one output. f(r, c, value) stores or combines each output.
template <int H, class F>
__device__ __forceinline__ void small_product(const float* pa, int ra, int ma, const float* pb, int rb, int mb,
                                              int tid, F f) {
  if constexpr (H == 16) {
    static_assert(H * H == kThreads, "one output per thread");
    const int r = tid / H;
    const int c = tid % H;
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < H; ++m) acc = fmaf(pa[r * ra + m * ma], pb[c * rb + m * mb], acc);
    f(r, c, acc);
  } else {
    static_assert(H == 32 || H == 64, "H is 16, 32 or 64");
    constexpr int R = H / 16;
    const int r0 = R * (tid / 16);
    const int c0 = R * (tid % 16);
    float acc[R][R] = {};
#pragma unroll 8
    for (int m = 0; m < H; ++m) {
      float av[R], bv[R];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        av[u] = pa[(r0 + u) * ra + m * ma];
        bv[u] = pb[(c0 + u) * rb + m * mb];
      }
#pragma unroll
      for (int u = 0; u < R; ++u)
#pragma unroll
        for (int w = 0; w < R; ++w) acc[u][w] = fmaf(av[u], bv[w], acc[u][w]);
    }
#pragma unroll
    for (int u = 0; u < R; ++u)
#pragma unroll
      for (int w = 0; w < R; ++w) f(r0 + u, c0 + w, acc[u][w]);
  }
}

// Factor a 2H x 2H block `a` (row-major, stride lda, lower triangle live) in
// place and write its inverse, Y(r, c) at Y[r rs + c cs] (zeros above the
// diagonal), as a 2 x 2 block of H x H halves: L11 and Y11 by the level
// below (chol16_warp at H = 16); L21 = A21 Y11^T; L22 and Y22 by the level
// below on A22 - L21 L21^T; Y21 = -(Y22 L21) Y11, skipped if !want_inverse.
// H = 16 or 32 (a 32 or 64 block). The products run over all 256
// threads (small_product), each entry an H-term sum in a fixed order (the
// terms outside the triangles are exact zeros). tmp holds H x H floats,
// 16-byte aligned, at least 256. Returns (on
// warp 0) whether a pivot was clamped or NaN. The caller has synchronized
// after writing `a`; the block is synchronized on return.
template <int H>
__device__ __forceinline__ bool chol_2x2(float* a, int lda, float* Y, int rs, int cs, float* tmp, bool want_inverse,
                                         int tid) {
  bool clamped = false;
  if constexpr (H == 16) {
    if (tid < 32) clamped = chol16_warp(a, lda, Y, rs, cs, tmp);
  } else {
    clamped = chol_2x2<H / 2>(a, lda, Y, rs, cs, tmp, true, tid);
  }
  __syncthreads();
  float* a21 = a + H * lda;
  float* a22 = a21 + H;
  // L21 = A21 Y11^T, through tmp (A21 is read by every entry)
  small_product<H>(a21, lda, 1, Y, rs, cs, tid, [&](int r, int c, float v) { tmp[r * H + c] = v; });
  __syncthreads();
  for (int e = tid; e < H * H; e += kThreads) a21[(e / H) * lda + e % H] = tmp[e];
  __syncthreads();
  // A22 -= L21 L21^T (lower)
  small_product<H>(a21, lda, 1, a21, lda, 1, tid, [&](int r, int c, float v) {
    if (c <= r) a22[r * lda + c] -= v;
  });
  __syncthreads();
  float* y22 = Y + H * rs + H * cs;
  if constexpr (H == 16) {
    if (tid < 32) clamped = chol16_warp(a22, lda, y22, rs, cs, tmp) || clamped;
  } else {
    clamped = chol_2x2<H / 2>(a22, lda, y22, rs, cs, tmp, true, tid) || clamped;
  }
  __syncthreads();
  if (!want_inverse) return clamped;
  // tmp = Y22 L21; zeros of Y12
  small_product<H>(y22, rs, cs, a21, 1, lda, tid, [&](int r, int c, float v) {
    tmp[r * H + c] = v;
    Y[r * rs + (H + c) * cs] = 0.f;
  });
  __syncthreads();
  // Y21 = -tmp Y11
  small_product<H>(tmp, H, 1, Y, cs, rs, tid, [&](int r, int c, float v) { Y[(H + r) * rs + c * cs] = -v; });
  __syncthreads();
  return clamped;
}

// Thread 0 waits for the flag, then the block is synchronized: what the
// flag's item wrote before its release is visible to every thread after.
__device__ __forceinline__ void wait_flag(const int* flag) {
  if (threadIdx.x == 0)
    for (unsigned spins = 0; tpubq_blk::load_acquire(flag) == 0; ++spins)
      if (spins == (1u << 26)) __trap();
  __syncthreads();
}

// The block's stores so far are published under the flag: a barrier, then
// thread 0's release store (cumulative over what the barrier ordered).
__device__ __forceinline__ void publish(int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) tpubq_blk::store_release(flag, 1);
}

// Lt[kk][r] = L[r0 + r][c0 + kk] (k-major, zero past row or column N),
// read through L2: other blocks wrote it during this launch. Where N is a
// multiple of 4 the rows are read as float4 (four columns of one row per
// thread, rows along the warp).
__device__ __forceinline__ void load_tile_kmajor(const float* L, int N, int r0, int c0, float* Lt) {
  if ((N & 3) == 0) {
    for (int e = threadIdx.x; e < kT * kT / 4; e += kThreads) {
      const int r = e % kT;
      const int kk = 4 * (e / kT);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < N && c0 + kk < N) v = __ldcg(reinterpret_cast<const float4*>(L + (size_t)(r0 + r) * N + c0 + kk));
      Lt[(kk + 0) * kLD4 + r] = v.x;
      Lt[(kk + 1) * kLD4 + r] = v.y;
      Lt[(kk + 2) * kLD4 + r] = v.z;
      Lt[(kk + 3) * kLD4 + r] = v.w;
    }
    return;
  }
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int r = e / kT;
    const int kk = e % kT;
    Lt[kk * kLD4 + r] = (r0 + r < N && c0 + kk < N) ? __ldcg(L + (size_t)(r0 + r) * N + c0 + kk) : 0.f;
  }
}

// n floats (a multiple of 4, both ends 16-byte aligned) from device memory
// written during this launch into shared memory, as float4 through L2.
__device__ __forceinline__ void copy_in(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n / 4; e += kThreads)
    reinterpret_cast<float4*>(dst)[e] = __ldcg(reinterpret_cast<const float4*>(src) + e);
}

// L_ij = S Y_jj^T for a tile below the diagonal, from St (k-major S^T) and
// Bm (k-major Y_jj^T) in shared memory: its ni rows into L.
__device__ __forceinline__ void panel_tile(const float* St, const float* Bm, float* L, int N, int i0, int j0,
                                           int ni) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float out[4][4] = {};
  tpubq_blk::tile64_fma(St, Bm, kLD4, tx, ty, out);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = 4 * ty + q;
    if (r >= ni) continue;
#pragma unroll
    for (int p = 0; p < 4; ++p) L[(size_t)(i0 + r) * N + j0 + 4 * tx + p] = out[q][p];
  }
}

// The flag of lower tile (i, j), i >= j, of a T x T tiling, in
// tile-column-major order: T (T + 1) / 2 flags.
__device__ __forceinline__ int flag_of(int i, int j, int T) { return j * T - j * (j - 1) / 2 + (i - j); }

}  // namespace tpubq_tile
