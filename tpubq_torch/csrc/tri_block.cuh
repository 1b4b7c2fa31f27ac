// Pieces shared by the one-launch triangular solve (tri_solve_blocked.cu), the
// one-launch blocked Cholesky (chol_blocked.cu) and the panelled batched
// Cholesky (chol_batched.cu): the inverse of a lower triangular diagonal
// block by recursive doubling, the clamped column factorization of a
// diagonal block, a 64 x 64 x 64 float32 FMA tile, and the flags and
// ready-marked words through which the one-launch kernels' work items wait
// for each other.

#pragma once

#include <cfloat>

namespace tpubq_blk {

constexpr int kLeaf = 16;

// One level of lower_inverse_doubling: every pair [A 0; C D] of kS x kS
// diagonal blocks with known inverses gets its lower-left block
// -D^-1 (C A^-1). The dot products run over all kS terms, unrolled: the
// terms outside the triangles are exact zeros of A^-1 or D^-1 (for a finite
// Lb), so each sum is the one over the triangle, in the same order.
template <int kS, int kB>
__device__ __forceinline__ void doubling_level(const float* Lb, int ldl, float* Y, int ldy, float* tmp, int tid,
                                               int T) {
  constexpr int per = kS * kS;  // entries of one pair's product
  constexpr int total = (kB / (2 * kS)) * per;
  for (int t = tid; t < total; t += T) {  // tmp = C A^-1
    const int o = (t / per) * 2 * kS;
    const int r = (t % per) / kS;
    const int c = t % kS;
    const float* cr = Lb + (o + kS + r) * ldl + o;
    const float* ac = Y + o * ldy + o + c;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kS; ++k) acc += cr[k] * ac[k * ldy];
    tmp[t] = acc;
  }
  __syncthreads();
  for (int t = tid; t < total; t += T) {  // lower-left = -D^-1 tmp
    const int p = t / per;
    const int o = p * 2 * kS;
    const int r = (t % per) / kS;
    const int c = t % kS;
    const float* dr = Y + (o + kS + r) * ldy + o + kS;
    const float* tc = tmp + p * per + c;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kS; ++k) acc += dr[k] * tc[k * kS];
    Y[(o + kS + r) * ldy + o + c] = -acc;
  }
  __syncthreads();
}

// Y = Lb^-1 for a kB x kB lower triangular block (kB = 16, 32, 64 or 128), Lb
// row-major at stride ldl with its diagonal (only the lower triangle is
// read); Y row-major at stride ldy, zeros above the diagonal. tmp holds
// (kB / 2)^2 floats. Called by all T threads of the block; ends synchronized.
//
// Leaves: the kB / 16 diagonal 16 x 16 blocks, each inverted by 16 threads,
// thread c owning column c in registers and substituting row by row (16
// dependent steps). Levels: for s = 16, 32, ..., kB / 2, every pair
// [A 0; C D] of s x s blocks with known inverses becomes
// [A^-1 0; -D^-1 (C A^-1) D^-1]: two products in shared memory, spread over
// all threads.
template <int kB>
__device__ __forceinline__ void lower_inverse_doubling(const float* Lb, int ldl, float* Y, int ldy,
                                                       float* tmp, int tid, int T) {
  static_assert(kB == 16 || kB == 32 || kB == 64 || kB == 128, "kB must be 16 * 2^k, at most 128");
  for (int t = tid; t < kB * kB; t += T) {
    const int r = t / kB;
    const int c = t % kB;
    if (c / kLeaf > r / kLeaf) Y[r * ldy + c] = 0.f;
  }
  if (tid < kB) {  // column c of a leaf in registers: y[k] = 0 for k < c, so those terms add exact zeros
    const int o = (tid / kLeaf) * kLeaf;
    const int c = tid % kLeaf;
    float y[kLeaf];
#pragma unroll
    for (int r = 0; r < kLeaf; ++r) {
      const float* lr = Lb + (o + r) * ldl + o;
      float s = r == c ? 1.f : 0.f;
#pragma unroll
      for (int k = 0; k < r; ++k) s -= lr[k] * y[k];
      y[r] = r < c ? 0.f : s / lr[r];
      Y[(o + r) * ldy + o + c] = y[r];
    }
  }
  __syncthreads();
  if constexpr (kB > 16) doubling_level<16, kB>(Lb, ldl, Y, ldy, tmp, tid, T);
  if constexpr (kB > 32) doubling_level<32, kB>(Lb, ldl, Y, ldy, tmp, tid, T);
  if constexpr (kB > 64) doubling_level<64, kB>(Lb, ldl, Y, ldy, tmp, tid, T);
}

// Factor the w x w block `a` (w <= 64, row-major, stride lda, lower
// triangle live) in place, with all T threads: on return its lower triangle,
// diagonal included, holds L. The pivot is sqrt(max(c_jj, FLT_MIN)) with a
// NaN c_jj kept, and *flag (device memory) is set to 1 when a pivot was below
// FLT_MIN or NaN. Every entry gets the column recursion's operations in its
// order (subtract l_ij l_kj for j = 0, 1, ..., then divide by the pivot),
// blocked into 16-column sub-panels so that a sub-panel costs three barriers
// instead of two per column:
//   1. warp 0 factors the 16 x 16 diagonal sub-block, lane r holding row r in
//      registers and the columns passed by shuffles;
//   2. one thread per row below solves its 16 entries against it;
//   3. the warps apply the sub-panel's 16 rank-1 terms to the trailing lower
//      triangle of the block, rows over warps, lanes along a row.
// The caller has synchronized after writing `a`; the block is synchronized
// on return.
__device__ __forceinline__ void chol_block_clamped(float* a, int lda, int w, int tid, int T, int* flag) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  for (int o = 0; o < w; o += kLeaf) {
    const int sw = w - o < kLeaf ? w - o : kLeaf;
    if (warp == 0) {
      const int r = lane;
      float row[kLeaf];
#pragma unroll
      for (int k = 0; k < kLeaf; ++k) row[k] = (r < sw && k <= r) ? a[(o + r) * lda + o + k] : 0.f;
#pragma unroll
      for (int j = 0; j < kLeaf; ++j) {
        if (j >= sw) continue;  // (uniform) not break: the loop stays unrolled, row[] in registers
        float c = __shfl_sync(0xffffffffu, row[j], j);
        if (lane == 0 && !(c >= FLT_MIN)) *flag = 1;
        c = c < FLT_MIN ? FLT_MIN : c;
        const float d = sqrtf(c);
        if (r > j) row[j] = row[j] / d;
        else if (r == j) row[j] = d;
        const float lj = row[j];
#pragma unroll
        for (int k = j + 1; k < kLeaf; ++k) {
          const float lk = __shfl_sync(0xffffffffu, lj, k);
          if (r >= k) row[k] -= lj * lk;
        }
      }
      if (r < sw) {
#pragma unroll
        for (int k = 0; k < kLeaf; ++k)
          if (k <= r) a[(o + r) * lda + o + k] = row[k];
      }
    }
    __syncthreads();
    const int p0 = o + kLeaf;  // rows and columns after the sub-panel (only when sw == kLeaf)
    if (p0 + tid < w) {
      float* xr = a + (p0 + tid) * lda + o;
      float x[kLeaf];
#pragma unroll
      for (int j = 0; j < kLeaf; ++j) {
        const float* dj = a + (o + j) * lda + o;
        float v = xr[j];
#pragma unroll
        for (int k = 0; k < j; ++k) v -= x[k] * dj[k];
        x[j] = v / dj[j];
        xr[j] = x[j];
      }
    }
    __syncthreads();
    for (int i = p0 + warp; i < w; i += nwarps) {
      float li[kLeaf];
#pragma unroll
      for (int j = 0; j < kLeaf; ++j) li[j] = a[i * lda + o + j];
      for (int k = p0 + lane; k <= i; k += 32) {
        const float* lk = a + k * lda + o;
        float v = a[i * lda + k];
#pragma unroll
        for (int j = 0; j < kLeaf; ++j) v -= li[j] * lk[j];
        a[i * lda + k] = v;
      }
    }
    __syncthreads();
  }
}

// acc[q][p] += sum_k At[k][4 ty + q] * B[k][4 tx + p] over k < 64: one
// 64 x 64 output tile over 256 threads (tx = tid % 16, ty = tid / 16), 4 x 4
// entries each, both operands k-major in shared memory at stride ld (a
// multiple of 4, 16-byte aligned rows), read as float4. The sum runs over k
// in order, so a tile's result does not depend on timing.
__device__ __forceinline__ void tile64_fma(const float* At, const float* B, int ld, int tx, int ty,
                                           float (&acc)[4][4]) {
#pragma unroll 8
  for (int k = 0; k < 64; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(At + k * ld + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(B + k * ld + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[q][p] = fmaf(av[q], bv[p], acc[q][p]);
  }
}

// Device-scope release store and acquire load of a 32-bit flag.
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Waits until flag j of a chain is set (flags at base[jj * stride] for
// jj < i, set in order: a set flag means all before it are set) and returns
// the last jr in [j, i) such that flags j..jr are all set, acquired by the
// calling thread, so that everything published under them is visible to
// it. One acquire poll per run of ready flags instead of one per flag: lane k
// of the warp looks at flag j + k. Call with the whole warp, warp-uniformly.
// A flag that never comes is a fault, not a wait: the kernel traps after
// 2^26 polls (tens of seconds) instead of hanging the card.
__device__ __forceinline__ int wait_ready_run(const int* base, int stride, int j, int i) {
  for (unsigned spins = 0; load_acquire(base + (size_t)j * stride) == 0; ++spins)
    if (spins == (1u << 26)) __trap();
  const int lane = threadIdx.x & 31;
  const bool set = j + lane < i && load_acquire(base + (size_t)(j + lane) * stride) != 0;
  const unsigned unset = ~__ballot_sync(0xffffffffu, set);
  const int jr = j + (unset == 0u ? 32 : __ffs(unset) - 1) - 1;
  load_acquire(base + (size_t)jr * stride);
  return jr;
}

// A float published with its own ready bit: the 64-bit word {1, bits of x},
// written and read in one piece, so that a reader that sees the bit sees the
// value, with no fence and no separate flag (the low-latency protocol of
// NCCL's LL transport). The reader polls through L2 and traps after 2^26
// polls, as wait_ready_run.
__device__ __forceinline__ void store_word(unsigned long long* p, float x) {
  const unsigned long long w = (1ull << 32) | __float_as_uint(x);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ float wait_word(const unsigned long long* p) {
  unsigned long long w;
  for (unsigned spins = 0;; ++spins) {
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
    if (w >> 32) break;
    if (spins == (1u << 26)) __trap();
  }
  return __uint_as_float(static_cast<unsigned>(w));
}

}  // namespace tpubq_blk
