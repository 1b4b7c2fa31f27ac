// Panelled lower Cholesky factors of a (B, n, n) float32 stack, any n: A -> L
// (row-major, exact zeros above the diagonal), and a per-matrix flag set when
// a pivot was clamped.
//
// Replaces the TPU kernel `cholesky_batched` (tpubq/ops/pallas_kernels.py,
// `_chol_kernel` over `_chol_body`): one program per matrix running the
// column recursion with the pivot clamped at tiny. On Hopper the recursion is
// blocked into 64-wide panels, and the batch is a grid axis of every phase,
// so the number of launches depends on n alone: for each panel k,
//   (a) chol_diag_kernel   factor A_kk in shared memory in 16-column
//                          sub-panels (pivot clamped at FLT_MIN, the
//                          matrix's flag set on a clamped or NaN pivot)
//                          and, below all but the last panel,
//                          form Y_kk = L_kk^-1 by recursive doubling; one
//                          block per matrix;
//   (b) chol_panel_kernel  L_ik = A_ik Y_kk^T, 64 rows per block, written to
//                          L and, transposed, to the panel scratch PT (k-major,
//                          so that (c) copies it straight into shared memory);
//   (c) chol_trail_kernel  A_ii -= L_ik L_ik^T on the lower 128 x 128 tiles of
//                          the trailing matrix: both 64 x 128 panel slices
//                          staged by cp.async in two 32-deep groups, 8 x 8
//                          float32 FMA entries per thread in registers, and
//                          the tile read, updated and written once.
// (a) for every panel, (b) and (c) for all but the last: 3 ceil(n/64) - 2
// launches. Panel 0 reads A; every later phase works on L in place (so src
// and L may alias and are not __restrict__).
//
// What bounds it: the trailing updates, ~n^3/3 multiply-adds per matrix
// (7.2e10 at (200, 1024^2), ~2.1 ms at the card's float32 FMA peak) and the
// trailing lower triangles read and written once per panel (~4 GB at
// (200, 1024^2), ~1.2 ms), where the unblocked recursion that this file
// replaced streamed them once per column (~570 GB). The diagonal phases are
// latency: 64 dependent pivots each, one block per matrix.
//
// Contract: only the lower triangle of A is read; a pivot below FLT_MIN (or
// NaN) is clamped so the factor stays finite, and the matrix's flag is set;
// the last diagonal phase turns a flagged matrix into NaN (one block writes
// its n^2 entries), the others are untouched.

#include <cuda_runtime.h>

#include "tri_block.cuh"

namespace {

constexpr int kP = 64;         // panel width
constexpr int kThreads = 256;
constexpr int kLDA = kP + 1;   // stride of the diagonal block and its inverse in shared memory
constexpr int kLD4 = kP + 4;   // stride of the panel kernel's k-major operands
constexpr int kTT = 128;       // trailing tile

__global__ void __launch_bounds__(kThreads)
chol_diag_kernel(const float* src, float* L, float* __restrict__ Yt,
                 int* __restrict__ flags, int n, int k0, int first, int want_inverse) {
  __shared__ float a[kP * kLDA];
  __shared__ float Y[kP * kLDA];
  __shared__ float tmp[kP * kP / 4];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const size_t off = (size_t)b * n * n;
  const int w = n - k0 < kP ? n - k0 : kP;
  for (int e = tid; e < kP * kP; e += kThreads) {
    const int r = e / kP;
    const int k = e % kP;
    float v = 0.f;
    if (k <= r) v = r < w ? src[off + (size_t)(k0 + r) * n + k0 + k] : (k == r ? 1.f : 0.f);
    a[r * kLDA + k] = v;
  }
  if (first && tid == 0) flags[b] = 0;
  __syncthreads();
  tpubq_blk::chol_block_clamped(a, kLDA, w, tid, kThreads, flags + b);
  for (int e = tid; e < w * w; e += kThreads) {
    const int r = e / w;
    const int k = e % w;
    L[off + (size_t)(k0 + r) * n + k0 + k] = k <= r ? a[r * kLDA + k] : 0.f;
  }
  if (!want_inverse) {  // the last panel: a matrix whose flag is set becomes NaN
    __syncthreads();
    if (*reinterpret_cast<volatile int*>(flags + b) != 0)
      for (size_t e = tid; e < (size_t)n * n; e += kThreads) L[off + e] = __int_as_float(0x7fc00000);
    return;
  }
  tpubq_blk::lower_inverse_doubling<kP>(a, kLDA, Y, kLDA, tmp, tid, kThreads);
  float* yt = Yt + (size_t)b * kP * kP;
  for (int e = tid; e < kP * kP; e += kThreads) yt[e] = Y[(e % kP) * kLDA + e / kP];  // yt[p][c] = Y[c][p]
}

__global__ void __launch_bounds__(kThreads)
chol_panel_kernel(const float* src, float* L, const float* __restrict__ Yt,
                  float* __restrict__ PT, int ldp, int n, int k0) {
  __shared__ __align__(16) float At[kP * kLD4];  // At[p][r] = A[r0 + r][k0 + p]
  __shared__ __align__(16) float Bm[kP * kLD4];  // Bm[p][c] = Y_kk[c][p]
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.x;
  const size_t off = (size_t)b * n * n;
  const int r0 = k0 + kP + blockIdx.y * kP;
  const int nr = n - r0 < kP ? n - r0 : kP;
  for (int e = tid; e < kP * kP; e += kThreads) {
    const int r = e / kP;
    const int p = e % kP;
    At[p * kLD4 + r] = r < nr ? src[off + (size_t)(r0 + r) * n + k0 + p] : 0.f;
    Bm[r * kLD4 + p] = Yt[(size_t)b * kP * kP + e];
  }
  __syncthreads();
  float acc[4][4] = {};
  tpubq_blk::tile64_fma(At, Bm, kLD4, tx, ty, acc);
  float* pt = PT + (size_t)b * kP * ldp;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = 4 * ty + q;
    if (r >= nr) continue;
#pragma unroll
    for (int p = 0; p < 4; ++p) L[off + (size_t)(r0 + r) * n + k0 + 4 * tx + p] = acc[q][p];
  }
  if (4 * ty < nr) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      *reinterpret_cast<float4*>(pt + (size_t)(4 * tx + p) * ldp + r0 + 4 * ty) =
          make_float4(acc[0][p], acc[1][p], acc[2][p], acc[3][p]);
  }
  for (int e = tid; e < kP * kP; e += kThreads) {  // zeros above the diagonal: rows of panel k, these columns
    const int c = e / kP;
    const int r = e % kP;
    if (r < nr) L[off + (size_t)(k0 + c) * n + r0 + r] = 0.f;
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kGroups>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kGroups));
}

// acc += As[k][rows] Bs[k][cols]^T for k in [k_lo, k_lo + 32): thread (tx, ty)
// owns rows {4 ty + q, 64 + 4 ty + q} and columns {4 tx + p, 64 + 4 tx + p}.
__device__ __forceinline__ void trail_fma(const float* As, const float* Bs, int k_lo, int tx, int ty,
                                          float (&acc)[8][8]) {
#pragma unroll 4
  for (int k = k_lo; k < k_lo + 32; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + k * kTT + 4 * ty);
    const float4 a1 = *reinterpret_cast<const float4*>(As + k * kTT + 64 + 4 * ty);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * kTT + 4 * tx);
    const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * kTT + 64 + 4 * tx);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int p = 0; p < 8; ++p) acc[q][p] = fmaf(av[q], bv[p], acc[q][p]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
chol_trail_kernel(const float* src, float* L, const float* __restrict__ PT, int ldp,
                  int n, int k0) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;            // [kP][kTT]: panel rows of the tile's row block, k-major
  float* Bs = As + kP * kTT;   // [kP][kTT]: panel rows of its column block
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.x;
  // lower tile t -> (ti, tj), tj <= ti
  const int t = blockIdx.y;
  int ti = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (ti * (ti + 1) / 2 > t) --ti;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int s0 = k0 + kP;
  const int rbase = s0 + ti * kTT;
  const int cbase = s0 + tj * kTT;
  const float* pt = PT + (size_t)b * kP * ldp;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + kThreads * q;  // 1024 16-byte chunks per operand and group
      const int k = 32 * g + e / 32;
      const int ch = 4 * (e % 32);
      const bool va = rbase + ch < n;
      const bool vb = cbase + ch < n;
      cp_async16(As + k * kTT + ch, va ? pt + (size_t)k * ldp + rbase + ch : pt, va ? 16 : 0);
      cp_async16(Bs + k * kTT + ch, vb ? pt + (size_t)k * ldp + cbase + ch : pt, vb ? 16 : 0);
    }
    cp_async_commit();
  }
  float acc[8][8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int p = 0; p < 8; ++p) acc[q][p] = 0.f;
  cp_async_wait<1>();
  __syncthreads();
  trail_fma(As, Bs, 0, tx, ty, acc);
  cp_async_wait<0>();
  __syncthreads();
  trail_fma(As, Bs, 32, tx, ty, acc);

  const size_t off = (size_t)b * n * n;
  const bool diag = ti == tj;
  const bool vec4 = (n & 3) == 0 && !diag;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int r = rbase + (q < 4 ? 4 * ty + q : 64 + 4 * ty + q - 4);
    if (r >= n) continue;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int c0 = cbase + 64 * g + 4 * tx;
      const size_t at = off + (size_t)r * n + c0;
      if (vec4 && c0 + 3 < n) {
        const float4 v = *reinterpret_cast<const float4*>(src + at);
        *reinterpret_cast<float4*>(L + at) =
            make_float4(v.x - acc[q][4 * g], v.y - acc[q][4 * g + 1], v.z - acc[q][4 * g + 2], v.w - acc[q][4 * g + 3]);
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int c = c0 + p;
          if (c < n && (!diag || c <= r)) L[at + p] = src[at + p] - acc[q][4 * g + p];
        }
      }
    }
  }
}

}  // namespace

// L (B, n, n) output; flags (B) ints; Yt (B, 64, 64) and PT (B, 64, ldp) float
// scratch, ldp = n rounded up to a multiple of 4: all allocated by the caller.
// The matrix index is grid.x of every launch; the row or tile index grid.y,
// so n <= 46272 (at most 65535 lower tiles).
// *launches receives the number of kernel launches made.
extern "C" int tpubq_chol_batched(const float* A, float* L, int* flags, float* Yt, float* PT, int ldp, int B,
                                  int n, int* launches, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  *launches = 0;
  const int trail_smem = 2 * kP * kTT * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(chol_trail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, trail_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int k0 = 0; k0 < n; k0 += kP) {
    const int w = n - k0 < kP ? n - k0 : kP;
    const int rem = n - k0 - w;
    const float* src = k0 == 0 ? A : L;
    chol_diag_kernel<<<B, kThreads, 0, stream>>>(src, L, Yt, flags, n, k0, k0 == 0, rem > 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    if (rem == 0) break;
    chol_panel_kernel<<<dim3(B, (rem + kP - 1) / kP), kThreads, 0, stream>>>(src, L, Yt, PT, ldp, n, k0);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    const int T = (rem + kTT - 1) / kTT;
    chol_trail_kernel<<<dim3(B, T * (T + 1) / 2), kThreads, trail_smem, stream>>>(src, L, PT, ldp, n, k0);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ++*launches;
  }
  return 0;
}
