// Batched Cholesky of identity-padded float32 Grams: (B, n, n) -> lower L,
// n <= 240.
//
// Replaces the TPU kernel `cholesky_batch_major` (tpubq/ops/pallas_kernels.py,
// `_chol_bm_kernel`), which put the batch in the vector lanes because XLA's
// batched Cholesky ran one serialized call per matrix. On Hopper the batch
// maps to blocks; the TPU's transposes, 128-lane batch padding and identity
// fill are not needed.
//
// What bounds it: the n dependent column steps, not bytes or FLOPs. A
// (200, 32, 32) stack is 1.6 MB in and out (0.49 us at 3.35 TB/s) and ~2 MFLOP,
// and each step needs the pivot of the step before; 200 matrices fill fewer
// than two blocks an SM, so nothing hides a step's latency. The design keeps
// block barriers and divisions out of the chain: every diagonal block of up
// to 64 rows is factored by one warp with no block barrier (column_steps).
// Lane l holds rows l and, past 32, l + 32 of the block in registers; every
// step is its own template instance, so each index is a compile-time
// register. At step j every lane stages its unscaled entry of column j in
// shared memory (double-buffered, one __syncwarp a step) and reads back the
// pivot c and the column below it as broadcasts (float4), neither waiting
// for the pivot; each lane scales its own entry by r = rsqrt(c) and applies
// its rank-1 update as fma(-(l r), a_kj, .). The chain of a step is one
// store, one load, one rsqrt, two multiplies and an FMA; the diagonal's sqrt
// is taken after the last step. (The same steps with the column broadcast
// by shuffles took 8-13% longer at every stack timed: PERF.md §6.) Three
// regimes by n, chosen by the entry point (tpubq_chol_batch):
//
// * n <= 32: a block of 256 threads per matrix copies it into shared memory
//   and out again (a warp a row, coalesced) around one warp's steps
//   (chol_kernel<16 or 32>, one panel).
// * 32 < n <= 64: one warp per matrix and block, its rows straight from and
//   to device memory (chol_warp_kernel<48 or 64>; float4 where n % 4 == 0
//   and both stacks start on 16 bytes, else a float at a time). With the column broadcast
//   by shuffles, at (128, 44, 44) this took 7.0 us against 10.6 for one
//   64-wide panel of the block kernel and 10.3 for two panels of 32; at
//   n = 32 the block kernel's coalesced copies won, 5.4 us against 6.9
//   (PERF.md §6).
// * 64 < n <= 240: the block kernel in panels of W = 32 (chol_kernel<32>).
//   After the diagonal block (stored with its transpose in the block's dead
//   upper half), one thread per row below solves its row of the panel
//   against it (float4 broadcasts), storing the row and its transpose (in
//   the dead upper half of the panel's rows); then 4 x 4 register tiles of
//   the trailing lower triangle take the panel's rank-32 update from the
//   transposed copy: three barriers a panel.
//
// Contract kept from the TPU kernel: the pivot is NOT clamped, so a matrix
// that is not positive definite gets NaN (rsqrt and sqrt of a negative
// pivot) in its own output only, which the float32 jitter ladder reads. The
// diagonal is sqrt(c) as it comes; the column is scaled by rsqrt(c). Entries
// above the diagonal are exact zeros. Only the lower triangle of the input
// is read. Every launch computes the same values in the same order (no
// atomics), so repeat calls are bit-identical.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPanel = 32;     // the panel width above 64 rows
constexpr int kThreads = 256;
constexpr int kPivots = 32;    // floats for the diagonal block's rsqrt(c)
constexpr int kCols = 128;     // floats of a warp's two staged columns (static)
// Dynamic shared memory of a block beside its static columns: 227 KB in all.
constexpr int kSmemLimit = 232448 - 4 * kCols;

// Row sets a lane holds at padded width P (rows l + 32 r), and the columns
// row set r holds.
template <int P>
__host__ __device__ constexpr int row_sets() {
  return P > 32 ? 2 : 1;
}
template <int P>
__host__ __device__ constexpr int width_of(int r) {
  return P < 32 * (r + 1) ? P : 32 * (r + 1);
}

// Steps J, J + 1, ... (up to n or P) of the right-looking column recursion
// on the rows a warp holds in registers: row[r][k] = A(lane + 32 r, k), the
// lower triangle live. On return row[r][k] = L(lane + 32 r, k) for k <= the
// row, but for the diagonal: the pivot c of row lane + 32 r goes to c_of[r]
// and rsqrt(c) to rr[r] (the row's own diagonal entry is left as it was, so
// that no sqrt sits in the chain of steps); entries above a lane's diagonal
// are garbage, never read. cols: 128 floats of shared memory, 16-byte
// aligned, the warp's own (two staged columns). Called by all 32 lanes.
template <int P, int J>
__device__ __forceinline__ void column_steps(float (&row)[row_sets<P>()][P], float (&c_of)[row_sets<P>()],
                                             float (&rr)[row_sets<P>()], int lane, int n, float* cols) {
  if constexpr (J < P) {
    if (J >= n) return;
    constexpr int R = row_sets<P>();
    float* col = cols + (J & 1) * 64;  // written again two steps on, after a __syncwarp
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (J < width_of<P>(q)) col[lane + 32 * q] = row[q][J];
    __syncwarp();
    const float c = col[J];
    float v[P];  // the unscaled column J (below the pivot where k > J)
#pragma unroll
    for (int k4 = 0; k4 < P; k4 += 4) {
      if (k4 + 3 <= J) continue;
      const float4 u = *reinterpret_cast<const float4*>(col + k4);
      v[k4] = u.x, v[k4 + 1] = u.y, v[k4 + 2] = u.z, v[k4 + 3] = u.w;
    }
    const float r = rsqrtf(c);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (J >= width_of<P>(q)) continue;
      const int i = lane + 32 * q;
      const float l = row[q][J] * r;
      const float w = l * r;
      c_of[q] = i == J ? c : c_of[q];
      rr[q] = i == J ? r : rr[q];
      row[q][J] = i > J ? l : row[q][J];
      // entries above the lane's diagonal are updated too and never read
#pragma unroll
      for (int k = J + 1; k < P; ++k)
        if (k < width_of<P>(q)) row[q][k] = fmaf(-w, v[k], row[q][k]);
    }
    column_steps<P, J + 1>(row, c_of, rr, lane, n, cols);
  }
}

// 32 < n <= 64: one warp per matrix and block, its rows read and written
// whole by their lane straight from and to device memory (float4 where
// n % 4 == 0 and both stacks start on 16 bytes), factored in registers at
// padded width P = 48 or 64.
template <int P>
__global__ void __launch_bounds__(32) chol_warp_kernel(const float* __restrict__ A, float* __restrict__ L, int n) {
  constexpr int R = row_sets<P>();
  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  const bool vec = (n & 3) == 0 && ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(L)) & 15) == 0;

  float row[R][P];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + 32 * q;
    const float* src = A + base + static_cast<size_t>(i) * n;
    if (vec) {
#pragma unroll
      for (int k4 = 0; k4 < P; k4 += 4) {
        if (k4 >= width_of<P>(q)) continue;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < n && k4 < n) v = *reinterpret_cast<const float4*>(src + k4);
        row[q][k4 + 0] = k4 + 0 <= i ? v.x : 0.f;
        row[q][k4 + 1] = k4 + 1 <= i ? v.y : 0.f;
        row[q][k4 + 2] = k4 + 2 <= i ? v.z : 0.f;
        row[q][k4 + 3] = k4 + 3 <= i ? v.w : 0.f;
      }
    } else {
#pragma unroll
      for (int k = 0; k < P; ++k)
        if (k < width_of<P>(q)) row[q][k] = (i < n && k <= i) ? src[k] : 0.f;
    }
  }

  float c_of[R] = {}, rr[R] = {};
  __shared__ __align__(16) float cols[kCols];
  column_steps<P, 0>(row, c_of, rr, lane, n, cols);

#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int i = lane + 32 * q;
    if (i >= n) continue;
    const float d = sqrtf(c_of[q]);  // the diagonal, sqrt(c) as it comes
    float* dst = L + base + static_cast<size_t>(i) * n;
    if (vec) {
#pragma unroll
      for (int k4 = 0; k4 < P; k4 += 4) {
        if (k4 >= width_of<P>(q) || k4 >= n) continue;
        float v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) v[t] = k4 + t < i ? row[q][k4 + t] : (k4 + t == i ? d : 0.f);
        *reinterpret_cast<float4*>(dst + k4) = make_float4(v[0], v[1], v[2], v[3]);
      }
      // columns past the row set's width are above the diagonal
      for (int k = width_of<P>(q); k < n; k += 4) *reinterpret_cast<float4*>(dst + k) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int k = 0; k < P; ++k)
        if (k < width_of<P>(q) && k < n) dst[k] = k < i ? row[q][k] : (k == i ? d : 0.f);
      for (int k = width_of<P>(q); k < n; ++k) dst[k] = 0.f;
    }
  }
}

// The row stride in shared memory: a multiple of 4 (16-byte rows), 4 mod 8
// where that fits (eight consecutive rows' float4 then fall in distinct banks).
__host__ __device__ constexpr int row_stride(int n) {
  return ((n + 3) / 4 * 4) % 8 == 0 && 4 * (n * ((n + 3) / 4 * 4 + 4) + kPivots) <= kSmemLimit
             ? (n + 3) / 4 * 4 + 4
             : (n + 3) / 4 * 4;
}
__host__ __device__ constexpr int smem_bytes_of(int n) { return 4 * (n * row_stride(n) + kPivots); }
static_assert(smem_bytes_of(240) <= kSmemLimit, "n = 240 fits one block's shared memory");

template <int W>
__global__ void __launch_bounds__(kThreads) chol_kernel(const float* __restrict__ A, float* __restrict__ L, int n) {
  extern __shared__ __align__(16) float a[];  // n rows of stride S, lower triangle live
  const int S = row_stride(n);
  float* rinv = a + n * S;                     // rsqrt of the diagonal block's pivots
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int NW = kThreads / 32;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;

  for (int i = warp; i < n; i += NW)
    for (int k = lane; k <= i; k += 32) a[i * S + k] = A[base + static_cast<size_t>(i) * n + k];
  __syncthreads();

  for (int c0 = 0; c0 < n; c0 += W) {
    const int c1 = c0 + W;
    const int m = n - c1;  // rows below the panel
    if (warp == 0) {
      // the diagonal block, one row a lane; then L11 in its lower half and,
      // if a panel follows, L11^T in its upper half (row k holds column k of
      // L11)
      constexpr int R = row_sets<W>();
      const int w = n - c0 < W ? n - c0 : W;
      float row[R][W];
      float c_of[R] = {}, rr[R] = {};
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = lane + 32 * q;
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (k < width_of<W>(q)) row[q][k] = (i < w && k <= i) ? a[(c0 + i) * S + c0 + k] : 0.f;
      }
      __shared__ __align__(16) float cols[kCols];
      column_steps<W, 0>(row, c_of, rr, lane, w, cols);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = lane + 32 * q;
        if (i >= w) continue;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          if (k >= width_of<W>(q) || k >= i) continue;
          a[(c0 + i) * S + c0 + k] = row[q][k];
          if (m > 0) a[(c0 + k) * S + c0 + i] = row[q][k];
        }
        a[(c0 + i) * S + c0 + i] = sqrtf(c_of[q]);
        rinv[i] = rr[q];
      }
    }
    __syncthreads();
    if constexpr (W == kPanel) {
      if (m <= 0) break;
      if (tid < m) {
        // one row of the panel: x L11^T = a, forward in the column order of
        // the recursion; then the row, and its transpose Lt[k][tid] in the
        // dead upper half of the panel's rows (row c0 + k, column c1 + tid)
        float* ai = a + (c1 + tid) * S + c0;
        float x[kPanel];
#pragma unroll
        for (int k4 = 0; k4 < kPanel; k4 += 4) {
          const float4 v = *reinterpret_cast<const float4*>(ai + k4);
          x[k4] = v.x, x[k4 + 1] = v.y, x[k4 + 2] = v.z, x[k4 + 3] = v.w;
        }
#pragma unroll
        for (int k = 0; k < kPanel; ++k) {
          const float l = x[k] * rinv[k];
          x[k] = l;
          const float* uk = a + (c0 + k) * S + c0;  // column k of L11 at uk[k' > k]
#pragma unroll
          for (int k4 = 0; k4 < kPanel; k4 += 4) {
            if (k4 + 3 <= k) continue;
            const float4 u = *reinterpret_cast<const float4*>(uk + k4);
            const float us[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (k4 + e > k) x[k4 + e] = fmaf(-l, us[e], x[k4 + e]);
          }
        }
#pragma unroll
        for (int k4 = 0; k4 < kPanel; k4 += 4)
          *reinterpret_cast<float4*>(ai + k4) = make_float4(x[k4], x[k4 + 1], x[k4 + 2], x[k4 + 3]);
#pragma unroll
        for (int k = 0; k < kPanel; ++k) a[(c0 + k) * S + c1 + tid] = x[k];
      }
      __syncthreads();
      // the trailing lower triangle -= L21 L21^T, 4 x 4 tiles from Lt (tiles
      // past n read padding and are not stored)
      const float* lt = a + c0 * S + c1;
      const int T = (m + 3) / 4;
      for (int e = tid; e < T * T; e += kThreads) {
        const int ti = e / T;
        const int tk = e - ti * T;
        if (tk > ti) continue;
        float acc[4][4] = {};
#pragma unroll 8
        for (int k = 0; k < kPanel; ++k) {
          const float4 xi = *reinterpret_cast<const float4*>(lt + k * S + 4 * ti);
          const float4 xk = *reinterpret_cast<const float4*>(lt + k * S + 4 * tk);
          const float vi[4] = {xi.x, xi.y, xi.z, xi.w};
          const float vk[4] = {xk.x, xk.y, xk.z, xk.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(vi[u], vk[v], acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = c1 + 4 * ti + u;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int k = c1 + 4 * tk + v;
            if (i < n && k <= i) a[i * S + k] -= acc[u][v];
          }
        }
      }
      __syncthreads();
    }
  }

  for (int i = warp; i < n; i += NW)
    for (int k = lane; k < n; k += 32) L[base + static_cast<size_t>(i) * n + k] = k <= i ? a[i * S + k] : 0.f;
}

template <int W>
int launch_block(const float* A, float* L, int B, int n, cudaStream_t s) {
  const int smem_bytes = smem_bytes_of(n);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(chol_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) {
      cudaGetLastError();  // cleared, so that the next launch does not report it
      return static_cast<int>(e);
    }
  }
  chol_kernel<W><<<B, kThreads, smem_bytes, s>>>(A, L, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch for B matrices of n <= 240 rows, a matrix a block: up to 32
// rows the block kernel in one panel of 16 or 32 columns, 33 to 64 rows the
// warp kernel padded to 48 or 64 columns, above 64 the block kernel in
// panels of 32. panels_only sends 33 to 64 rows to the block kernel's panels
// as well (a diagnostic: profile_main_path.py times the two designs there).
extern "C" int tpubq_chol_batch(const float* A, float* L, int B, int n, int panels_only, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || n < 1 || n > 240) return static_cast<int>(cudaErrorInvalidValue);
  if (!panels_only && 32 < n && n <= 64) {
    if (n <= 48)
      chol_warp_kernel<48><<<B, 32, 0, s>>>(A, L, n);
    else
      chol_warp_kernel<64><<<B, 32, 0, s>>>(A, L, n);
    return static_cast<int>(cudaGetLastError());
  }
  return n <= 16 ? launch_block<16>(A, L, B, n, s) : launch_block<kPanel>(A, L, B, n, s);
}
