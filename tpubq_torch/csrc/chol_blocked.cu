// Blocked lower Cholesky factor of one N x N float32 matrix in one launch:
// A -> L (row-major, exact zeros above the diagonal). Only the lower triangle
// of A is read.
//
// Replaces the TPU kernel `cholesky_blocked` (tpubq/ops/pallas_kernels.py,
// `_chol_blocked_kernel_factory`), a right-looking blocked Cholesky that runs
// as one sequential program in VMEM. On Hopper the factor is cut into the
// 64 x 64 tiles of its lower triangle, and each tile is a work item of one
// launch (the scheme of tri_solve_blocked.cu):
//
//   * A block takes its item from an atomic ticket counter, tile column by
//     tile column, column j in the order (j+1, j), (j, j), (j+2, j), ...,
//     (T-1, j), so every item it waits on was taken by a block that is
//     already running: no deadlock and no cooperative launch, at any N.
//   * Left-looking tiles: item (i, j) starts from A_ij and subtracts
//     L_ik L_jk^T for k = 0, 1, ..., j-1 in that order, each as soon as both
//     tiles are published, as a 64 x 64 x 64 float32 FMA tile (tile64_fma).
//     The fixed order makes two calls on the same inputs bit-identical.
//   * The diagonal item (j, j) then factors its tile and forms
//     Y_jj = L_jj^-1 by three levels of 2 x 2 blocking down to 16 x 16
//     leaves (chol_2x2): each leaf factored and inverted in one pass by one
//     warp (chol16_warp), the off-diagonal blocks as products over the
//     block.
//   * Look-ahead: the tile just below the diagonal, (j + 1, j), only
//     accumulates its S and hands it over (Ps); the diagonal item forms
//     L_{j+1,j} = S Y_jj^T itself as soon as it has Y_jj and publishes it,
//     so that the next diagonal item can start. Only then does it write
//     Y_jj^T to a scratch tile for the items further below (which write
//     L_ij = S_ij Y_jj^T), L_jj, and the zeros above the diagonal.
//   * A tile is published by a barrier and a release store of its flag, and
//     waited for by an acquire load (tri_block.cuh); a wait that never ends
//     traps after 2^26 polls instead of hanging the card.
//
// What bounds it: the chain of the T = ceil(N/64) diagonal items. Each
// tile-column adds to the critical path the diagonal factor and its inverse
// (64 dependent pivots), one product (the look-ahead tile), a flag round
// trip through L2, and one product (the next diagonal tile's last update).
// The N^3/3 multiply-adds of the updates are spread over all items and
// overlap the chain.
//
// Contract: a pivot below FLT_MIN (or NaN) is clamped so that the factor stays
// finite, and a flag in the scratch is set; the last diagonal item, once
// every other item's stores are visible to it, turns a flagged factor into
// NaN, so that a matrix that is not positive definite gives a NaN factor (the
// contract of the library Cholesky that the jitter ladder reads).

#include <cuda_runtime.h>

#include <cfloat>

#include "tri_block.cuh"

namespace {

constexpr int kT = 64;          // tile
constexpr int kThreads = 256;
constexpr int kLDA = kT + 1;    // stride of the diagonal tile and its inverse
constexpr int kLD4 = kT + 4;    // stride of the k-major product operands (16-byte rows)
// shared memory: two k-major operands, or the diagonal tile, Y^T, the
// factor's scratch and S^T of the tile below it
constexpr int kDiagSmem = 3 * kT * kLD4 + 32 * 32;
constexpr int kSmem = kDiagSmem > 2 * kT * kLD4 ? kDiagSmem : 2 * kT * kLD4;

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
__device__ __noinline__ bool chol16_warp(float* a, int lda, float* Y, int rs, int cs, float* cols) {
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
// At H = 32 each thread keeps a 2 x 2 block of outputs (rows 2 (t / 16) + u,
// columns 2 (t % 16) + w), so each loaded value feeds two FMAs; at H = 16 one
// output. f(r, c, value) stores or combines each output.
template <int H, class F>
__device__ __forceinline__ void small_product(const float* pa, int ra, int ma, const float* pb, int rb, int mb,
                                              int tid, F f) {
  if constexpr (H == 32) {
    const int r0 = 2 * (tid / 16);
    const int c0 = 2 * (tid % 16);
    float acc[2][2] = {};
#pragma unroll 8
    for (int m = 0; m < H; ++m) {
      const float a0 = pa[r0 * ra + m * ma], a1 = pa[(r0 + 1) * ra + m * ma];
      const float b0 = pb[c0 * rb + m * mb], b1 = pb[(c0 + 1) * rb + m * mb];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int w = 0; w < 2; ++w) f(r0 + u, c0 + w, acc[u][w]);
  } else {
    static_assert(H * H == kThreads, "one output per thread");
    const int r = tid / H;
    const int c = tid % H;
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < H; ++m) acc = fmaf(pa[r * ra + m * ma], pb[c * rb + m * mb], acc);
    f(r, c, acc);
  }
}

// Factor a 2H x 2H block `a` (row-major, stride lda, lower triangle live) in
// place and write its inverse, Y(r, c) at Y[r rs + c cs] (zeros above the
// diagonal), as a 2 x 2 block of H x H halves: L11 and Y11 by the level
// below (chol16_warp at H = 16); L21 = A21 Y11^T; L22 and Y22 by the level
// below on A22 - L21 L21^T; Y21 = -(Y22 L21) Y11, skipped if !want_inverse.
// The products run over all 256 threads (small_product), each entry an
// H-term sum in a fixed order (the terms outside the triangles are exact
// zeros). tmp holds H x H floats, 16-byte aligned, at least 256. Returns (on
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

// Ticket t -> tile (i, j): tile-column-major over the lower tiles of T x T,
// each column j < T - 1 in the order (j + 1, j), (j, j), (j + 2, j), ...,
// (T - 1, j), so that the diagonal item waits only on lower tickets.
// flag_of(i, j) is a tile's flag, in tile-column-major order.
__device__ __forceinline__ void tile_of(int t, int T, int& i, int& j) {
  int start = 0;
  j = 0;
  while (start + (T - j) <= t) {
    start += T - j;
    ++j;
  }
  const int o = t - start;
  i = j == T - 1 ? j : (o == 0 ? j + 1 : (o == 1 ? j : j + o));
}

__device__ __forceinline__ int flag_of(int i, int j, int T) { return j * T - j * (j - 1) / 2 + (i - j); }

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

// The zeros of L's tile (j, i) above the diagonal, mirror of tile (i, j)
// with ni rows.
__device__ __forceinline__ void upper_zeros(float* L, int N, int i0, int j0, int ni) {
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int c = e / kT;
    const int r = e % kT;
    if (r < ni) L[(size_t)(j0 + c) * N + i0 + r] = 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
chol_blocked_kernel(const float* __restrict__ A, float* L, float* Yt, float* Ps, int* sync, int N) {
  extern __shared__ __align__(16) float buf[];  // kSmem floats
  __shared__ int s_ticket;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int T = (N + kT - 1) / kT;
  // sync[0]: the ticket; sync[1]: a pivot was clamped; then one flag per
  // lower tile (L_ij published), then one per column j < T - 1 (the
  // accumulated S_{j+1,j} published to Ps for the diagonal item)
  int* flags = sync + 2;
  int* s_ready = flags + T * (T + 1) / 2;
  if (tid == 0) s_ticket = atomicAdd(sync, 1);
  __syncthreads();
  int i, j;
  tile_of(s_ticket, T, i, j);
  const int i0 = i * kT;
  const int j0 = j * kT;
  const int ni = N - i0 < kT ? N - i0 : kT;
  const int nj = N - j0 < kT ? N - j0 : kT;

  // S = A_ij (only the lower triangle of A is read), then S -= L_ik L_jk^T
  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int r = 4 * ty + q;
      const int c = 4 * tx + p;
      acc[q][p] = (r < ni && c < nj && (i > j || c <= r)) ? A[(size_t)(i0 + r) * N + j0 + c] : 0.f;
    }
  float* Li = buf;               // [kT][kLD4]: L_ik, k-major
  float* Lj = buf + kT * kLD4;   // [kT][kLD4]: L_jk, k-major (Li itself on the diagonal)
  for (int k = 0; k < j; ++k) {
    wait_flag(flags + flag_of(i, k, T));
    if (i != j) wait_flag(flags + flag_of(j, k, T));
    load_tile_kmajor(L, N, i0, k * kT, Li);
    if (i != j) load_tile_kmajor(L, N, j0, k * kT, Lj);
    __syncthreads();
    float prod[4][4] = {};
    tpubq_blk::tile64_fma(Li, i != j ? Lj : Li, kLD4, tx, ty, prod);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[q][p] -= prod[q][p];
    __syncthreads();  // the product has read Li and Lj
  }

  if (i == j + 1) {
    // look-ahead: S_{j+1,j} goes to Ps (k-major S^T) for the diagonal item,
    // which forms L_{j+1,j} as soon as it has Y_jj
    float* ps = Ps + (size_t)j * kT * kLD4;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < 4; ++p) ps[(4 * tx + p) * kLD4 + 4 * ty + q] = acc[q][p];
    publish(s_ready + j);
    return;
  }
  if (i == j) {
    // the diagonal tile, identity past row N, factored in shared memory
    float* a = buf;                   // [kT][kLDA]; later St: [kT][kLD4], S_{j+1,j}^T
    float* Bm = buf + kT * kLD4;      // [kT][kLD4]: Y_jj^T, k-major (Bm[m][c] = Y_jj[c][m])
    float* tmp = Bm + kT * kLD4;      // [32 * 32]
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int r = 4 * ty + q;
        const int c = 4 * tx + p;
        a[r * kLDA + c] = r < nj ? (c <= r ? acc[q][p] : 0.f) : (c == r ? 1.f : 0.f);
      }
    __syncthreads();
    if (chol_2x2<32>(a, kLDA, Bm, 1, kLD4, tmp, j < T - 1, tid) && tid == 0) sync[1] = 1;
    if (j == T - 1) {
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int r = e / kT;
        const int c = e % kT;
        if (r < nj && c < nj) L[(size_t)(j0 + r) * N + j0 + c] = c <= r ? a[r * kLDA + c] : 0.f;
      }
      // The last item. Every other item's stores happened before: its flag
      // was acquired here or by an item whose flag was, and a diagonal
      // item's own flag (j, j) comes last of its stores. A clamped factor
      // becomes NaN as a whole.
      __syncthreads();
      if (*reinterpret_cast<volatile int*>(sync + 1) != 0) {
        for (int jj = 0; jj < T - 1; ++jj) wait_flag(flags + flag_of(jj, jj, T));
        for (size_t e = tid; e < (size_t)N * N; e += kThreads) L[e] = __int_as_float(0x7fc00000);
      }
      return;
    }
    // look-ahead first, on the chain: L_{j+1,j} = S_{j+1,j} Y_jj^T, then its flag
    float* St = tmp + 32 * 32;        // [kT][kLD4]
    wait_flag(s_ready + j);
    copy_in(St, Ps + (size_t)j * kT * kLD4, kT * kLD4);
    __syncthreads();
    const int n1 = N - j0 - kT < kT ? N - j0 - kT : kT;
    panel_tile(St, Bm, L, N, j0 + kT, j0, n1);
    publish(flags + flag_of(j + 1, j, T));
    // then, off the chain: Y_jj^T for the items further below, L_jj, and
    // the zeros above the diagonal; flag (j, j) last
    float* yt = Yt + (size_t)j * kT * kT;
    for (int e = tid; e < kT * kT / 4; e += kThreads)
      reinterpret_cast<float4*>(yt)[e] = *reinterpret_cast<const float4*>(Bm + (4 * e / kT) * kLD4 + 4 * e % kT);
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int r = e / kT;
      const int c = e % kT;
      L[(size_t)(j0 + r) * N + j0 + c] = c <= r ? a[r * kLDA + c] : 0.f;
    }
    upper_zeros(L, N, j0 + kT, j0, n1);
    publish(flags + flag_of(j, j, T));
    return;
  }
  // a tile further below the diagonal: L_ij = S Y_jj^T
  float* St = buf;                // [kT][kLD4]: St[m][r] = S[r][m]
  float* Bm = buf + kT * kLD4;    // [kT][kLD4]: Bm[m][c] = Y_jj[c][m]
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p) St[(4 * tx + p) * kLD4 + 4 * ty + q] = acc[q][p];
  wait_flag(flags + flag_of(j, j, T));
  const float* yt = Yt + (size_t)j * kT * kT;
  for (int e = tid; e < kT * kT / 4; e += kThreads)
    *reinterpret_cast<float4*>(Bm + (4 * e / kT) * kLD4 + 4 * e % kT) = __ldcg(reinterpret_cast<const float4*>(yt) + e);
  __syncthreads();
  panel_tile(St, Bm, L, N, i0, j0, ni);
  upper_zeros(L, N, i0, j0, ni);
  publish(flags + flag_of(i, j, T));
}

}  // namespace

// L (N x N) output; Yt (max(T - 1, 1) x 64 x 64 floats) and Ps
// (max(T - 1, 1) x 64 x 68 floats) scratch; sync (2 + T (T + 1) / 2 + T
// ints, T = ceil(N / 64)) zeroed scratch: the ticket, the clamp flag, one
// flag per lower tile and one per look-ahead tile. All allocated by the
// caller; A is not written. One launch.
extern "C" int tpubq_chol_blocked(const float* A, float* L, float* Yt, float* Ps, int* sync, int N,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int T = (N + kT - 1) / kT;
  const int smem = kSmem * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(chol_blocked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  chol_blocked_kernel<<<T * (T + 1) / 2, kThreads, smem, stream>>>(A, L, Yt, Ps, sync, N);
  return static_cast<int>(cudaGetLastError());
}
