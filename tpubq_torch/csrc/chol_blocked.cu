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

#include "chol_tile.cuh"

namespace {

using namespace tpubq_tile;

// shared memory: two k-major operands, or the diagonal tile, Y^T, the
// factor's scratch and S^T of the tile below it
constexpr int kDiagSmem = 3 * kT * kLD4 + 32 * 32;
constexpr int kSmem = kDiagSmem > 2 * kT * kLD4 ? kDiagSmem : 2 * kT * kLD4;

// Ticket t -> tile (i, j): tile-column-major over the lower tiles of T x T,
// each column j < T - 1 in the order (j + 1, j), (j, j), (j + 2, j), ...,
// (T - 1, j), so that the diagonal item waits only on lower tickets.
// flag_of(i, j) (chol_tile.cuh) is a tile's flag.
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
