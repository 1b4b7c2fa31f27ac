// Forward substitution X = L^-1 R in one launch: L (N, N) lower triangular,
// R and X (N, M), float32 row-major. Only the lower triangle of L is read.
//
// Replaces the TPU kernel `tri_solve_blocked` (tpubq/ops/pallas_kernels.py,
// `_tri_solve_blocked_kernel_factory`), whose body walks the row blocks k in
// order: X_k = Y_kk (R_k - L_k,<k X_<k) with Y_kk = L_kk^-1. On the TPU the
// grid is one sequential program; on Hopper the row blocks become work items
// of one launch that wait for each other through flags in device memory (the
// sync-free triangular solve of Liu, Li, Hou and Vinter, Euro-Par 2016, with
// the ticketing of Merrill and Garland's single-pass decoupled look-back):
//
//   * The solution is cut into items (row block i of 64 rows, column tile c).
//     A block takes its item from an atomic ticket counter, in row-block-major
//     order, so every item it waits on was taken by a block that is already
//     running: no deadlock and no cooperative launch, at any N.
//   * The block forms Y_ii by recursive doubling (tri_block.cuh) while the
//     items above it run, then accumulates R_ic - sum_j L_ij X_jc over
//     j = 0, 1, ..., i-1 in that order, reading L_ij before it waits for
//     X_jc, applies Y_ii, and writes X_ic. The fixed order of the sums makes
//     two calls on the same inputs bit-identical.
//   * M <= 8 (a vector, a few columns): one item per column and row block;
//     warp w owns 8 rows, and its lanes read 64 consecutive entries of each
//     row of L_ij (coalesced), summing per lane, then across the warp by a
//     fixed butterfly. Each entry of X is also published as a 64-bit word
//     {ready, x} (store_word): a waiting lane polls the very entries it needs
//     through L2, so each step of the chain costs one trip through L2, with
//     no flag, fence or barrier between the items.
//   * M > 8: 64-column tiles; L_ij (transposed) and X_jc are staged in shared
//     memory, and each thread keeps a 4 x 4 block of the 64 x 64 tile in
//     registers (tile64_fma), as for the product with Y_ii. A tile is
//     published by a barrier and a release store of its flag, and waited for
//     by acquire loads (one poll per run of flags already set), X then read
//     through L2 with __ldcg.
//
// What bounds it: for a vector, the chain of ceil(N/64) dependent items, each
// adding one trip through L2 and a 64-entry product, a warp reduction and the
// product with Y_ii to the critical path (the bound, reading L's lower
// triangle once, is ~0.6 us at N = 1036); for many columns, the N^2 M / 2
// multiply-adds, shared among the items of every row block.

#include <cuda_runtime.h>

#include "tri_block.cuh"

namespace {

constexpr int kRB = 64;       // rows of a row block
constexpr int kCT = 64;       // columns of a tile (M > kVecMaxM)
constexpr int kVecMaxM = 8;   // up to this many columns, one item per column
constexpr int kThreads = 256;
constexpr int kLD = kRB + 4;  // shared-memory row stride: 16-byte rows, fewer bank conflicts

// Takes the next ticket, loads the diagonal block of row block i (identity
// past row N) into Lb and forms Yb = L_ii^-1. Returns the ticket.
__device__ __forceinline__ int take_item(int* ticket, int* s_ticket, const float* __restrict__ L, int N,
                                         int nct, float* Lb, float* Yb, float* tmp) {
  const int tid = threadIdx.x;
  if (tid == 0) *s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const int t = *s_ticket;
  const int i0 = (t / nct) * kRB;
  const int nb = N - i0 < kRB ? N - i0 : kRB;
  for (int e = tid; e < kRB * kRB; e += kThreads) {
    const int r = e / kRB;
    const int k = e % kRB;
    float v = 0.f;
    if (k <= r) v = r < nb ? L[(size_t)(i0 + r) * N + i0 + k] : (k == r ? 1.f : 0.f);
    Lb[r * kLD + k] = v;
  }
  __syncthreads();
  tpubq_blk::lower_inverse_doubling<kRB>(Lb, kLD, Yb, kLD, tmp, tid, kThreads);
  return t;
}

// One column per item.
__global__ void __launch_bounds__(kThreads)
tri_solve_vec_kernel(const float* __restrict__ L, const float* __restrict__ R, float* X, int* sync,
                     int N, int M) {
  __shared__ __align__(16) float Lb[kRB * kLD];
  __shared__ __align__(16) float Yb[kRB * kLD];
  __shared__ float tmp[kRB * kRB / 4];
  __shared__ float accs[kRB];
  __shared__ int s_ticket;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = take_item(sync, &s_ticket, L, N, M, Lb, Yb, tmp);
  const int i = t / M;
  const int c = t % M;
  const int i0 = i * kRB;
  const int nb = N - i0 < kRB ? N - i0 : kRB;
  unsigned long long* words = reinterpret_cast<unsigned long long*>(sync + 2);  // (N, M), X marked ready

  float part[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) part[q] = 0.f;
  for (int j = 0; j < i; ++j) {
    const int j0 = j * kRB;
    float lv[8][2];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = warp * 8 + q;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        lv[q][h] = r < nb ? L[(size_t)(i0 + r) * N + j0 + lane + 32 * h] : 0.f;
    }
    const float x0 = tpubq_blk::wait_word(words + (size_t)(j0 + lane) * M + c);
    const float x1 = tpubq_blk::wait_word(words + (size_t)(j0 + lane + 32) * M + c);
#pragma unroll
    for (int q = 0; q < 8; ++q) part[q] = fmaf(lv[q][1], x1, fmaf(lv[q][0], x0, part[q]));
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float v = part[q];
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    part[q] = v;
  }
  if (lane < 8) {
    const int r = warp * 8 + lane;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q == lane) v = part[q];
    accs[r] = r < nb ? __ldg(R + (size_t)(i0 + r) * M + c) - v : 0.f;
  }
  __syncthreads();
  // X_ic = Y_ii acc: four threads per row, 16 entries each, then a fixed butterfly
  const int r = tid >> 2;
  const int part4 = tid & 3;
  float s = 0.f;
#pragma unroll
  for (int p = 0; p < 16; ++p) s = fmaf(Yb[r * kLD + part4 * 16 + p], accs[part4 * 16 + p], s);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  if (part4 == 0 && r < nb) {
    X[(size_t)(i0 + r) * M + c] = s;
    tpubq_blk::store_word(words + (size_t)(i0 + r) * M + c, s);
  }
}

// 64-column tiles.
__global__ void __launch_bounds__(kThreads)
tri_solve_tile_kernel(const float* __restrict__ L, const float* __restrict__ R, float* X, int* sync,
                      int N, int M, int nct) {
  extern __shared__ __align__(16) float smem[];
  float* Lt = smem;              // [kRB][kLD]: L_ij transposed; first the diagonal block
  float* Xs = Lt + kRB * kLD;    // [kRB][kLD]: X_jc; first Y_ii; last the accumulated tile
  float* Yt = Xs + kRB * kLD;    // [kRB][kLD]: Y_ii transposed
  float* tmp = Yt + kRB * kLD;   // [kRB * kRB / 4]
  __shared__ int s_ticket;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int t = take_item(sync, &s_ticket, L, N, nct, Lt, Xs, tmp);
  const int i = t / nct;
  const int c = t % nct;
  const int i0 = i * kRB;
  const int c0 = c * kCT;
  const int nb = N - i0 < kRB ? N - i0 : kRB;
  const int cw = M - c0 < kCT ? M - c0 : kCT;
  int* flags = sync + 1;
  for (int e = tid; e < kRB * kRB; e += kThreads) Yt[(e % kRB) * kLD + e / kRB] = Xs[(e / kRB) * kLD + e % kRB];

  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int r = 4 * ty + q;
      const int cc = 4 * tx + p;
      acc[q][p] = (r < nb && cc < cw) ? __ldg(R + (size_t)(i0 + r) * M + c0 + cc) : 0.f;
    }
  int ready = -1;
  for (int j = 0; j < i; ++j) {
    const int j0 = j * kRB;
    __syncthreads();  // the previous product has read Lt and Xs (and Yt is written)
    for (int e = tid; e < kRB * kRB; e += kThreads) {
      const int r = e / kRB;
      const int k = e % kRB;
      Lt[k * kLD + r] = r < nb ? L[(size_t)(i0 + r) * N + j0 + k] : 0.f;
    }
    if (j > ready) ready = tpubq_blk::wait_ready_run(flags + c, nct, j, i);
    for (int e = tid; e < kRB * kCT; e += kThreads) {
      const int k = e / kCT;
      const int cc = e % kCT;
      Xs[k * kLD + cc] = cc < cw ? __ldcg(X + (size_t)(j0 + k) * M + c0 + cc) : 0.f;
    }
    __syncthreads();
    float prod[4][4] = {};
    tpubq_blk::tile64_fma(Lt, Xs, kLD, tx, ty, prod);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < 4; ++p) acc[q][p] -= prod[q][p];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < 4; ++p) Xs[(4 * ty + q) * kLD + 4 * tx + p] = acc[q][p];
  __syncthreads();
  float out[4][4] = {};
  tpubq_blk::tile64_fma(Yt, Xs, kLD, tx, ty, out);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = 4 * ty + q;
    if (r >= nb) continue;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int cc = 4 * tx + p;
      if (cc < cw) X[(size_t)(i0 + r) * M + c0 + cc] = out[q][p];
    }
  }
  // the barrier orders the block's stores of X_ic before thread 0's release
  // store (a release is cumulative over what the barrier ordered before it)
  __syncthreads();
  if (tid == 0) tpubq_blk::store_release(flags + i * nct + c, 1);
}

}  // namespace

// Items of one call: ceil(N/64) row blocks times M columns (M <= 8) or
// ceil(M/64) column tiles. `sync` is zeroed scratch the caller allocated:
// for M <= 8, 2 + 2 N M ints (the ticket, a pad, then the N x M ready-marked
// words of X); above, 1 + items ints (the ticket, then one ready flag per
// item). One launch.
extern "C" int tpubq_tri_solve_blocked(const float* L, const float* R, float* X, int* sync, int N, int M,
                                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nrb = (N + kRB - 1) / kRB;
  if (M <= kVecMaxM) {
    tri_solve_vec_kernel<<<nrb * M, kThreads, 0, stream>>>(L, R, X, sync, N, M);
    return static_cast<int>(cudaGetLastError());
  }
  const int nct = (M + kCT - 1) / kCT;
  const int smem = (3 * kRB * kLD + kRB * kRB / 4) * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(tri_solve_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  tri_solve_tile_kernel<<<nrb * nct, kThreads, smem, stream>>>(L, R, X, sync, N, M, nct);
  return static_cast<int>(cudaGetLastError());
}
