// Masked GP log marginal likelihood and its (h, w) gradient for a batch of
// hyperparameter rows: thetas (B, 2) -> mll (B,), grad (B, 2). The rows share
// one 1-D data set, or each run of `rows_per_problem` consecutive rows has a
// data set (x, y, mask, s) of its own, `data_stride` elements after the one
// before (the fleet fit: every problem's restarts in one call). With shared
// data the strides are 0 and every row reads the same addresses.
//
// Replaces the TPU kernel `mll_grad_batched` (tpubq/ops/pallas_kernels.py,
// `_mll_kernel` with `_chol_body` and `_tri_inv_body`), the engine of the
// fused multi-restart hyperparameter fit: every optimizer iteration is one
// call that evaluates all restarts.
//
// Per row (h, w), with m the live mask and y zeroed at pads:
//   K0 = h^2 exp(-(x_i - x_j)^2 / (2 w^2)) m_i m_j
//   K  = K0 + I (1 - m) + I (s^2 + jitter h^2) m      (pads are identity)
//   L  = chol(K), pivot clamped at FLT_MIN (NaN kept);  Y = L^-1;  K^-1 = Y^T Y
//   alpha = K^-1 y
//   mll = -1/2 (y^T alpha + 2 sum_live log L_ii + n_live log 2 pi)
//   d mll / d theta = -1/2 sum_ij (K^-1 - alpha alpha^T)_ij dK_ij / d theta
//   dK/dh = (2/h) K0 + 2 jitter h I m,   dK/dw = K0 r^2 / w,  r = (x_i - x_j)/w
//
// What bounds it: the dependent steps of the factor and the inverse, not
// bytes (a few hundred per row read, three floats written). The operations,
// ~n^3 per row (factor, inverse, the lower half of K^-1), bound it only at
// large n and B. Two regimes; the caller picks one from n alone, and gives
// the tiles a scratch (tpubq_mll_grad):
//
//   * n <= 64 (mll_small_kernel, one launch): one block per row, the row's
//     Gram padded with identity rows to NP = 16, 32 or 64 (exact: a pad
//     has L = Y = 1, alpha = 0 and dK = 0, and is masked out of the log-det)
//     and built in shared memory from x. It is factored and inverted in one
//     pass by 2 x 2 blocking down to 16 x 16 warp leaves (chol_tile.cuh,
//     shared with chol_blocked.cu), K^-1 = Y^T Y is a register-blocked
//     product over the block, and dK/dh and dK/dw are formed from x in the
//     epilogue over the lower triangle, the five sums reduced in a fixed
//     order.
//   * n > 64 (four launches, no size limit): the rows' Grams are cut into
//     64 x 64 tiles, NP = 64 ceil(n / 64), with L and Y kept in a device
//     scratch of (B, NP, NP) floats each (the caller allocates it; its
//     layout is Scratch's, its size tpubq_mll_grad_scratch's).
//       1. mll_factor_kernel: every tile of every row is a work item, taken
//          from an atomic ticket (the scheme of chol_blocked.cu with a row
//          axis): the factor's tiles, each formed from x and left-looking,
//          each diagonal tile factored and inverted in one pass with its
//          look-ahead tile (chol_blocked.cu's), and the tiles of Y below the
//          diagonal, Y_ij = -Y_ii sum_{k=j}^{i-1} L_ik Y_kj, each with its
//          share Y_ij y_j of z = Y y. A row's items come in an order in
//          which each waits only on items before it (item_of), with the
//          chain's next diagonal early; tickets run item by item and row by
//          row within, so every wait is on a lower ticket: no deadlock at
//          any n and B.
//       2. mll_alpha_kernel: alpha = Y^T z, a block per (64 rows, row).
//       3. mll_kinv_kernel: a block per lower tile of K^-1 = sum_k Y_ki^T
//          Y_kj and row, its dK tiles formed from x in the epilogue and
//          reduced into two partial sums per tile.
//       4. mll_finish_kernel: the partials summed in a fixed order, with
//          y^T alpha, the log-det and the live count.
//     A wait that never ends traps after 2^26 polls instead of hanging the
//     card. Nothing is read back on the host.
//
// Determinism: every sum has a fixed order (tile products in order of k,
// strided per-thread sums, then fixed trees), so the same inputs give the
// same bits in every call. float32 FMA throughout, no tensor cores.

#include <cuda_runtime.h>

#include <cfloat>

#include "chol_tile.cuh"

namespace {

using namespace tpubq_tile;

constexpr float kLog2Pi = 1.8378770664093453f;
constexpr int kSums = 5;  // dmll/dh, dmll/dw, y^T alpha, sum log L_ii, n_live

// One row's data and hyperparameters.
struct Row {
  const float* x;
  const float* y;
  const unsigned char* mask;
  int n;
  float h, w, h2, s2, jitter;
  float iw, two_h;  // 1 / w and 2 / h, once per row

  // x, the live mask and the masked target of point r (pads past n: 0, 0, 0)
  __device__ float xv(int r) const { return r < n ? x[r] : 0.f; }
  __device__ float mv(int r) const { return r < n && mask[r] ? 1.f : 0.f; }
  __device__ float yv(int r) const { return r < n && mask[r] ? y[r] : 0.f; }

  // K(i, j) from the points' x and masks (the divisions by w as products
  // with 1 / w: they took half of the Gram's time)
  __device__ float gram(float xi, float xj, float mi, float mj, bool diag) const {
    const float diff = (xi - xj) * iw;
    float k = h2 * expf(-0.5f * (diff * diff)) * (mi * mj);
    if (diag) k += (1.f - mi) + (s2 + jitter * h2) * mi;
    return k;
  }

  // ph += g dK_ij/dh, pw += g dK_ij/dw
  __device__ void grad_terms(float g, float xi, float xj, float mi, float mj, bool diag, float& ph,
                             float& pw) const {
    const float diff = (xi - xj) * iw;
    const float r2 = diff * diff;
    const float k0 = h2 * expf(-0.5f * r2) * (mi * mj);
    float dkdh = two_h * k0;
    if (diag) dkdh += (2.f * jitter * h) * mi;
    ph += g * dkdh;
    pw += g * (k0 * r2 * iw);
  }
};

struct Args {
  const float* thetas;
  const float* s;
  const float* x;
  const float* y;
  const unsigned char* mask;
  float jitter;
  int n, rows_per_problem, data_stride, s_stride;

  __device__ Row row(int b) const {
    const int problem = b / rows_per_problem;
    const size_t off = (size_t)problem * data_stride;
    const float h = thetas[2 * b];
    const float w = thetas[2 * b + 1];
    const float sv = s[(size_t)problem * s_stride];
    return Row{x + off, y + off, mask + off, n, h, w, h * h, sv * sv, jitter, 1.f / w, 2.f / h};
  }
};

// The K sums of every thread reduced in a fixed order over the block: a
// shuffle tree within each warp, then the warps' totals in order (red: at
// least K (kThreads / 32) floats). The totals land in p[q] on thread 0.
template <int K>
__device__ __forceinline__ void block_sums(float (&p)[K], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
#pragma unroll
  for (int q = 0; q < K; ++q) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) p[q] += __shfl_down_sync(0xffffffffu, p[q], off);
    if (lane == 0) red[q * kWarps + warp] = p[q];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += red[q * kWarps + w];
      p[q] = t;
    }
  }
}

// Row b's outputs from its five totals (block_sums' order of kSums).
__device__ __forceinline__ void write_row(float* mll, float* grad, int b, const float (&q)[kSums]) {
  grad[2 * b] = -0.5f * q[0];
  grad[2 * b + 1] = -0.5f * q[1];
  mll[b] = -0.5f * (q[2] + 2.f * q[3] + q[4] * kLog2Pi);
}

// ---------------------------------------------------------------------------
// n <= 64: one block per row
// ---------------------------------------------------------------------------

// Shared memory of mll_small_kernel<NP>, in floats.
__host__ __device__ constexpr int small_tmp(int NP) { return NP * NP / 4 > 256 ? NP * NP / 4 : 256; }
__host__ __device__ constexpr int small_smem(int NP) {
  return small_tmp(NP) + 2 * NP * (NP + 1) + 5 * NP + kSums * kThreads / 32;
}

template <int NP>
__global__ void __launch_bounds__(kThreads, 3) mll_small_kernel(Args args, float* __restrict__ mll,
                                                             float* __restrict__ grad) {
  constexpr int LD = NP + 1;  // odd: the products' strided reads spread over the banks
  extern __shared__ __align__(16) float smem[];
  float* tmp = smem;                 // the recursion's scratch (16-byte aligned)
  float* a = tmp + small_tmp(NP);    // [NP][LD] Gram, then L, then K^-1
  float* Y = a + NP * LD;            // [NP][LD] L^-1, row-major
  float* xs = Y + NP * LD;           // [NP]
  float* ms = xs + NP;               // [NP] mask as 0/1
  float* ys = ms + NP;               // [NP] targets, zero at pads
  float* dg = ys + NP;               // [NP] diagonal of L
  float* al = dg + NP;               // [NP] alpha
  float* red = al + NP;              // [kSums][kThreads / 32]
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int n = args.n;
  const Row p = args.row(b);

  for (int i = tid; i < NP; i += kThreads) {
    xs[i] = p.xv(i);
    ms[i] = p.mv(i);
    ys[i] = p.yv(i);
  }
  __syncthreads();
  // the Gram's lower triangle, the recursion reads no more (rows past n
  // are the identity's); a trip count fixed at compile time, unrolled, so
  // that the entries' exponentials overlap
#pragma unroll 4
  for (int e = 0; e < NP * NP / kThreads; ++e) {
    const int t = e * kThreads + tid;
    const int i = t / NP;
    const int j = t % NP;
    if (j <= i) a[i * LD + j] = i < n ? p.gram(xs[i], xs[j], ms[i], ms[j], i == j) : (i == j ? 1.f : 0.f);
  }
  __syncthreads();
  if constexpr (NP == 16) {
    if (tid < 32) chol16_warp(a, LD, Y, LD, 1, tmp);
    __syncthreads();
  } else {
    chol_2x2<NP / 2>(a, LD, Y, LD, 1, tmp, true, tid);
  }
  for (int i = tid; i < NP; i += kThreads) dg[i] = a[i * LD + i];
  __syncthreads();

  // K^-1(r, c) = sum_m Y(m, r) Y(m, c) over the factor; (r, c) and (c, r)
  // run the same sum, so K^-1 is symmetric to the bit
  small_product<NP>(Y, 1, LD, Y, 1, LD, tid, [&](int r, int c, float v) { a[r * LD + c] = v; });
  __syncthreads();

  // alpha = K^-1 y, read down the columns (K^-1 is symmetric): conflict-free.
  // kThreads / NP threads per entry, each over NP^2 / kThreads rows, their
  // shares then summed in order (through kThreads floats of tmp).
  {
    constexpr int kParts = kThreads / NP;
    constexpr int kRows = NP / kParts;
    const int i = tid % NP;
    const int part = tid / NP;
    float acc = 0.f;
#pragma unroll 8
    for (int j = part * kRows; j < (part + 1) * kRows; ++j) acc = fmaf(a[j * LD + i], ys[j], acc);
    tmp[part * NP + i] = acc;
    __syncthreads();
    if (tid < NP) {
      float t = 0.f;
      for (int q = 0; q < kParts; ++q) t += tmp[q * NP + tid];
      al[tid] = t;
    }
    __syncthreads();
  }

  // the gradient's sums over the lower triangle, twice each term below the
  // diagonal (K^-1 - alpha alpha^T and dK are symmetric), unrolled as above
  float q[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int e = 0; e < NP * NP / kThreads; ++e) {
    const int t = e * kThreads + tid;
    const int i = t / NP;
    const int j = t % NP;
    if (j <= i && i < n) {
      const float g = a[i * LD + j] - al[i] * al[j];
      p.grad_terms(i == j ? g : 2.f * g, xs[i], xs[j], ms[i], ms[j], i == j, q[0], q[1]);
    }
  }
  for (int i = tid; i < n; i += kThreads) {
    q[2] += ys[i] * al[i];
    q[3] += ms[i] > 0.f ? logf(dg[i]) : 0.f;
    q[4] += ms[i];
  }
  block_sums(q, red);
  if (tid == 0) write_row(mll, grad, b, q);
}

// ---------------------------------------------------------------------------
// n > 64: tiles through a device-memory scratch
// ---------------------------------------------------------------------------

// shared memory of mll_factor_kernel: two k-major operands, or the diagonal
// tile, Y^T, the recursion's scratch and S^T of the tile below it
constexpr int kFactorSmem = 3 * kT * kLD4 + 32 * 32;
constexpr int kKinvSmem = 2 * kT * kLD4 + 2 * kThreads / 32;

// dst[m][c] = M[r0 + m][c0 + c] (row-major at stride kLD4) from a matrix of
// N columns, N a multiple of 64, as float4 through L2.
__device__ __forceinline__ void load_rows(const float* M, int N, int r0, int c0, float* dst) {
  for (int e = threadIdx.x; e < kT * kT / 4; e += kThreads) {
    const int m = e / (kT / 4);
    const int c4 = 4 * (e % (kT / 4));
    *reinterpret_cast<float4*>(dst + m * kLD4 + c4) =
        __ldcg(reinterpret_cast<const float4*>(M + (size_t)(r0 + m) * N + c0 + c4));
  }
}

// The scratch of one tiled call, cut into its parts. Its sizes, `floats`
// and `ints`, are what tpubq_mll_grad_scratch gives the caller to allocate.
struct Scratch {
  float* L;     // [B][NP][NP] the factor's tiles below the diagonal
  float* Y;     // [B][NP][NP] L^-1's tiles on and below the diagonal
  float* Ps;    // [B][T][kT][kLD4] look-ahead tiles S^T
  float* zp;    // [B][T][T][kT] Y_ij y_j, j <= i
  float* dg;    // [B][NP] diagonal of L
  float* al;    // [B][NP] alpha
  float* part;  // [B][T (T + 1) / 2][2] per-tile gradient sums
  int* sync;    // the ticket, then per row the L and Y tile flags and the
                // look-ahead flags
  size_t floats, ints;

  __device__ __host__ Scratch(float* f, int* s, int B, int T) {
    const size_t NP = (size_t)T * kT;
    const size_t U = (size_t)T * (T + 1) / 2;
    // the next `count` floats (offsets: a null base only sizes the parts)
    floats = 0;
    auto take = [&](size_t count) {
      float* at = f ? f + floats : nullptr;
      floats += count;
      return at;
    };
    L = take(B * NP * NP);
    Y = take(B * NP * NP);
    Ps = take((size_t)B * T * kT * kLD4);
    zp = take((size_t)B * T * T * kT);
    dg = take(B * NP);
    al = take(B * NP);
    part = take(2 * B * U);
    sync = s;
    ints = 1 + B * (2 * U + T);
  }
};

__device__ __forceinline__ void gram_tile(const Row& p, int i0, int j0, float (&acc)[4][4]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float xc[4], mc[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    xc[t] = p.xv(j0 + 4 * tx + t);
    mc[t] = p.mv(j0 + 4 * tx + t);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = i0 + 4 * ty + q;
    const float xr = p.xv(r);
    const float mr = p.mv(r);
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[q][t] = p.gram(xr, xc[t], mr, mc[t], r == j0 + 4 * tx + t);
  }
}

// Work items of a row, in the order a row's tickets take them: kind 0 is
// the factor's tile (i, j), kind 1 the tile (i, j) of Y below the diagonal.
// Stage s is column s of the factor and row s of Y; the chain's items of
// stage s + 1, its look-ahead tile (s + 2, s + 1) and diagonal tile
// (s + 1, s + 1), come early in stage s, right after the one tile they wait
// on there, (s + 2, s):
//   (1, 0), (0, 0), then for s = 0, 1, ...: (s + 2, s), (s + 2, s + 1),
//   (s + 1, s + 1), (s + 3 ... T - 1, s), Y (s, 0 ... s - 1),
// dropping the tiles past T - 1. Every item waits only on items before it,
// and a diagonal item accumulates its left-looking products while the
// stage before it runs. T^2 items.
__device__ __forceinline__ void item_of(int q, int T, int& kind, int& i, int& j) {
  kind = 0;
  if (T == 1 || q < 2) {  // the first look-ahead tile, then the first diagonal
    i = T == 1 ? 0 : 1 - q;
    j = 0;
    return;
  }
  int r = q - 2;
  if (r < (T - 2) * T) {  // stage s <= T - 3: T items
    const int st = r / T;
    const int o = r % T;
    if (o < 3) {
      i = o == 2 ? st + 1 : st + 2;
      j = o == 0 ? st : st + 1;
    } else if (o < T - st) {
      i = st + o;
      j = st;
    } else {
      kind = 1;
      i = st;
      j = o - (T - st);
    }
    return;
  }
  r -= (T - 2) * T;  // stage T - 2: the last diagonal, then Y's row; stage T - 1: Y's row
  const int st = r < T - 1 ? T - 2 : T - 1;
  const int o = r < T - 1 ? r : r - (T - 1);
  if (st == T - 2 && o == 0) {
    i = j = T - 1;
    return;
  }
  kind = 1;
  i = st;
  j = st == T - 2 ? o - 1 : o;
}

__global__ void __launch_bounds__(kThreads, 2)
mll_factor_kernel(Args args, int B, int T, float* scratch, int* sync_ptr) {
  extern __shared__ __align__(16) float buf[];  // kFactorSmem floats
  __shared__ int s_ticket;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const Scratch sc(scratch, sync_ptr, B, T);
  if (tid == 0) s_ticket = atomicAdd(sc.sync, 1);
  __syncthreads();
  const int b = s_ticket % B;
  int kind, i, j;
  item_of(s_ticket / B, T, kind, i, j);
  const int NP = T * kT;
  const int U = T * (T + 1) / 2;
  const Row p = args.row(b);
  float* L = sc.L + (size_t)b * NP * NP;
  float* Y = sc.Y + (size_t)b * NP * NP;
  int* fl = sc.sync + 1 + (size_t)b * (2 * U + T);  // L_ij published (Y_jj and L's diagonal with (j, j))
  int* fy = fl + U;                                 // Y_ij published, i > j
  int* s_ready = fy + U;                            // S_{j+1,j} in Ps
  float* zp = sc.zp + (size_t)b * T * T * kT;

  if (kind == 1) {
    // a tile of Y below the diagonal: Y_ij = -Y_ii sum_{k=j}^{i-1} L_ik Y_kj
    const int i0 = i * kT;
    const int j0 = j * kT;
    float* At = buf;              // [kT][kLD4]
    float* Bs = buf + kT * kLD4;  // [kT][kLD4]
    float acc[4][4] = {};
    for (int k = j; k < i; ++k) {
      wait_flag(fl + flag_of(i, k, T));
      wait_flag(k == j ? fl + flag_of(j, j, T) : fy + flag_of(k, j, T));
      load_tile_kmajor(L, NP, i0, k * kT, At);  // At[m][r] = L_ik(r, m)
      load_rows(Y, NP, k * kT, j0, Bs);          // Bs[m][c] = Y_kj(m, c)
      __syncthreads();
      tpubq_blk::tile64_fma(At, Bs, kLD4, tx, ty, acc);
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int t = 0; t < 4; ++t) Bs[(4 * ty + q) * kLD4 + 4 * tx + t] = acc[q][t];
    wait_flag(fl + flag_of(i, i, T));
    load_tile_kmajor(Y, NP, i0, i0, At);  // At[m][r] = Y_ii(r, m)
    __syncthreads();
    float out[4][4] = {};
    tpubq_blk::tile64_fma(At, Bs, kLD4, tx, ty, out);
    float yc[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) yc[t] = p.yv(j0 + 4 * tx + t);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 4 * ty + q;
      const float4 v = make_float4(-out[q][0], -out[q][1], -out[q][2], -out[q][3]);
      *reinterpret_cast<float4*>(Y + (size_t)(i0 + r) * NP + j0 + 4 * tx) = v;
      // z share of row r: sum over the tile's columns, the 16 lanes of a row
      // reduced by a fixed butterfly
      float z = fmaf(v.w, yc[3], fmaf(v.z, yc[2], fmaf(v.y, yc[1], v.x * yc[0])));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) z += __shfl_xor_sync(0xffffffffu, z, off);
      if (tx == 0) zp[((size_t)i * T + j) * kT + r] = z;
    }
    publish(fy + flag_of(i, j, T));
    return;
  }

  // a tile of the factor
  const int i0 = i * kT;
  const int j0 = j * kT;
  float acc[4][4];
  gram_tile(p, i0, j0, acc);
  float* Li = buf;               // [kT][kLD4]: L_ik, k-major
  float* Lj = buf + kT * kLD4;   // [kT][kLD4]: L_jk, k-major (Li itself on the diagonal)
  for (int k = 0; k < j; ++k) {
    wait_flag(fl + flag_of(i, k, T));
    if (i != j) wait_flag(fl + flag_of(j, k, T));
    load_tile_kmajor(L, NP, i0, k * kT, Li);
    if (i != j) load_tile_kmajor(L, NP, j0, k * kT, Lj);
    __syncthreads();
    float prod[4][4] = {};
    tpubq_blk::tile64_fma(Li, i != j ? Lj : Li, kLD4, tx, ty, prod);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[q][t] -= prod[q][t];
    __syncthreads();  // the product has read Li and Lj
  }

  float* ps = sc.Ps + ((size_t)b * T + j) * kT * kLD4;
  if (i == j + 1) {
    // look-ahead: S_{j+1,j} goes to Ps (k-major S^T) for the diagonal item
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int t = 0; t < 4; ++t) ps[(4 * tx + t) * kLD4 + 4 * ty + q] = acc[q][t];
    publish(s_ready + j);
    return;
  }
  if (i == j) {
    float* a = buf;                   // [kT][kLDA]
    float* Bm = buf + kT * kLD4;      // [kT][kLD4]: Bm[m][c] = Y_jj(c, m)
    float* tmp = Bm + kT * kLD4;      // [32 * 32]
    float* St = tmp + 32 * 32;        // [kT][kLD4]
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int r = 4 * ty + q;
        const int c = 4 * tx + t;
        a[r * kLDA + c] = c <= r ? acc[q][t] : 0.f;
      }
    __syncthreads();
    chol_2x2<32>(a, kLDA, Bm, 1, kLD4, tmp, true, tid);
    if (j < T - 1) {
      // on the chain: L_{j+1,j} = S_{j+1,j} Y_jj^T, then its flag
      wait_flag(s_ready + j);
      copy_in(St, ps, kT * kLD4);
      __syncthreads();
      panel_tile(St, Bm, L, NP, j0 + kT, j0, kT);
      publish(fl + flag_of(j + 1, j, T));
    }
    // then Y_jj (row-major), L's diagonal and Y_jj y_j; flag (j, j) last
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int r = e / kT;
      const int c = e % kT;
      Y[(size_t)(j0 + r) * NP + j0 + c] = Bm[c * kLD4 + r];
    }
    if (tid < kT) {
      sc.dg[(size_t)b * NP + j0 + tid] = a[tid * kLDA + tid];
      float z = 0.f;
      for (int c = 0; c < kT; ++c) z = fmaf(Bm[c * kLD4 + tid], p.yv(j0 + c), z);
      zp[((size_t)j * T + j) * kT + tid] = z;
    }
    publish(fl + flag_of(j, j, T));
    return;
  }
  // a tile further below the diagonal: L_ij = S Y_jj^T
  float* St = buf;                // [kT][kLD4]: St[m][r] = S[r][m]
  float* Bm = buf + kT * kLD4;    // [kT][kLD4]: Bm[m][c] = Y_jj(c, m)
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int t = 0; t < 4; ++t) St[(4 * tx + t) * kLD4 + 4 * ty + q] = acc[q][t];
  wait_flag(fl + flag_of(j, j, T));
  load_tile_kmajor(Y, NP, j0, j0, Bm);
  __syncthreads();
  panel_tile(St, Bm, L, NP, i0, j0, kT);
  publish(fl + flag_of(i, j, T));
}

// alpha_j = sum_{i >= j} Y_ij^T z_i, z_i = sum_{k <= i} Y_ik y_k: a block per
// (tile row j, row b). Shared memory: (T - j + 4) kT floats.
__global__ void __launch_bounds__(kThreads) mll_alpha_kernel(int T, float* scratch, int B) {
  extern __shared__ float zs[];  // [T - j][kT] z_i, then [4][kT] partial sums
  const Scratch sc(scratch, nullptr, B, T);
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int NP = T * kT;
  const int m = T - j;
  const float* Y = sc.Y + (size_t)b * NP * NP;
  for (int e = tid; e < m * kT; e += kThreads) {
    const int i = j + e / kT;
    const float* zpi = sc.zp + ((size_t)b * T + i) * T * kT + e % kT;
    float z = 0.f;
    for (int k = 0; k <= i; ++k) z += zpi[(size_t)k * kT];
    zs[e] = z;
  }
  __syncthreads();
  const int c = tid % kT;
  const int part = tid / kT;  // rows 16 part ... 16 part + 15 of each tile
  float acc = 0.f;
  for (int i = j; i < T; ++i)
    for (int r = 16 * part; r < 16 * part + 16; ++r)
      acc = fmaf(Y[(size_t)(i * kT + r) * NP + j * kT + c], zs[(i - j) * kT + r], acc);
  float* red = zs + m * kT;
  red[part * kT + c] = acc;
  __syncthreads();
  if (tid < kT) sc.al[(size_t)b * NP + j * kT + tid] = (red[tid] + red[kT + tid]) + (red[2 * kT + tid] + red[3 * kT + tid]);
}

// Lower tile (i, j) of K^-1 = sum_{k >= i} Y_ki^T Y_kj and its share of the
// gradient's two sums, sum (K^-1 - alpha alpha^T) dK/dtheta (twice for a tile
// below the diagonal: K^-1 and dK are symmetric): a block per (tile, row b).
__global__ void __launch_bounds__(kThreads, 2) mll_kinv_kernel(Args args, int T, float* scratch, int B) {
  extern __shared__ __align__(16) float buf[];  // kKinvSmem floats
  const Scratch sc(scratch, nullptr, B, T);
  const int u = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  int i = 0;
  while ((i + 1) * (i + 2) / 2 <= u) ++i;
  const int j = u - i * (i + 1) / 2;
  const int i0 = i * kT;
  const int j0 = j * kT;
  const int NP = T * kT;
  const float* Y = sc.Y + (size_t)b * NP * NP;
  float* At = buf;              // [kT][kLD4]: Y_ki, row-major (At[m][r] = Y_ki(m, r))
  float* Bs = buf + kT * kLD4;  // [kT][kLD4]: Y_kj
  float acc[4][4] = {};
  for (int k = i; k < T; ++k) {
    load_rows(Y, NP, k * kT, i0, At);
    if (i != j) load_rows(Y, NP, k * kT, j0, Bs);
    __syncthreads();
    tpubq_blk::tile64_fma(At, i != j ? Bs : At, kLD4, tx, ty, acc);
    __syncthreads();
  }
  const Row p = args.row(b);
  const float* al = sc.al + (size_t)b * NP;
  float xc[4], mc[4], ac[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int c = j0 + 4 * tx + t;
    xc[t] = p.xv(c);
    mc[t] = p.mv(c);
    ac[t] = al[c];
  }
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = i0 + 4 * ty + q;
    const float xr = p.xv(r);
    const float mr = p.mv(r);
    const float ar = al[r];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (r < args.n && j0 + 4 * tx + t < args.n)
        p.grad_terms(acc[q][t] - ar * ac[t], xr, xc[t], mr, mc[t], r == j0 + 4 * tx + t, s[0], s[1]);
  }
  block_sums(s, Bs + kT * kLD4);
  if (tid == 0) {
    const float wgt = i == j ? 1.f : 2.f;
    float* pt = sc.part + ((size_t)b * (T * (T + 1) / 2) + u) * 2;
    pt[0] = wgt * s[0];
    pt[1] = wgt * s[1];
  }
}

// Row b's MLL and gradient from the partial sums, alpha and L's diagonal.
__global__ void __launch_bounds__(kThreads) mll_finish_kernel(Args args, int T, float* scratch, int B,
                                                              float* __restrict__ mll, float* __restrict__ grad) {
  __shared__ float red[kSums * kThreads / 32];
  const Scratch sc(scratch, nullptr, B, T);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int NP = T * kT;
  const int U = T * (T + 1) / 2;
  const Row p = args.row(b);
  const float* pt = sc.part + (size_t)b * U * 2;
  float q[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int u = tid; u < U; u += kThreads) {
    q[0] += pt[2 * u];
    q[1] += pt[2 * u + 1];
  }
  for (int r = tid; r < args.n; r += kThreads) {
    const float m = p.mv(r);
    q[2] += p.yv(r) * sc.al[(size_t)b * NP + r];
    q[3] += m > 0.f ? logf(sc.dg[(size_t)b * NP + r]) : 0.f;
    q[4] += m;
  }
  block_sums(q, red);
  if (tid == 0) write_row(mll, grad, b, q);
}

template <int NP>
cudaError_t launch_small(const Args& args, int B, float* mll, float* grad, cudaStream_t stream) {
  const int smem = small_smem(NP) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(mll_small_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  mll_small_kernel<NP><<<B, kThreads, smem, stream>>>(args, mll, grad);
  return cudaGetLastError();
}

}  // namespace

// Floats and ints of the scratch of a tiled call on B rows of n points:
// allocate that many, the ints zeroed.
extern "C" void tpubq_mll_grad_scratch(int B, int n, long long* floats, long long* ints) {
  const Scratch sc(nullptr, nullptr, B, (n + kT - 1) / kT);
  *floats = static_cast<long long>(sc.floats);
  *ints = static_cast<long long>(sc.ints);
}

// Without a scratch (null): the one-block regime, one launch, n <= 64.
// With one: the tiles, four launches, any n; scratch holds `floats` floats
// (any contents) and sync `ints` ints, zeroed, at least what
// tpubq_mll_grad_scratch gives, both allocated by the caller. Shared data:
// rows_per_problem = B, data_stride = s_stride = 0. Per-problem data:
// data_stride = n, s_stride = 1 (0 for one shared noise).
extern "C" int tpubq_mll_grad(const float* thetas, const float* s, const float* x, const float* y,
                              const unsigned char* mask, float jitter, int B, int n, int rows_per_problem,
                              int data_stride, int s_stride, float* scratch, long long floats, int* sync,
                              long long ints, float* mll, float* grad, void* stream_ptr) {
  if (rows_per_problem < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Args args{thetas, s, x, y, mask, jitter, n, rows_per_problem, data_stride, s_stride};
  if (scratch == nullptr) {
    if (n <= 16) return static_cast<int>(launch_small<16>(args, B, mll, grad, stream));
    if (n <= 32) return static_cast<int>(launch_small<32>(args, B, mll, grad, stream));
    if (n <= 64) return static_cast<int>(launch_small<64>(args, B, mll, grad, stream));
    return static_cast<int>(cudaErrorInvalidValue);
  }

  const int T = (n + kT - 1) / kT;
  const int U = T * (T + 1) / 2;
  const Scratch need(nullptr, nullptr, B, T);
  if (sync == nullptr || floats < static_cast<long long>(need.floats) || ints < static_cast<long long>(need.ints))
    return static_cast<int>(cudaErrorInvalidValue);
  const int factor_smem = kFactorSmem * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(mll_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, factor_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  mll_factor_kernel<<<B * T * T, kThreads, factor_smem, stream>>>(args, B, T, scratch, sync);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int alpha_smem = (T + 4) * kT * static_cast<int>(sizeof(float));
  if (alpha_smem > 48 * 1024) {
    e = cudaFuncSetAttribute(mll_alpha_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, alpha_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mll_alpha_kernel<<<dim3(T, B), kThreads, alpha_smem, stream>>>(T, scratch, B);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int kinv_smem = kKinvSmem * static_cast<int>(sizeof(float));
  e = cudaFuncSetAttribute(mll_kinv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kinv_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  mll_kinv_kernel<<<dim3(U, B), kThreads, kinv_smem, stream>>>(args, T, scratch, B);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  mll_finish_kernel<<<B, kThreads, 0, stream>>>(args, T, scratch, B, mll, grad);
  return static_cast<int>(cudaGetLastError());
}
