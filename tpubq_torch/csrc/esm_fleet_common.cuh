// The block layout and the tiled quadratic forms shared by the two fleet scorer
// kernels (esm_fleet_l.cu, esm_fleet_tl.cu).
//
// A block takes one problem b and kTPB = 4 tiles of kPT = 128 grid points in
// turn: the grid is (ceil(G / 512), B). For each point it forms
//   s1 = k^T K^-1 k and ka = alpha^T k, and for the linear GP (LIN) also
//   bound = k^T |K^-1| k, zv = uz^T k and the `near` flag,
// with k_p[j] = h^2 exp(-sum_c (x_j - x_p)_c^2 w2inv_c) m_j. Once per block the
// problem's rows go into shared memory as one record each (x, m, alpha, uz),
// and, when K^-1 fits one staged chunk (NP <= 64), K^-1 too. Then per tile:
//  1. the k pass: warp w forms k_p[j] with expf for rows j = w, w + warps, ...,
//     each lane for four points, so one broadcast record feeds four chains;
//     it stores k in the k tile kT[j][p] (points contiguous, so a thread's
//     points are float4s) and sums its rows' share of ka, zv and near;
//  2. the quadratic forms as a tiled product V[p][i] = (K^-1 k_p)_i (and, with
//     LIN, W[p][i] = (|K^-1| k_p)_i) over column tiles of V, CT = 16 ... 64 of
//     the rows i of K^-1 (NP split evenly over ceil(NP / 64) tiles and rounded up to 16: one tile
//     of 48 at NP 44, of 32 at NP 32), each thread an 8 points x 4 columns
//     register tile fed per row j by two float4s of kT and one of K^-1: three
//     shared-memory loads per 32 (LIN: 64) float32 FMAs. V is formed from
//     K^-1's rows, (K^-1 k)_i as the plain version forms it, so the two round
//     alike: K^-1 is staged transposed in chunks of 64 columns by cp.async,
//     double-buffered when there are several, read from the (B, NP, NP)
//     inverse as it lies with 4-byte copies (rows of NP floats are 16-byte
//     aligned only when NP % 4 == 0); rows past NP are zeros;
//  3. the epilogue of each column tile weights V by the points' own k at the
//     tile's columns and keeps a running partial per thread and point;
//  4. the partials go through shared memory (the CT / 4 column threads of a
//     point need not share a warp: 12 of them at NP 44) and forms() sums them,
//     and the k pass's over its warps, in a fixed order.
// Every sum has a fixed order and there are no atomics: two calls give the
// same bits. The cancellation in kappa - s1 stays float32 FMA (no TF32, no
// tensor cores: TF32 keeps about 10 bits). A 3xTF32 split on the tensor cores
// is what would lift the bound; it is not taken here.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace tpubq_fleet {

constexpr int kPT = 128;       // grid points per block
constexpr int kLDK = kPT + 4;  // row stride of kT: 16-byte rows, successive rows 4 banks apart
constexpr int kJC = 64;        // rows of K^-1 per staged chunk
constexpr int kMaxCT = 64;     // widest column tile
constexpr int kQP = 8;         // points of a thread's register tile (x 4 columns)
constexpr int kTPB = 4;        // point tiles a block takes in turn

__host__ __device__ constexpr int threads_of(int CT) { return (kPT / kQP) * (CT / 4); }
__host__ __device__ constexpr int col_tiles(int NP) { return (NP + kMaxCT - 1) / kMaxCT; }
__host__ __device__ constexpr int col_width(int NP) {
  return ((NP + col_tiles(NP) - 1) / col_tiles(NP) + 15) / 16 * 16;
}
__host__ __device__ constexpr int row_chunks(int NP) { return (NP + kJC - 1) / kJC; }
// Blocks an SM must hold at once: 512 threads' worth, so at most 128 registers a thread.
__host__ __device__ constexpr int min_blocks(int CT) { return threads_of(CT) >= 512 ? 1 : 512 / threads_of(CT); }
// Floats of a row's record in shared memory: x[D], m, alpha, uz, padded to float4s.
__host__ __device__ constexpr int record(int D) { return (D + 3 + 3) / 4 * 4; }
// Slices of a point's rows in the k pass: one per warp.
__host__ __device__ constexpr int kpass_rows(int CT) { return threads_of(CT) / 32; }

// Shared memory of a block, in floats (NP >= 1; the same layout for both kernels):
//   rec [NP][record(D)]           the problem's rows: x, m, alpha and uz
//   kT  [NP][kLDK]                k_p[j] of the block's points
//   Kb  [1 or 2][min(NP, kJC)][CT] staged chunks of K^-1's column tile (two when there are several)
//   red [2][CT / 4][kPT]          each column thread's partial s1 and bound per point
//   kp  [3][kpass_rows][kPT]      the k pass's partial ka, zv and near per point and warp
__host__ __device__ constexpr long smem_floats(int NP, int D) {
  return (long)NP * (record(D) + kLDK) + (col_tiles(NP) * row_chunks(NP) > 1 ? 2L : 1L) * (NP < kJC ? NP : kJC) * col_width(NP) +
         2L * (col_width(NP) / 4) * kPT + 3L * kpass_rows(col_width(NP)) * kPT;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// What phase 4 gives one point.
struct Forms {
  float s1, bound, zv, ka;
  bool near;
};

// One problem's block: its rows and (when it takes one step) K^-1's column tile
// staged once, then kTPB tiles of kPT grid points in turn. x (NP, D), m, uz,
// alpha and K (NP, NP) are passed at the problem's offset.
template <int D, int CT, bool LIN>
struct FleetBlock {
  static constexpr int T = threads_of(CT);
  static constexpr int TX = CT / 4;         // column threads of a point group
  static constexpr int R = kpass_rows(CT);  // k-pass slices of a point's rows: the warps
  static constexpr int H = kQP / 4;         // float4s of a thread's points
  static_assert(T % 32 == 0 && CT % 8 == 0, "a warp stages 8 rows x 4 columns");
  const float* __restrict__ K;
  int NP, nch, steps, jrows;
  float *rec, *kT, *Kb, *red, *kp;

  __device__ FleetBlock(float* smem, const float* K_, int NP_) : K(K_), NP(NP_) {
    nch = row_chunks(NP);
    steps = col_tiles(NP) * nch;
    jrows = NP < kJC ? NP : kJC;
    rec = smem;
    kT = rec + NP * record(D);
    Kb = kT + NP * kLDK;
    red = Kb + (steps > 1 ? 2 : 1) * jrows * CT;
    kp = red + 2 * TX * kPT;
  }

  // Step s: rows [c0, c0 + CT) of K^-1, c0 = CT (s / nch), and its columns
  // [j0, j0 + 64), j0 = 64 (s % nch), into buffer s & 1 transposed: Kb[jj][c] =
  // K^-1[c0 + c][j0 + jj], so the product forms (K^-1 k)_i from K^-1's rows,
  // as the plain version (K^-1 @ k) does: the fleet's inverses come from two
  // triangular solves and are symmetric only to rounding. A warp copies 8 rows
  // x 4 consecutive columns, 16-byte runs of K^-1's rows, by 4-byte copies
  // (rows of NP floats are 16-byte aligned only when NP % 4 == 0); rows past
  // NP are zeros.
  __device__ void stage(int s) {
    const int c0 = (s / nch) * CT;
    const int j0 = (s % nch) * kJC;
    const int rows = min(kJC, NP - j0);
    float* dst = Kb + (s & 1) * jrows * CT;
    for (int e = threadIdx.x; e < ((rows + 3) & ~3) * CT; e += T) {
      const int c = (e / 32) % (CT / 8) * 8 + e % 8;
      const int jj = e / (4 * CT) * 4 + (e / 8) % 4;
      if (jj < rows) {
        const bool live = c0 + c < NP;
        cp_async4(dst + jj * CT + c, live ? K + (size_t)(c0 + c) * NP + j0 + jj : K, live ? 4 : 0);
      }
    }
    cp_async_commit();
  }

  // Once per block: the rows' records and, when K^-1 takes one step, its tile.
  __device__ void prologue(const float* __restrict__ x, const float* __restrict__ m,
                           const float* __restrict__ uz, const float* __restrict__ alpha) {
    if (steps == 1) stage(0);
    for (int j = threadIdx.x; j < NP; j += T) {
      float* rj = rec + j * record(D);
#pragma unroll
      for (int c = 0; c < D; ++c) rj[c] = __ldg(x + (size_t)j * D + c);
      rj[D] = __ldg(m + j);
      rj[D + 1] = __ldg(alpha + j);
      rj[D + 2] = LIN ? __ldg(uz + j) : 0.f;
    }
    __syncthreads();
  }

  // Phases 1-3 for the points g = t * kPT + p of tile t; ends in a barrier,
  // after which forms(p) reads any of them. Points past G are formed from
  // x_p = 0 and never written by the caller.
  __device__ void tile(int t, const float* __restrict__ grid, int G, float h2, const float* __restrict__ w2inv,
                       float thresh) {
    const int tid = threadIdx.x;
    if (steps > 1) stage(0);

    // 1. the k pass: warp w takes rows j = w, w + R, ... of every point, lane l
    // the points l + 32 i, so one broadcast record feeds four independent expf chains
    {
      const int lane = tid & 31;
      const int wp = tid >> 5;
      float xa[4][D], w[D];
#pragma unroll
      for (int c = 0; c < D; ++c) w[c] = __ldg(w2inv + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int g = t * kPT + lane + 32 * i;
#pragma unroll
        for (int c = 0; c < D; ++c) xa[i][c] = g < G ? __ldg(grid + (size_t)g * D + c) : 0.f;
      }
      const float near_r2 = thresh * thresh * w[0];  // in 1-D, |x_j - x_p| < thresh <=> r^2 < thresh^2 w2inv
      float ka[4] = {0.f, 0.f, 0.f, 0.f}, zv[4] = {0.f, 0.f, 0.f, 0.f};
      bool near[4] = {false, false, false, false};
      for (int j = wp; j < NP; j += R) {
        float rj[record(D)];
#pragma unroll
        for (int h = 0; h < record(D); h += 4) {
          const float4 v = *reinterpret_cast<const float4*>(rec + j * record(D) + h);
          rj[h] = v.x, rj[h + 1] = v.y, rj[h + 2] = v.z, rj[h + 3] = v.w;
        }
        const float mj = rj[D];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float r2 = 0.f, dmax = 0.f;
#pragma unroll
          for (int c = 0; c < D; ++c) {
            const float dj = rj[c] - xa[i][c];
            r2 += dj * dj * w[c];
            dmax = fmaxf(dmax, fabsf(dj));
          }
          const float k = h2 * expf(-r2) * mj;
          kT[j * kLDK + lane + 32 * i] = k;
          ka[i] += rj[D + 1] * k;
          if (LIN) {
            zv[i] += rj[D + 2] * k;
            near[i] = near[i] || (mj > 0.f && (D == 1 ? r2 < near_r2 : dmax < thresh));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = lane + 32 * i;
        kp[wp * kPT + p] = ka[i];
        if (LIN) {
          kp[(R + wp) * kPT + p] = zv[i];
          kp[(2 * R + wp) * kPT + p] = near[i] ? 1.f : 0.f;
        }
      }
    }

    // 2-3. the tiled product and each column tile's epilogue: thread (tx, ty)
    // holds points kQP ty + q and columns 4 tx + c of the tile
    const int tx = tid % TX;
    const int ty = tid / TX;
    float acc[kQP][4], accb[kQP][4], s1p[kQP], bp[kQP];
#pragma unroll
    for (int q = 0; q < kQP; ++q) {
      s1p[q] = bp[q] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[q][c] = accb[q][c] = 0.f;
    }
    for (int s = 0; s < steps; ++s) {
      if (s + 1 < steps) {
        stage(s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // chunk s (and, at s = 0, the k tile) visible to every thread
      const int ch = s % nch;
      const int j0 = ch * kJC;
      const int nj = min(kJC, NP - j0);
      const float* ar = kT + j0 * kLDK + kQP * ty;
      const float* br = Kb + (s & 1) * jrows * CT + 4 * tx;
#pragma unroll 2
      for (int jj = 0; jj < nj; ++jj) {
        float av[kQP];
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float4 a = *reinterpret_cast<const float4*>(ar + jj * kLDK + 4 * h);
          av[4 * h] = a.x, av[4 * h + 1] = a.y, av[4 * h + 2] = a.z, av[4 * h + 3] = a.w;
        }
        const float4 b = *reinterpret_cast<const float4*>(br + jj * CT);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int q = 0; q < kQP; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[q][c] = fmaf(av[q], bv[c], acc[q][c]);
        if (LIN) {
#pragma unroll
          for (int q = 0; q < kQP; ++q)
#pragma unroll
            for (int c = 0; c < 4; ++c) accb[q][c] = fmaf(av[q], fabsf(bv[c]), accb[q][c]);
        }
      }
      if (ch == nch - 1) {  // the tile's last chunk: weight V by the points' k at the tile's columns
        const int c0 = (s / nch) * CT + 4 * tx;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c0 + c < NP) {
#pragma unroll
            for (int h = 0; h < H; ++h) {
              const float4 k4 = *reinterpret_cast<const float4*>(kT + (c0 + c) * kLDK + kQP * ty + 4 * h);
              const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                s1p[4 * h + q] = fmaf(acc[4 * h + q][c], kv[q], s1p[4 * h + q]);
                if (LIN) bp[4 * h + q] = fmaf(accb[4 * h + q][c], kv[q], bp[4 * h + q]);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < kQP; ++q) acc[q][c] = accb[q][c] = 0.f;
        }
      }
      if (s + 1 < steps) __syncthreads();  // buffer s & 1 is refilled by stage(s + 2)
    }

    // 4. the partials, for forms()
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int q = 4 * h;
      *reinterpret_cast<float4*>(red + tx * kPT + kQP * ty + q) = make_float4(s1p[q], s1p[q + 1], s1p[q + 2], s1p[q + 3]);
      if (LIN)
        *reinterpret_cast<float4*>(red + (TX + tx) * kPT + kQP * ty + q) =
            make_float4(bp[q], bp[q + 1], bp[q + 2], bp[q + 3]);
    }
    __syncthreads();
  }

  // Point p's forms after tile(): its partials summed over the column threads
  // and the k pass's warps in a fixed order.
  __device__ Forms forms(int p) const {
    Forms f{0.f, 0.f, 0.f, 0.f, false};
#pragma unroll
    for (int t = 0; t < TX; ++t) {
      f.s1 += red[t * kPT + p];
      if (LIN) f.bound += red[(TX + t) * kPT + p];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      f.ka += kp[r * kPT + p];
      if (LIN) {
        f.zv += kp[(R + r) * kPT + p];
        f.near = f.near || kp[(2 * R + r) * kPT + p] != 0.f;
      }
    }
    return f;
  }
};

// Launches kern<D, CT> (chosen by the caller's `pick`) after checking that `threads` and `smem_bytes` are this source's
// layout for NP rows: a mismatch is refused with cudaErrorInvalidValue.
template <class Pick>
int launch_fleet(int d, int NP, int G, int B, int threads, int smem_bytes, Pick&& pick) {
  if (NP < 1 || G < 0 || B < 0 || B > 65535 || threads != threads_of(col_width(NP)) ||
      (long)smem_bytes < 4 * smem_floats(NP, d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0 || B == 0) return 0;
  auto by_width = [&](auto dc) -> int {
    switch (col_width(NP)) {
      case 16: return pick(dc, std::integral_constant<int, 16>{});
      case 32: return pick(dc, std::integral_constant<int, 32>{});
      case 48: return pick(dc, std::integral_constant<int, 48>{});
      case 64: return pick(dc, std::integral_constant<int, 64>{});
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  switch (d) {
    case 1: return by_width(std::integral_constant<int, 1>{});
    case 2: return by_width(std::integral_constant<int, 2>{});
    case 3: return by_width(std::integral_constant<int, 3>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One launch of `kernel` with this layout's grid (ceil(G / (kTPB kPT)), B),
// block and shared memory.
template <class Kernel, class... Args>
int launch_grid(Kernel kernel, int G, int B, int threads, int smem_bytes, cudaStream_t stream, Args... args) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(((G + kPT - 1) / kPT + kTPB - 1) / kTPB, B), threads, smem_bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpubq_fleet
