// Gaussian (RBF) Gram matrix: theta = [h, w_1..w_d], x1 (n1, d), x2 (n2, d)
// -> K (n1, n2), K_ij = h^2 exp(-1/2 sum_k (x1_ik / w_k - x2_jk / w_k)^2),
// all float32 and row-major.
//
// Replaces the TPU kernel `gaussian_gram` (tpubq/ops/pallas_kernels.py,
// `_gram_kernel`), which builds the Gram one (128 x 128) VMEM tile per grid
// step from inputs pre-scaled by 1/w. Here each thread writes one entry:
// a block of 32 x 8 threads covers 32 columns of 8 rows, so a warp writes 32
// consecutive floats of a row. theta is read on the device (no host sync
// for h and w), and each coordinate is scaled by 1/w in the kernel in the
// order the plain version uses (x / w, then the difference, squared, summed
// over k in order), so the two differ only in expf against torch.exp.
//
// What bounds it: the bytes written, 4 n1 n2, at one expf and 3d + 3 other
// operations per entry; the inputs are (n1 + n2) d floats, read through L1.

#include <cuda_runtime.h>

namespace {

__global__ void gaussian_gram_kernel(const float* __restrict__ theta, const float* __restrict__ x1,
                                     const float* __restrict__ x2, int n1, int n2, int d,
                                     float* __restrict__ K) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n1 || j >= n2) return;
  const float h = theta[0];
  float r2 = 0.f;
  for (int k = 0; k < d; ++k) {
    const float w = theta[1 + k];
    const float diff = x1[(size_t)i * d + k] / w - x2[(size_t)j * d + k] / w;
    r2 += diff * diff;
  }
  K[(size_t)i * n2 + j] = (h * h) * expf(-0.5f * r2);
}

}  // namespace

extern "C" int tpubq_gaussian_gram(const float* theta, const float* x1, const float* x2, int n1,
                                   int n2, int d, float* K, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((n2 + 31) / 32, (n1 + 7) / 8);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  gaussian_gram_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(theta, x1, x2, n1,
                                                                              n2, d, K);
  return static_cast<int>(cudaGetLastError());
}
