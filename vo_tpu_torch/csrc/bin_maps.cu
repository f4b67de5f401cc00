// K2: pooled soft-bin orientation maps for the dense SIFT descriptor, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vo_tpu/frontend/pallas_kernels.py::bin_maps_pallas
// (_bin_maps_call, body _bin_maps_kernel). Plain PyTorch version:
// vo_tpu_torch/frontend/kernels.py::soft_bin_pool_plain (the reference's
// dense_desc._soft_bin_pool); wrapper: kernels.bin_maps.
//
// Per Gaussian level G[b] ([H, W]): central-difference gradients (gx = 0 at columns 0
// and W-1, gy = 0 at rows 0 and H-1), magnitude and atan2 angle, linear soft-binning
// of each pixel into its two adjacent bins of 8, then a 2x2 sum-pool that drops an
// odd last row/column: out[b, c, i, j] over pixels (2i+dy, 2j+dx).
//
// Bound: device memory. The plain version writes an [H, W, 8] one-hot intermediate
// (8x the level) to HBM and reads it back to pool; here one thread per pooled output
// keeps the 8 bin sums in registers, reads its 2x2 pixels and their 4-neighbours
// (served by L1), and writes 8 floats: about 1 read of the level + 2 writes of its
// size in all. The TPU kernel's minimax atan2 polynomial and 0/1 pooling matmuls were
// Mosaic workarounds; atan2f and a direct 2x2 sum take their place.
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 8;

__global__ void bin_maps_kernel(const float* __restrict__ G, float* __restrict__ out,
                                int H, int W, int H2, int W2) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= W2 || i >= H2) return;
  const float* g = G + (long long)blockIdx.z * H * W;
  float acc[kBins];
#pragma unroll
  for (int c = 0; c < kBins; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int y = 2 * i + dy;
      const int x = 2 * j + dx;
      const float* p = g + (long long)y * W + x;
      const float gx = (x >= 1 && x <= W - 2) ? 0.5f * (__ldg(p + 1) - __ldg(p - 1)) : 0.0f;
      const float gy = (y >= 1 && y <= H - 2) ? 0.5f * (__ldg(p + W) - __ldg(p - W)) : 0.0f;
      const float mag = sqrtf(gx * gx + gy * gy);
      const float ang = atan2f(gy, gx);  // [-pi, pi]
      const float bf = (ang / 6.283185307179586f + 0.5f) * kBins;  // [0, 8]
      const float b0 = floorf(bf);
      const float fb = bf - b0;
      const int b0i = static_cast<int>(b0) % kBins;  // b0 >= 0
      const int b1i = (b0i + 1) % kBins;
      const float w0 = (1.0f - fb) * mag;
      const float w1 = fb * mag;
#pragma unroll
      for (int c = 0; c < kBins; ++c) {
        acc[c] += (c == b0i ? w0 : 0.0f) + (c == b1i ? w1 : 0.0f);
      }
    }
  }
  const long long plane = (long long)H2 * W2;
  float* o = out + (long long)blockIdx.z * kBins * plane + (long long)i * W2 + j;
#pragma unroll
  for (int c = 0; c < kBins; ++c) o[c * plane] = acc[c];
}

}  // namespace

// G: [B, H, W] float32 contiguous; out: [B, 8, H/2, W/2] float32 contiguous.
extern "C" cudaError_t vo_bin_maps(const float* G, float* out, int B, int H, int W,
                                   cudaStream_t stream) {
  const int H2 = H / 2;
  const int W2 = W / 2;
  const dim3 block(32, 8);
  const dim3 grid((W2 + block.x - 1) / block.x, (H2 + block.y - 1) / block.y, B);
  bin_maps_kernel<<<grid, block, 0, stream>>>(G, out, H, W, H2, W2);
  return cudaGetLastError();
}
