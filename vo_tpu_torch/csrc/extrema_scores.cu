// K1: 3x3x3 DoG extremum scores for the SIFT detector, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vo_tpu/frontend/pallas_kernels.py::extrema_scores_pallas
// (body _extrema_kernel). Plain PyTorch version: vo_tpu_torch/frontend/kernels.py::
// extrema_scores_plain; wrapper: kernels.extrema_scores.
//
// out[b, l-1, y, x] = |dog[b, l, y, x]| where the pixel is >= the max or <= the min of
// its 27-cube over levels l-1..l+1, |dog| > half_thr, and it lies at least `border` px
// inside the image; -1 everywhere else. Inner levels l = 1..L-2 only, unpadded.
//
// Bound: device memory. Each output reads 27 floats and writes one; the 26 neighbours
// of a thread are the centres of its neighbours, so L1/L2 serve the reuse and each
// DoG value comes from HBM about once per level triple it belongs to (~3 reads + 1
// write per output). One thread per output, 32 threads along x, so a warp reads and
// writes 128 contiguous bytes per row. The comparisons are exact (max/min of floats),
// so the kernel equals the plain version bit for bit.
#include <cuda_runtime.h>

namespace {

__global__ void extrema_scores_kernel(const float* __restrict__ dog, float* __restrict__ out,
                                      int L, int H, int W, float half_thr, int border) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int inner = L - 2;
  const int b = blockIdx.z / inner;
  const int l = blockIdx.z % inner + 1;  // DoG level of the centre
  const long long plane = (long long)H * W;
  float* o = out + (long long)blockIdx.z * plane + (long long)y * W + x;
  if (y < border || y >= H - border || x < border || x >= W - border) {
    *o = -1.0f;
    return;
  }
  const float* c = dog + ((long long)b * L + l) * plane + (long long)y * W + x;
  const float v = __ldg(c);
  float mx = v;
  float mn = v;
#pragma unroll
  for (int dl = -1; dl <= 1; ++dl) {
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const float n = __ldg(c + dl * plane + dy * W + dx);
        mx = fmaxf(mx, n);
        mn = fminf(mn, n);
      }
    }
  }
  const float mag = fabsf(v);
  *o = ((v >= mx || v <= mn) && mag > half_thr) ? mag : -1.0f;
}

}  // namespace

// dog: [B, L, H, W] float32 contiguous; out: [B, L-2, H, W] float32 contiguous.
extern "C" cudaError_t vo_extrema_scores(const float* dog, float* out, int B, int L, int H, int W,
                                         float half_thr, int border, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, B * (L - 2));
  extrema_scores_kernel<<<grid, block, 0, stream>>>(dog, out, L, H, W, half_thr, border);
  return cudaGetLastError();
}
