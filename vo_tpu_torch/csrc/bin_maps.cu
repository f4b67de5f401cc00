// K2: pooled soft-bin orientation maps for the dense SIFT descriptor, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vo_tpu/frontend/pallas_kernels.py::bin_maps_pallas
// (_bin_maps_call, body _bin_maps_kernel). Plain PyTorch version:
// vo_tpu_torch/frontend/kernels.py::soft_bin_pool_plain (the reference's
// dense_desc._soft_bin_pool); wrappers: kernels.bin_maps_octaves (all octaves of a
// detection call in one launch) and kernels.bin_maps (one octave, same kernel).
//
// Per Gaussian level G ([H, W]): central-difference gradients (gx = 0 at columns 0
// and W-1, gy = 0 at rows 0 and H-1), magnitude and angle, linear soft-binning of
// each pixel into its two adjacent bins of 8, then a 2x2 sum-pool that drops an odd
// last row/column: out[c, i, j] over pixels (2i+dy, 2j+dx).
//
// Bound: device memory by the card's table (12 bytes moved per pixel against some
// 40 float operations), but the margin is thin: written pixel by pixel, the angle, the
// square root and the binning are of the order of 100 instructions, and the card gets
// through a pixel's instructions about as fast as it moves that pixel's 12 bytes. So the
// design cuts both:
//  - One launch covers every octave (blockIdx.x runs over the tiles of all octaves,
//    per-octave pointers, strides and sizes in a __grid_constant__ struct), and the
//    kernel reads the levels where they lie: any batch, level and row stride, unit
//    stride along x, so the caller's slice G[:, 1:s+1] is not copied first.
//  - A block brings the 34 x 130 pixels under its 16 x 64 pooled outputs to shared
//    memory once, by coalesced 4-byte cp.async (row strides of 1241, 621, 311 and 156
//    floats rule out 16-byte copies and TMA), even and odd columns apart, so that the
//    stride-2 reads of a warp fall on 32 different banks. Smaller tiles measured slower.
//  - A thread owns one pooled column and walks down 8 pixel rows with a sliding window,
//    so a pixel costs 2 shared-memory reads instead of 4 global ones.
//  - The bin coordinate comes directly from an octant reduction and an odd polynomial
//    of degree 15 in min/max (|error| < 5e-8 bins, below float32 rounding of the
//    coordinate itself), with one approximate division and one approximate square
//    root, in place of atan2f, two true divisions and sqrtf: that arithmetic alone
//    measured 0.071 against 0.045 ms for the detection call. The TPU kernel used such a
//    polynomial because Mosaic has no atan2; here atan2f exists and the reason is its
//    cost in instructions. Soft binning is continuous in the angle, so the result
//    stays within 1e-5 of the plain version (2e-7 measured on the main path's
//    pyramids). The intrinsics are chosen one by one; the file is built without
//    -use_fast_math.
//  - The two bin weights go to their accumulators under one predicate per bin
//    (8 compares and 16 predicated adds) instead of two 8-way selects.
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 8;
constexpr int kMaxOctaves = 8;
constexpr int kPoolH = 16;  // pooled outputs per tile
constexpr int kPoolW = 64;
constexpr int kPoolRows = 4;  // pooled rows per thread
constexpr int kThreads = kPoolW * (kPoolH / kPoolRows);
constexpr int kPixRows = 2 * kPoolRows;
constexpr int kSmemH = 2 * kPoolH + 2;
constexpr int kSmemW = 2 * kPoolW + 2;
// A tile row in shared memory: the even tile columns, then (from kOdd on) the odd ones.
// kOdd = 16 (mod 32) puts the two halves of a warp's 32 consecutive columns on different banks.
constexpr int kOdd = 80;
constexpr int kStride = kOdd + kSmemW / 2 + 1;
constexpr int kLoads = (kSmemH * kSmemW + kThreads - 1) / kThreads;

struct Octaves {
  const float* in[kMaxOctaves];  // first level of image 0
  float* out[kMaxOctaves];       // [B, n_levels, 8, H/2, W/2] contiguous
  long long stride_b[kMaxOctaves];  // in elements
  long long stride_l[kMaxOctaves];
  long long stride_y[kMaxOctaves];
  int H[kMaxOctaves];
  int W[kMaxOctaves];
  int tiles_x[kMaxOctaves];
  int tile_end[kMaxOctaves];  // running total of tiles up to and including this octave
  int n;
};

// atan(q) * 4/pi = q * P(q^2) on [0, 1]: minimax fit, |error| < 5e-8.
constexpr float kC0 = 1.2732386988f;
constexpr float kC1 = -0.4243689678f;
constexpr float kC2 = 0.2539675619f;
constexpr float kC3 = -0.1770901714f;
constexpr float kC4 = 0.1227682671f;
constexpr float kC5 = -0.0711897808f;
constexpr float kC6 = 0.0278367785f;
constexpr float kC7 = -0.005162434f;

__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// One pixel's gradient into the 8 bin sums: weight mag * (1 - fb) to bin floor(t) and
// mag * fb to the next, t = (atan2(gy, gx) / 2pi + 1/2) * 8 in [0, 8].
__device__ __forceinline__ void add_pixel(float gx, float gy, float (&acc)[kBins]) {
  const float mag = sqrt_approx(gx * gx + gy * gy);
  const float ax = fabsf(gx);
  const float ay = fabsf(gy);
  const float q = __fdividef(fminf(ax, ay), fmaxf(fmaxf(ax, ay), 1e-30f));  // [0, 1]; 0 at the origin
  const float s = q * q;
  float p = fmaf(kC7, s, kC6);
  p = fmaf(p, s, kC5);
  p = fmaf(p, s, kC4);
  p = fmaf(p, s, kC3);
  p = fmaf(p, s, kC2);
  p = fmaf(p, s, kC1);
  p = fmaf(p, s, kC0);
  float r = q * p;  // the angle in octants, [0, 1]
  r = ay > ax ? 2.0f - r : r;
  r = gx < 0.0f ? 4.0f - r : r;
  r = gy < 0.0f ? -r : r;
  const float t = r + 4.0f;
  const float b0 = floorf(t);
  const float fb = t - b0;
  const int bin = static_cast<int>(b0) & (kBins - 1);
  const float w0 = (1.0f - fb) * mag;
  const float w1 = fb * mag;
#pragma unroll
  for (int c = 0; c < kBins; ++c) {
    if (bin == c) {
      acc[c] += w0;
      acc[(c + 1) % kBins] += w1;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bin_maps_kernel(const __grid_constant__ Octaves p, int n_levels) {
  __shared__ float tile[kSmemH * kStride];

  int o = 0;
  while (o + 1 < p.n && static_cast<int>(blockIdx.x) >= p.tile_end[o]) ++o;
  const int tile_id = blockIdx.x - (o == 0 ? 0 : p.tile_end[o - 1]);
  const int H = p.H[o];
  const int W = p.W[o];
  const int H2 = H / 2;
  const int W2 = W / 2;
  const int j0 = (tile_id % p.tiles_x[o]) * kPoolW;  // first pooled column and row of the tile
  const int i0 = (tile_id / p.tiles_x[o]) * kPoolH;
  const int b = blockIdx.y / n_levels;
  const int l = blockIdx.y % n_levels;
  const float* in = p.in[o] + b * p.stride_b[o] + l * p.stride_l[o];
  const long long stride_y = p.stride_y[o];

  // Tile element (r, u) is pixel (2*i0 - 1 + r, 2*j0 - 1 + u); outside the image it is 0
  // (only gradients that the border rule sets to 0 read it).
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int r = i / kSmemW;
    const int u = i - r * kSmemW;
    const int y = 2 * i0 - 1 + r;
    const int x = 2 * j0 - 1 + u;
    if (r < kSmemH) {
      float* dst = tile + r * kStride + (u & 1) * kOdd + (u >> 1);
      if (y >= 0 && y < H && x >= 0 && x < W) {
        __pipeline_memcpy_async(dst, in + y * stride_y + x, sizeof(float));
      } else {
        *dst = 0.0f;
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int j = threadIdx.x % kPoolW;
  const int jg = j0 + j;                                   // pooled column
  const int ig = i0 + (threadIdx.x / kPoolW) * kPoolRows;  // first pooled row
  if (jg >= W2 || ig >= H2) return;
  // Pixel columns 2*jg (tile column 2j+1, odd) and 2*jg+1 (tile column 2j+2, even).
  const bool gx_a = jg >= 1;  // 2*jg <= W-2 holds for every pooled column
  const bool gx_b = 2 * jg + 1 <= W - 2;
  const float* even = tile + (threadIdx.x / kPoolW) * kPixRows * kStride + j;
  const float* odd = even + kOdd;
  const long long plane = static_cast<long long>(H2) * W2;
  float* out = p.out[o] + static_cast<long long>(blockIdx.y) * kBins * plane + jg;

  float acc[kBins];
  float a_pp = 0.0f, b_pp = 0.0f, a_p = 0.0f, b_p = 0.0f, gxa_p = 0.0f, gxb_p = 0.0f;
#pragma unroll
  for (int r = 0; r < kPixRows + 2; ++r) {
    // Tile row r of this thread is pixel row 2*ig - 1 + r.
    const float e0 = even[r * kStride];
    const float o0 = odd[r * kStride];
    const float e1 = even[r * kStride + 1];
    const float o1 = odd[r * kStride + 1];
    if (r >= 2) {
      // Pixel row y = 2*ig + r - 2 has its rows above (two loads back) and below (this load).
      const int y = 2 * ig + r - 2;
      const bool gy_ok = y >= 1 && y <= H - 2;
      if (r % 2 == 0) {
#pragma unroll
        for (int c = 0; c < kBins; ++c) acc[c] = 0.0f;
      }
      add_pixel(gxa_p, gy_ok ? 0.5f * (o0 - a_pp) : 0.0f, acc);
      add_pixel(gxb_p, gy_ok ? 0.5f * (e1 - b_pp) : 0.0f, acc);
      if (r % 2 == 1) {
        const int i = ig + (r - 3) / 2;
        float* o_row = out + static_cast<long long>(i) * W2;
#pragma unroll
        for (int c = 0; c < kBins; ++c) o_row[c * plane] = acc[c];
        if (i + 1 >= H2) return;
      }
    }
    a_pp = a_p;
    b_pp = b_p;
    a_p = o0;
    b_p = e1;
    gxa_p = gx_a ? 0.5f * (e1 - e0) : 0.0f;
    gxb_p = gx_b ? 0.5f * (o1 - o0) : 0.0f;
  }
}

}  // namespace

// in[o]: the first of n_levels levels of image 0, float32, unit stride along x and the
// given element strides between images, levels and rows; out[o]: [B, n_levels, 8,
// H[o]/2, W[o]/2] float32 contiguous. One launch on `stream`; nothing is allocated.
extern "C" cudaError_t vo_bin_maps(const void* const* in, void* const* out, const long long* stride_b,
                                   const long long* stride_l, const long long* stride_y, const int* H,
                                   const int* W, int n_octaves, int B, int n_levels,
                                   cudaStream_t stream) {
  if (n_octaves < 1 || n_octaves > kMaxOctaves || B < 1 || n_levels < 1) return cudaErrorInvalidValue;
  Octaves p;
  int total = 0;
  for (int o = 0; o < n_octaves; ++o) {
    if (H[o] < 2 || W[o] < 2) return cudaErrorInvalidValue;
    p.in[o] = static_cast<const float*>(in[o]);
    p.out[o] = static_cast<float*>(out[o]);
    p.stride_b[o] = stride_b[o];
    p.stride_l[o] = stride_l[o];
    p.stride_y[o] = stride_y[o];
    p.H[o] = H[o];
    p.W[o] = W[o];
    p.tiles_x[o] = (W[o] / 2 + kPoolW - 1) / kPoolW;
    total += p.tiles_x[o] * ((H[o] / 2 + kPoolH - 1) / kPoolH);
    p.tile_end[o] = total;
  }
  p.n = n_octaves;
  bin_maps_kernel<<<dim3(total, B * n_levels), kThreads, 0, stream>>>(p, n_levels);
  return cudaGetLastError();
}
