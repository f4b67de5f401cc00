// K1: 3x3x3 DoG extremum scores for the SIFT detector, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vo_tpu/frontend/pallas_kernels.py::extrema_scores_pallas
// (body _extrema_kernel). Plain PyTorch version: vo_tpu_torch/frontend/kernels.py::
// extrema_scores_plain; wrappers: kernels.extrema_scores_octaves (all octaves of a
// detection call in one launch) and kernels.extrema_scores (one octave, same kernel).
//
// out[b, l-1, y, x] = |dog[b, l, y, x]| where the pixel is >= the max or <= the min of
// its 27-cube over levels l-1..l+1, |dog| > half_thr, and it lies at least `border` px
// inside the image; -1 everywhere else. Inner levels l = 1..L-2 only, unpadded.
//
// Bound: device memory (8 bytes moved per DoG value against some 60 compares). The
// design moves each byte once and keeps the launch count at one:
//  - One launch covers every octave: blockIdx.x runs over the tiles of all octaves
//    (largest octave first), the per-octave pointers and sizes travel by value in a
//    __grid_constant__ struct, and a block finds its octave by a short search.
//  - A block owns one 4 x 128 tile of one image and loops over the L levels itself,
//    so a DoG value is fetched from device memory once, not once per level triple
//    (the halo rows of a neighbouring tile come from L2). The tile is small on purpose:
//    128 threads and 6 KB of shared memory let many blocks share an SM, each at
//    another point of its level loop, and that measured faster than taller or wider
//    tiles (16 x 128, 8 x 128, 4 x 256, 8 x 64) in spite of their smaller halo.
//  - Per level the tile and a 1 px halo go to shared memory, the next levels arriving by
//    cp.async (a ring of kStages stages) while the current one is reduced; two stages
//    measured best, a deeper ring slower. Row strides of the pyramid (1241, 621, 311,
//    156 floats) are not multiples of 16 bytes, so neither TMA tensor maps,
//    cp.async.bulk nor 16-byte vector loads apply: the copies are 4-byte cp.async,
//    coalesced along x.
//  - The 3x3 max and min of a level are separable (3 along x, then 3 along y); a thread
//    walks the 4 rows of one column with a sliding window and keeps the 3x3 extrema of the
//    last three levels in registers. Max and min are exact and associative, so the
//    result equals the plain version bit for bit.
//  - Halo elements outside the image are filled with NaN, which fmaxf/fminf ignore:
//    nothing is read out of the level, and the cube is clipped at the image edge as
//    the plain version's padded pooling clips it.
//  - A tile with no pixel inside the border writes -1 and loads nothing.
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOctaves = 8;
constexpr int kTileH = 4;
constexpr int kTileW = 128;
constexpr int kRows = 4;  // output rows per thread
constexpr int kThreads = kTileW * (kTileH / kRows);
constexpr int kSmemH = kTileH + 2;
constexpr int kSmemW = kTileW + 2;  // rows are dense: a flat tile index is the shared-memory offset
constexpr int kStage = kSmemH * kSmemW;
constexpr int kStages = 2;  // levels in shared memory: one being reduced, the others on their way
constexpr int kLoads = (kStage + kThreads - 1) / kThreads;  // tile elements per thread and level

struct Octaves {
  const float* dog[kMaxOctaves];  // [B, L, H, W] contiguous
  float* out[kMaxOctaves];        // [B, L-2, H, W] contiguous
  int H[kMaxOctaves];
  int W[kMaxOctaves];
  int tiles_x[kMaxOctaves];
  int tile_end[kMaxOctaves];  // running total of tiles up to and including this octave
  int n;
};

__global__ void __launch_bounds__(kThreads)
extrema_scores_kernel(const __grid_constant__ Octaves p, int L, float half_thr, int border) {
  __shared__ float tile[kStages][kStage];

  int o = 0;
  while (o + 1 < p.n && static_cast<int>(blockIdx.x) >= p.tile_end[o]) ++o;
  const int tile_id = blockIdx.x - (o == 0 ? 0 : p.tile_end[o - 1]);
  const int H = p.H[o];
  const int W = p.W[o];
  const int x0 = (tile_id % p.tiles_x[o]) * kTileW;
  const int y0 = (tile_id / p.tiles_x[o]) * kTileH;
  const long long plane = static_cast<long long>(H) * W;
  const float* in = p.dog[o] + static_cast<long long>(blockIdx.y) * L * plane;
  float* out = p.out[o] + static_cast<long long>(blockIdx.y) * (L - 2) * plane;

  const int c = threadIdx.x % kTileW;
  const int g = threadIdx.x / kTileW;
  const int x = x0 + c;
  const int yb = y0 + g * kRows;
  const bool col_inside = x >= border && x < W - border;

  // The whole tile lies in the border (block-uniform): no candidate, nothing to load.
  if (!(y0 + kTileH > border && y0 < H - border && x0 + kTileW > border && x0 < W - border)) {
    if (x < W) {
      for (int l = 0; l < L - 2; ++l) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (yb + j < H) out[l * plane + static_cast<long long>(yb + j) * W + x] = -1.0f;
        }
      }
    }
    return;
  }

  // Where each of this thread's tile elements lies in a level: offset in the plane,
  // -1 for a halo element outside the image, -2 past the end of the tile.
  int src[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int r = i / kSmemW;
    const int gy = y0 - 1 + r;
    const int gx = x0 - 1 + (i - r * kSmemW);
    src[k] = i >= kStage ? -2 : (gy >= 0 && gy < H && gx >= 0 && gx < W) ? gy * W + gx : -1;
  }
  const float nan = __int_as_float(0x7fc00000);

  // Starts the copy of level l into its stage; one commit per call, also past the last level,
  // so that "all but the newest kStages-1 groups" always means "level l has landed".
  auto load_level = [&](int l) {
    if (l < L) {
      const float* level = in + l * plane;
      float* dst = tile[l % kStages] + threadIdx.x;
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        if (src[k] >= 0) {
          __pipeline_memcpy_async(dst + k * kThreads, level + src[k], sizeof(float));
        } else if (src[k] == -1) {
          dst[k * kThreads] = nan;
        }
      }
    }
    __pipeline_commit();
  };

  // 3x3 extrema of the two levels before the current one, and the values of the one before.
  float max_pp[kRows], min_pp[kRows], max_p[kRows], min_p[kRows], val_p[kRows];
  for (int l = 0; l < kStages - 1; ++l) load_level(l);
  for (int l = 0; l < L; ++l) {
    load_level(l + kStages - 1);  // into the stage that iteration l-1 read
    __pipeline_wait_prior(kStages - 1);
    __syncthreads();

    // Rows yb-1 .. yb+kRows of columns x-1 .. x+1: 3-wide along x, then 3-wide along y.
    const float* s = tile[l % kStages] + (g * kRows) * kSmemW + c;
    float max_c[kRows], min_c[kRows], val_c[kRows];
    float hmax[3], hmin[3], mid = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows + 2; ++r) {
      const float a = s[r * kSmemW];
      const float v = s[r * kSmemW + 1];
      const float d = s[r * kSmemW + 2];
      hmax[r % 3] = fmaxf(fmaxf(a, v), d);
      hmin[r % 3] = fminf(fminf(a, v), d);
      if (r >= 2) {
        max_c[r - 2] = fmaxf(fmaxf(hmax[0], hmax[1]), hmax[2]);
        min_c[r - 2] = fminf(fminf(hmin[0], hmin[1]), hmin[2]);
        val_c[r - 2] = mid;
      }
      mid = v;
    }

    if (l >= 2 && x < W) {
      float* o_level = out + (l - 2) * plane + x;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int y = yb + j;
        if (y < H) {
          const float v = val_p[j];
          const float mx = fmaxf(fmaxf(max_pp[j], max_p[j]), max_c[j]);
          const float mn = fminf(fminf(min_pp[j], min_p[j]), min_c[j]);
          const float mag = fabsf(v);
          const bool inside = col_inside && y >= border && y < H - border;
          o_level[static_cast<long long>(y) * W] = (inside && (v >= mx || v <= mn) && mag > half_thr) ? mag : -1.0f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      max_pp[j] = max_p[j];
      min_pp[j] = min_p[j];
      max_p[j] = max_c[j];
      min_p[j] = min_c[j];
      val_p[j] = val_c[j];
    }
    __syncthreads();  // the stage just read is the target of the next iteration's copy
  }
}

}  // namespace

// dogs[o]: [B, L, H[o], W[o]] float32 contiguous; outs[o]: [B, L-2, H[o], W[o]] float32
// contiguous; all octaves share B and L. One launch on `stream`; nothing is allocated.
extern "C" cudaError_t vo_extrema_scores(const void* const* dogs, void* const* outs, const int* H,
                                         const int* W, int n_octaves, int B, int L, float half_thr,
                                         int border, cudaStream_t stream) {
  if (n_octaves < 1 || n_octaves > kMaxOctaves || B < 1 || L < 3) return cudaErrorInvalidValue;
  Octaves p;
  int total = 0;
  for (int o = 0; o < n_octaves; ++o) {
    p.dog[o] = static_cast<const float*>(dogs[o]);
    p.out[o] = static_cast<float*>(outs[o]);
    p.H[o] = H[o];
    p.W[o] = W[o];
    p.tiles_x[o] = (W[o] + kTileW - 1) / kTileW;
    total += p.tiles_x[o] * ((H[o] + kTileH - 1) / kTileH);
    p.tile_end[o] = total;
  }
  p.n = n_octaves;
  extrema_scores_kernel<<<dim3(total, B), kThreads, 0, stream>>>(p, L, half_thr, border);
  return cudaGetLastError();
}
