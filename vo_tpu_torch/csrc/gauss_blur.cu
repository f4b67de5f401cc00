// K4: the separable Gaussian blurs of the SIFT detector, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package (vo_tpu/frontend/pyramid.py, dense_desc.py) leaves these
// blurs to XLA as products with dense banded [n, n] matrices, a design for the TPU's matrix unit.
// On this card those products ran at some 40 times the work the taps need. Plain PyTorch version:
// the same band products, vo_tpu_torch/frontend/pyramid.py::blur_separable and
// _blur_stack_from_base (the DoG a subtraction after them), dense_desc._blur_maps. Wrappers:
// pyramid.gauss_stack (the base blur, and each octave's levels with its DoG) and
// dense_desc.bin_map_rows (every level's bin-map blur of a detection call in one launch).
//
// What it computes. A blur of radius r over n samples is the band product out[i] = sum_j B[i, j] x[j]
// with B = pyramid._band_matrix(n, taps): interior weights are the taps, and the taps past either
// end are merged onto the end sample (np.add.at, in tap order). The kernel takes B's own float32
// values (pyramid.tap_table: the taps k[t]; lo[i] = B[i, 0] and hi[i] = B[n-1-i, n-1] for i <= r;
// tot = B[0, 0] where n = 1) and sums each output as one fmaf chain from +0 over the nonzero weights
// in ascending source index: over y first into a float32 intermediate, then over x. That is the
// order in which a non-split-K SGEMM sums the band products, and their zero terms add nothing, so
// where cuBLAS takes such a GEMM the two agree bit for bit. The 2x decimation of octaves above 0
// is the band matrices of the decimated grid times the every-2nd-sample selector: the taps index the
// even rows and columns of the octave's base. A level's DoG (level l minus level l-1) is written in
// the same pass as the level.
//
// Bound: device memory. The pyramid writes 11 planes (6 levels, 5 DoG) per base plane it reads, and
// the bin-map blurs read and write 8 channels per pooled pixel: some 255 MB for a detection call of
// 4 images, 0.076 ms at 3.35 TB/s, against about 1e9 fmaf (0.03 ms at the float32 peak). The design:
//  - A block owns a 32-row output tile of one image. It copies the source tile with the widest halo
//    of its levels to shared memory once and computes every level (every channel of the bin maps)
//    from that copy: the pass over y writes its rows to shared memory, the pass over x reads them.
//  - Register blocking along the blur's direction: a thread of the y pass computes 8 consecutive
//    rows of one column (8 + 2r loads for 8 (2r+1) fmaf), a thread of the x pass 8 (4 for the bin
//    maps) consecutive columns of one row. Warps of the y pass span columns and those of the x pass
//    span the tile's 32 rows over odd row pitches, so shared memory is read without bank conflicts.
//    The radius is a template parameter (a switch over 0..kMaxR per level), so the taps sit in
//    registers and the loops unroll.
//  - The end samples are kept apart so that edge and interior outputs run the same code: the tile
//    holds 0 at source samples 0 and n-1 (an exact no-op in a chain of finite values), and an output
//    that reaches sample 0 starts its chain with lo[i] * x[0], one that reaches n-1 ends it with
//    hi[n-1-i] * x[n-1]: the first and the last nonzero terms of its band row.
//  - Stores are 4-byte and coalesced along x for the pyramid (its row strides of 1241, 621, 311 and
//    156 floats are not multiples of 16 bytes, and K1 and K2 read the planes as they are), 16-byte for
//    the bin maps, whose tile rows are contiguous runs of 8 channels a pixel in the descriptor's
//    channel-last rows ([B, N, 8], each level at its row offset), staged in shared memory.
//  - No atomics, nothing allocated: an image's outputs depend on nothing but its own inputs, so they
//    do not change with the batch, and a CUDA graph replays the launch as it was captured (every
//    weight travels by value in the __grid_constant__ parameters).
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxR = 16;   // widest radius a launch takes (33 taps)
constexpr int kSmallR = 8;  // a launch whose radii are all <= kSmallR runs the build for them alone
// Blocks an SM holds of each build: the registers are capped for them. More blocks of the wide build
// spill its 33-tap passes; fewer leave the card's memory idle (8 warps an SM).
constexpr int kSmallBlocks = 3;
constexpr int kWideBlocks = 2;
constexpr int kTaps = 2 * kMaxR + 1;
constexpr int kMaxLevels = 8;
constexpr int kMaxJobs = 24;  // bin-map blurs of one launch: octaves x levels
constexpr int kMaxSets = 8;   // distinct tap sets of one bin-map launch
constexpr int kThreads = 256;
constexpr int kTileH = 32;  // rows of an output tile: a warp of the x pass spans them
constexpr int kRY = 8;      // rows a thread of the y pass computes
constexpr int kNB = 8;      // bin-map channels
constexpr int kStackW = 64;  // columns of a pyramid tile
constexpr int kStackRX = 8;  // columns a thread of the pyramid's x pass computes
constexpr int kRowsW = 32;   // columns of a bin-map tile
constexpr int kRowsRX = 4;
constexpr int kRowsOut = kRowsW * kNB + 4;  // staged row pitch: 16-byte aligned rows

struct Taps {
  int r;
  float k[kTaps];       // k[t], t = 0..2r
  float lo[kMaxR + 1];  // weight of sample 0 in output i <= r
  float hi[kMaxR + 1];  // weight of sample n-1 in output n-1-i, i <= r
  float tot;            // the one weight where n == 1
};

struct Tile {
  int y0, x0;  // first output row and column
  int H, W;    // samples (and outputs) along y and x
  int R;       // halo of the shared copy: the widest radius of the launch
};

// Starts the copy of the source tile with halo R to shared memory: rows y0-R .. y0+kTileH+R-1,
// columns x0-R .. x0+TW+R-1 of the sample grid (sample (m, j) at plane[dec*m*row + dec*j]), by
// 4-byte cp.async, a warp to a row, all of them in flight at once; one commit. Samples 0 and H-1
// along y and everything outside the grid hold 0; rows 0 and H-1 go to top and bot where the
// tile's outputs reach them.
__device__ __forceinline__ void load_tile(const float* __restrict__ plane, long long row, int dec, const Tile& t,
                                          float* src, int sp, float* top, float* bot) {
  const int lane = threadIdx.x % 32;
  auto copy_row = [&](float* dst, int m, bool inside) {
    for (int c = lane; c < sp; c += 32) {
      const int j = t.x0 - t.R + c;
      if (inside && j >= 0 && j < t.W) {
        __pipeline_memcpy_async(dst + c, plane + dec * (m * row + j), sizeof(float));
      } else {
        dst[c] = 0.0f;
      }
    }
  };
  for (int a = threadIdx.x / 32; a < kTileH + 2 * t.R; a += kThreads / 32) {
    const int m = t.y0 - t.R + a;
    copy_row(src + a * sp, m, m > 0 && m < t.H - 1);
  }
  if (threadIdx.x < 32 && t.y0 <= t.R) copy_row(top, 0, true);
  if (threadIdx.x >= kThreads - 32 && t.y0 + kTileH - 1 >= t.H - 1 - t.R) copy_row(bot, t.H - 1, true);
  __pipeline_commit();
}

// The pass over y: mid[y][c] for the tile's rows and the halo-frame columns c (image column
// x0 - R + c) that the x pass of radius r reads. Image columns 0 and W-1 go to left and right, and
// mid holds 0 there and outside the image, as the source tile does along y.
template <int r>
__device__ __forceinline__ void y_pass(const Taps& tp, const Tile& t, int TW, const float* src, int sp,
                                       const float* top, const float* bot, float* mid, int mp, float* left,
                                       float* right) {
  float w[2 * r + 1];
#pragma unroll
  for (int i = 0; i <= 2 * r; ++i) w[i] = tp.k[i];
  const int ncols = TW + 2 * r;
  const int items = ncols * (kTileH / kRY);
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int g = it / ncols;
    const int c = t.R - r + (it - g * ncols);
    const int x = t.x0 - t.R + c;
    const int yb = g * kRY;
    float acc[kRY];
#pragma unroll
    for (int q = 0; q < kRY; ++q) {
      const int i = t.y0 + yb + q;
      acc[q] = i <= r ? fmaf(t.H == 1 ? tp.tot : tp.lo[i], top[c], 0.0f) : 0.0f;
    }
    const float* s = src + (yb + t.R - r) * sp + c;
#pragma unroll
    for (int d = 0; d < kRY + 2 * r; ++d) {
      const float v = s[d * sp];
#pragma unroll
      for (int q = 0; q < kRY; ++q) {
        if (d - q >= 0 && d - q <= 2 * r) acc[q] = fmaf(w[d - q], v, acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kRY; ++q) {
      const int i = t.y0 + yb + q;
      if (t.H > 1 && i < t.H && i >= t.H - 1 - r) acc[q] = fmaf(tp.hi[t.H - 1 - i], bot[c], acc[q]);
      const int y = yb + q;
      if (x == 0) left[y] = acc[q];
      if (x == t.W - 1) right[y] = acc[q];
      mid[y * mp + c] = (x > 0 && x < t.W - 1) ? acc[q] : 0.0f;
    }
  }
}

// The pass over x: out(y, xc) for the tile's rows y and columns xc = 0..TW-1, handed to store.
template <int r, int RX, class Store>
__device__ __forceinline__ void x_pass(const Taps& tp, const Tile& t, int TW, const float* mid, int mp,
                                       const float* left, const float* right, Store store) {
  float w[2 * r + 1];
#pragma unroll
  for (int i = 0; i <= 2 * r; ++i) w[i] = tp.k[i];
  const int items = kTileH * (TW / RX);
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int y = it % kTileH;
    const int xb = (it / kTileH) * RX;
    float acc[RX];
#pragma unroll
    for (int q = 0; q < RX; ++q) {
      const int x = t.x0 + xb + q;
      acc[q] = x <= r ? fmaf(t.W == 1 ? tp.tot : tp.lo[x], left[y], 0.0f) : 0.0f;
    }
    const float* s = mid + y * mp + t.R - r + xb;
#pragma unroll
    for (int d = 0; d < RX + 2 * r; ++d) {
      const float v = s[d];
#pragma unroll
      for (int q = 0; q < RX; ++q) {
        if (d - q >= 0 && d - q <= 2 * r) acc[q] = fmaf(w[d - q], v, acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < RX; ++q) {
      const int x = t.x0 + xb + q;
      if (t.W > 1 && x < t.W && x >= t.W - 1 - r) acc[q] = fmaf(tp.hi[t.W - 1 - x], right[y], acc[q]);
      store(y, xb + q, acc[q]);
    }
  }
}

#define VO_RADII(X) \
  X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

// Both passes of one blur at the radius tp.r (at most MaxR), the x pass's outputs to store; a
// barrier after each.
template <int MaxR, int RX, class Store>
__device__ __forceinline__ void blur(const Taps& tp, const Tile& t, int TW, const float* src, int sp,
                                     const float* top, const float* bot, float* mid, int mp, float* left,
                                     float* right, Store store) {
  switch (tp.r) {
#define VO_Y(n) \
  case n:       \
    if constexpr (n <= MaxR) y_pass<n>(tp, t, TW, src, sp, top, bot, mid, mp, left, right); \
    break;
    VO_RADII(VO_Y)
#undef VO_Y
  }
  __syncthreads();
  switch (tp.r) {
#define VO_X(n) \
  case n:       \
    if constexpr (n <= MaxR) x_pass<n, RX>(tp, t, TW, mid, mp, left, right, store); \
    break;
    VO_RADII(VO_X)
#undef VO_X
  }
  __syncthreads();
}

// Floats of one source buffer: the tile with halo R and its two end rows.
__host__ __device__ constexpr int source_floats(int R, int TW) { return (kTileH + 2 * R + 2) * (TW + 2 * R); }

// Floats of shared memory: the staged outputs (first: 16-byte aligned), the source buffers, the y
// pass's rows and its two end columns.
__host__ __device__ constexpr int smem_floats(int R, int TW, int out, int buffers) {
  return out + buffers * source_floats(R, TW) + kTileH * ((TW + 2 * R) | 1) + 2 * kTileH;
}

struct Stack {
  const float* src;        // the source plane of image 0, unit stride along x
  long long src_b, src_y;  // its image and row strides, in elements
  int dec;                 // 1, or 2: the samples are the source's even rows and columns
  int H, W;                // samples along y and x: the output planes' size
  float* g;                // [B, L, H, W]
  float* dog;              // [B, L-1, H, W], or null
  int L, R, tiles_x;
  Taps lv[kMaxLevels];
};

constexpr int kStackOut = kTileH * (kStackW + 1);

// MaxR: the widest radius of the launch is at most MaxR (kSmallR or kMaxR: the narrower build needs
// fewer registers, so more blocks share an SM).
template <int MaxR>
__global__ void __launch_bounds__(kThreads, MaxR <= kSmallR ? kSmallBlocks : kWideBlocks)
    gauss_stack_kernel(const __grid_constant__ Stack p) {
  extern __shared__ float4 smem4[];
  float* out = reinterpret_cast<float*>(smem4);
  const int R = p.R;
  const int sp = kStackW + 2 * R;
  const int mp = sp | 1;
  float* src = out + kStackOut;
  float* top = src + (kTileH + 2 * R) * sp;
  float* bot = top + sp;
  float* mid = src + source_floats(R, kStackW);
  float* left = mid + kTileH * mp;
  float* right = left + kTileH;
  const Tile t{static_cast<int>(blockIdx.x / p.tiles_x) * kTileH, static_cast<int>(blockIdx.x % p.tiles_x) * kStackW,
               p.H, p.W, R};
  load_tile(p.src + blockIdx.y * p.src_b, p.src_y, p.dec, t, src, sp, top, bot);
  __pipeline_wait_prior(0);
  __syncthreads();

  const long long plane = static_cast<long long>(p.H) * p.W;
  float* g = p.g + static_cast<long long>(blockIdx.y) * p.L * plane;
  float* dog = p.dog == nullptr ? nullptr : p.dog + static_cast<long long>(blockIdx.y) * (p.L - 1) * plane;
  constexpr int kPer = kTileH * kStackW / kThreads;
  float prev[kPer];
  auto stage = [out](int y, int xc, float v) { out[y * (kStackW + 1) + xc] = v; };
  for (int l = 0; l < p.L; ++l) {
    blur<MaxR, kStackRX>(p.lv[l], t, kStackW, src, sp, top, bot, mid, mp, left, right, stage);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int y = e / kStackW;
      const int xc = e % kStackW;
      const float v = out[y * (kStackW + 1) + xc];
      if (t.y0 + y < p.H && t.x0 + xc < p.W) {
        const long long o = static_cast<long long>(t.y0 + y) * p.W + t.x0 + xc;
        g[l * plane + o] = v;
        if (dog != nullptr && l > 0) dog[(l - 1) * plane + o] = v - prev[k];
      }
      prev[k] = v;
    }
  }
}

struct RowsJob {
  const float* src;  // channel 0 of image 0: [8, H, W] planes
  long long src_b;   // image stride, in elements
  long long row0;    // the job's first row in an image's [N, 8] rows
  int H, W, tiles_x;
  int tile_end;  // running total of tiles up to and including this job
  int set;       // index into Rows::set
};

struct Rows {
  RowsJob job[kMaxJobs];
  float* dst;        // [B, N, 8]
  long long dst_b;   // N * 8
  int n_jobs, R;
  Taps set[kMaxSets];
};

constexpr int kRowsStaged = kTileH * kRowsOut;

template <int MaxR>
__global__ void __launch_bounds__(kThreads, MaxR <= kSmallR ? kSmallBlocks : kWideBlocks)
    gauss_rows_kernel(const __grid_constant__ Rows p) {
  extern __shared__ float4 smem4[];
  float* out = reinterpret_cast<float*>(smem4);
  int j = 0;
  while (j + 1 < p.n_jobs && static_cast<int>(blockIdx.x) >= p.job[j].tile_end) ++j;
  const RowsJob& jb = p.job[j];
  const int tile = blockIdx.x - (j == 0 ? 0 : p.job[j - 1].tile_end);
  const int R = p.R;
  const int sp = kRowsW + 2 * R;
  const int mp = sp | 1;
  // Two source buffers: channel c+1 is copied in while channel c is blurred.
  const int nbuf = source_floats(R, kRowsW);
  float* const buf = out + kRowsStaged;
  float* mid = buf + 2 * nbuf;
  float* left = mid + kTileH * mp;
  float* right = left + kTileH;
  const Tile t{(tile / jb.tiles_x) * kTileH, (tile % jb.tiles_x) * kRowsW, jb.H, jb.W, R};
  const long long plane = static_cast<long long>(jb.H) * jb.W;
  const float* in = jb.src + blockIdx.y * jb.src_b;
  auto load = [&](int c) {
    float* src = buf + (c % 2) * nbuf;
    load_tile(in + c * plane, jb.W, 1, t, src, sp, src + (kTileH + 2 * R) * sp, src + (kTileH + 2 * R + 1) * sp);
  };
  load(0);
  for (int c = 0; c < kNB; ++c) {
    if (c + 1 < kNB) {
      load(c + 1);  // into the buffer channel c-1 was read from: the barriers in blur() have passed
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(1);
    __syncthreads();
    const float* src = buf + (c % 2) * nbuf;
    blur<MaxR, kRowsRX>(p.set[jb.set], t, kRowsW, src, sp, src + (kTileH + 2 * R) * sp, src + (kTileH + 2 * R + 1) * sp, mid,
                  mp, left, right, [out, c](int y, int xc, float v) { out[y * kRowsOut + xc * kNB + c] = v; });
  }
  // Tile row y is the contiguous run of rows row0 + (y0+y)*W + x0 .. of 8 channels each.
  float* dst = p.dst + blockIdx.y * p.dst_b;
  for (int e = threadIdx.x; e < kTileH * kRowsW * 2; e += kThreads) {
    const int y = e / (kRowsW * 2);
    const int v = e % (kRowsW * 2);
    const int x = t.x0 + v / 2;
    if (t.y0 + y < jb.H && x < jb.W) {
      const float4 val = *reinterpret_cast<const float4*>(out + y * kRowsOut + v * 4);
      *reinterpret_cast<float4*>(dst + (jb.row0 + static_cast<long long>(t.y0 + y) * jb.W + x) * kNB + (v & 1) * 4) = val;
    }
  }
}

// Taps of level i from the host's tables: taps [n][kTaps], lo and hi [n][kMaxR + 1], tot [n].
bool fill_taps(Taps* out, int n, const int* radii, const float* taps, const float* lo, const float* hi,
               const float* tot, int* widest) {
  for (int i = 0; i < n; ++i) {
    if (radii[i] < 0 || radii[i] > kMaxR) return false;
    out[i].r = radii[i];
    for (int k = 0; k < kTaps; ++k) out[i].k[k] = taps[i * kTaps + k];
    for (int k = 0; k <= kMaxR; ++k) {
      out[i].lo[k] = lo[i * (kMaxR + 1) + k];
      out[i].hi[k] = hi[i * (kMaxR + 1) + k];
    }
    out[i].tot = tot[i];
    if (radii[i] > *widest) *widest = radii[i];
  }
  return true;
}

}  // namespace

// One octave's level stack (or the base blur: one level, no DoG). src: the source plane of image 0
// (float32, unit stride along x, image stride src_b and row stride src_y in elements); dec 1 or 2;
// H, W the output planes' size; g [B, L, H, W] and dog [B, L-1, H, W] (null: none) contiguous
// float32. One launch on `stream`; nothing is allocated.
extern "C" cudaError_t vo_gauss_stack(const void* src, long long src_b, long long src_y, int dec, int H, int W,
                                      void* g, void* dog, int B, int L, const int* radii, const float* taps,
                                      const float* lo, const float* hi, const float* tot, cudaStream_t stream) {
  if (B < 1 || B > 65535 || L < 1 || L > kMaxLevels || H < 1 || W < 1 || (dec != 1 && dec != 2) ||
      (dog != nullptr && L < 2)) {
    return cudaErrorInvalidValue;
  }
  Stack p;
  p.R = 0;
  if (!fill_taps(p.lv, L, radii, taps, lo, hi, tot, &p.R)) return cudaErrorInvalidValue;
  p.src = static_cast<const float*>(src);
  p.src_b = src_b;
  p.src_y = src_y;
  p.dec = dec;
  p.H = H;
  p.W = W;
  p.g = static_cast<float*>(g);
  p.dog = static_cast<float*>(dog);
  p.L = L;
  p.tiles_x = (W + kStackW - 1) / kStackW;
  const long long tiles = static_cast<long long>(p.tiles_x) * ((H + kTileH - 1) / kTileH);
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(float)) * smem_floats(p.R, kStackW, kStackOut, 1);
  const auto kernel = p.R <= kSmallR ? gauss_stack_kernel<kSmallR> : gauss_stack_kernel<kMaxR>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(tiles), B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Every bin-map blur of a detection call. Job i blurs the 8 channel planes [8, H[i], W[i]] at
// srcs[i] (image stride src_b[i], in elements; contiguous planes) with tap set set[i] and writes
// them channel-last into dst ([B, N, 8] contiguous float32, 16-byte aligned; dst_b = N * 8) from
// row row0[i] on. One launch on `stream`; nothing is allocated.
extern "C" cudaError_t vo_gauss_rows(const void* const* srcs, const long long* src_b, const long long* row0,
                                     const int* H, const int* W, const int* set, int n_jobs, void* dst,
                                     long long dst_b, int B, int n_sets, const int* radii, const float* taps,
                                     const float* lo, const float* hi, const float* tot, cudaStream_t stream) {
  if (B < 1 || B > 65535 || n_jobs < 1 || n_jobs > kMaxJobs || n_sets < 1 || n_sets > kMaxSets) {
    return cudaErrorInvalidValue;
  }
  Rows p;
  p.R = 0;
  if (!fill_taps(p.set, n_sets, radii, taps, lo, hi, tot, &p.R)) return cudaErrorInvalidValue;
  long long total = 0;
  for (int i = 0; i < n_jobs; ++i) {
    if (H[i] < 1 || W[i] < 1 || set[i] < 0 || set[i] >= n_sets) return cudaErrorInvalidValue;
    RowsJob& jb = p.job[i];
    jb.src = static_cast<const float*>(srcs[i]);
    jb.src_b = src_b[i];
    jb.row0 = row0[i];
    jb.H = H[i];
    jb.W = W[i];
    jb.set = set[i];
    jb.tiles_x = (W[i] + kRowsW - 1) / kRowsW;
    total += static_cast<long long>(jb.tiles_x) * ((H[i] + kTileH - 1) / kTileH);
    if (total >= (1LL << 31)) return cudaErrorInvalidValue;
    jb.tile_end = static_cast<int>(total);
  }
  p.n_jobs = n_jobs;
  p.dst = static_cast<float*>(dst);
  p.dst_b = dst_b;
  const int smem = static_cast<int>(sizeof(float)) * smem_floats(p.R, kRowsW, kRowsStaged, 2);
  const auto kernel = p.R <= kSmallR ? gauss_rows_kernel<kSmallR> : gauss_rows_kernel<kMaxR>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(total), B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}
