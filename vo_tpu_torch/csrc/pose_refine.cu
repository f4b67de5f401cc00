// K3: RANSAC-P3P's consensus refinement in one launch, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference refines with XLA (vo_tpu/pose/ransac.py::refine_pose
// and the packaging after it). It was added because the `pose` stage takes most of the VO
// step's device time on the card (PERF.md section 5): in PyTorch the refinement is a Python
// loop of refine_iters IRLS Gauss-Newton iterations, which with the two gates and the
// packaging unrolls into about 1,450 small graph nodes a frame, each a launch's latency,
// while the arithmetic is one 6x6 system an iteration over ~1,024 points. Plain PyTorch
// version: vo_tpu_torch/pose/ransac.py::_finalize_plain (with refine_pose); wrapper:
// ransac._finalize_f32, which takes the plain version for CPU tensors and this kernel for
// CUDA ones.
//
// What it computes, in float32 as the plain version does:
//  1. the initial gate: every point projected through the RANSAC winner [R0|t0] (z clamped
//     at 1e-6 as _project_w2c does); inliers0 = mask & z > 0 & err^2 < thr2;
//  2. `iters` IRLS Gauss-Newton iterations: Huber weight (at `huber` px) times inliers0, the
//     2x6 Jacobian of the left-multiplicative update, H = sum w J^T J + 1e-6 I and
//     g = sum w J^T r, the 6x6 solve, T <- exp(-delta) T with se3.exp's small-angle branches;
//  3. the re-gate at the refined pose, better = |inliers_r| >= |inliers0|, and the packaging:
//     the chosen pose's inverse (camera-to-world), inliers, n_inliers, ok, mean_err.
//
// Bound: latency. 24 bytes a point in (~24 KB) and ~2 Mflop a call would take 7 ns and 30 ns
// at the card's peaks; what sets the time is the launch and a serial chain of iters + 1
// block-wide reductions, each followed (in the iterations) by one thread's 6x6 solve and SE(3)
// exponential. So the design:
//  - One block of kThreads threads. A thread keeps up to kCache of its points (pixel, 3D
//    point, mask, inliers0) in registers for the whole launch; points past kThreads * kCache
//    are read again from memory on each pass (block-stride loop), so any n works.
//  - Per iteration a thread adds its points' 21 terms of H's upper triangle and 6 of g, the
//    warps reduce them by shuffles, and the warps' partial sums meet in shared memory, added
//    in warp order. No atomics: a launch repeats bit for bit, which the graphed step's
//    equality with the eager one and the benchmark's repeatable runs rest on.
//  - Thread 0 solves by LDL^T (the 1e-6 ridge makes H symmetric positive definite), forms
//    exp(-delta), composes, and hands the pose to the block through shared memory.
//  - The gates use only operations whose rounding is fixed (fmaf, __fmul_rn, __fdiv_rn,
//    __fadd_rn, __fsub_rn): the compiler may not contract them, so a point gated again in a
//    later pass (past the register cache, or for the inliers' output) gets the same bits.
// The file is built without -use_fast_math: sinf, cosf, sqrtf and divisions are IEEE.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one block
constexpr int kWarps = kThreads / 32;
constexpr int kCache = 4;  // points a thread keeps in registers: 1,024 in all
constexpr int kTerms = 27;  // H's upper triangle (21, see upper()), then g (6)
constexpr int kFinal = 5;  // n_valid, |inliers0|, |inliers_r|, and the error sums over each set

struct Problem {
  const float* px;  // [n, 2] pixels of the current frame
  const float* pts;  // [n, 3] points in the previous camera's frame
  const unsigned char* mask;  // [n] bool
  int n;
  float fu, fv, cu, cv;
  float thr2;  // max_reproj_err_px ** 2
};

struct Point {
  float u, v, x, y, z;
  bool valid;  // mask
  bool in0;  // inside the gate at the unrefined pose
};

// A pose [R|t], world->camera: R row-major in [0, 9), t in [9, 12).
constexpr int kPose = 12;

// Where H[k][l], k <= l, sits among the sums: H's upper triangle row by row.
__host__ __device__ constexpr int upper(int k, int l) { return k * (11 - k) / 2 + l; }

struct Gate {
  float X, Y, Z;  // the point in the camera's frame
  float ru, rv;  // projection - pixel
  float e2;  // squared reprojection error
  bool in;  // valid, in front and e2 < thr2
};

__device__ __forceinline__ float safe_z(float z) { return fabsf(z) < 1e-6f ? 1e-6f : z; }

__device__ __forceinline__ float row(const float* T, int i, const Point& q) {
  return __fadd_rn(fmaf(T[3 * i + 2], q.z, fmaf(T[3 * i + 1], q.y, __fmul_rn(T[3 * i], q.x))), T[9 + i]);
}

// _project_w2c and the gate of _finalize_plain, for one point.
__device__ __forceinline__ Gate gate(const Problem& p, const float* T, const Point& q) {
  Gate g;
  g.X = row(T, 0, q);
  g.Y = row(T, 1, q);
  g.Z = row(T, 2, q);
  const float zs = safe_z(g.Z);
  g.ru = __fsub_rn(__fadd_rn(__fdiv_rn(__fmul_rn(p.fu, g.X), zs), p.cu), q.u);
  g.rv = __fsub_rn(__fadd_rn(__fdiv_rn(__fmul_rn(p.fv, g.Y), zs), p.cv), q.v);
  g.e2 = __fadd_rn(__fmul_rn(g.ru, g.ru), __fmul_rn(g.rv, g.rv));
  g.in = q.valid && g.Z > 0.f && g.e2 < p.thr2;
  return g;
}

__device__ __forceinline__ Point load(const Problem& p, const float* T0, int i) {
  Point q;
  q.u = p.px[2 * i];
  q.v = p.px[2 * i + 1];
  q.x = p.pts[3 * i];
  q.y = p.pts[3 * i + 1];
  q.z = p.pts[3 * i + 2];
  q.valid = p.mask[i] != 0;
  q.in0 = gate(p, T0, q).in;
  return q;
}

// f(i, point) for each of this thread's points: the cached ones, then those past the cache.
template <class F>
__device__ __forceinline__ void each_point(const Problem& p, const float* T0, const Point (&cache)[kCache], F&& f) {
#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < p.n) f(i, cache[k]);
  }
  for (int i = threadIdx.x + kCache * kThreads; i < p.n; i += kThreads) f(i, load(p, T0, i));
}

// out[k] = the block's sum of v[k]: shuffles within each warp, then the warps' partials in warp
// order. Every thread calls it; out is visible to all when it returns.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* partial, float* out) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) partial[warp * K + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = partial[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += partial[w * K + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// delta = (H + 1e-6 I)^-1 g by LDL^T, from the 27 sums (H's upper triangle row by row, then g).
__device__ __forceinline__ void solve6(const float* s, float (&delta)[6]) {
  float A[6][6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int l = k; l < 6; ++l) A[l][k] = s[upper(k, l)];
    A[k][k] += 1e-6f;
  }
  float L[6][6], D[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k] * D[k];
    D[j] = d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float e = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) e -= L[i][k] * L[j][k] * D[k];
      L[i][j] = e / d;
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float e = s[21 + i];
#pragma unroll
    for (int k = 0; k < i; ++k) e -= L[i][k] * y[k];
    y[i] = e;
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float e = y[i] / D[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) e -= L[k][i] * delta[k];
    delta[i] = e;
  }
}

// T <- exp(xi) T with xi = -delta = (v, w): se3.exp (Rodrigues, and its small-angle branches),
// then se3.compose.
__device__ __forceinline__ void update(float* T, const float (&delta)[6]) {
  const float v[3] = {-delta[0], -delta[1], -delta[2]};
  const float w0 = -delta[3], w1 = -delta[4], w2 = -delta[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float th = sqrtf(th2 + 1e-32f);
  const bool small = th2 < 1e-8f;
  const float sn = sinf(th), cs = cosf(th);
  const float a = small ? 1.f - th2 / 6.f : sn / th;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cs) / th2;
  const float c = small ? static_cast<float>(1.0 / 6.0) - th2 / 120.f : (th - sn) / (th2 * th);
  const float W[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float E[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float w2ij = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float eye = i == j ? 1.f : 0.f;
      E[i][j] = eye + a * W[i][j] + b * w2ij;
      V[i][j] = eye + b * W[i][j] + c * w2ij;
    }
  }
  float out[kPose];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out[3 * i + j] = E[i][0] * T[j] + E[i][1] * T[3 + j] + E[i][2] * T[6 + j];
    const float te = V[i][0] * v[0] + V[i][1] * v[1] + V[i][2] * v[2];
    out[9 + i] = E[i][0] * T[9] + E[i][1] * T[10] + E[i][2] * T[11] + te;
  }
#pragma unroll
  for (int k = 0; k < kPose; ++k) T[k] = out[k];
}

__global__ void __launch_bounds__(kThreads)
    pose_refine_kernel(Problem p, const float* R0, const float* t0, const unsigned char* any_valid, int iters,
                       float huber, int min_points, float* pose_c2w, unsigned char* inliers, long long* n_inliers,
                       unsigned char* ok, float* mean_err) {
  __shared__ float T0[kPose], T[kPose];
  __shared__ float partial[kWarps * kTerms];
  __shared__ float sums[kTerms];
  if (threadIdx.x < kPose) {
    const float e = threadIdx.x < 9 ? R0[threadIdx.x] : t0[threadIdx.x - 9];
    T0[threadIdx.x] = e;
    T[threadIdx.x] = e;
  }
  __syncthreads();
  Point cache[kCache] = {};
#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < p.n) cache[k] = load(p, T0, i);
  }

  for (int it = 0; it < iters; ++it) {
    float Tl[kPose];
#pragma unroll
    for (int k = 0; k < kPose; ++k) Tl[k] = T[k];
    float acc[kTerms] = {};
    each_point(p, T0, cache, [&](int, const Point& q) {
      const Gate g = gate(p, Tl, q);
      const float err = sqrtf(g.e2);
      const float w = (q.in0 ? 1.f : 0.f) * (err <= huber ? 1.f : huber / (err < 1e-9f ? 1e-9f : err));
      const float iz = 1.f / safe_z(g.Z);
      const float a = p.fu * iz, b = p.fv * iz;
      const float c = -p.fu * g.X * iz * iz, d = -p.fv * g.Y * iz * iz;
      // d(projection)/d(xi) for the left-multiplicative update: [d(px)/d(Xc)] [I | -hat(Xc)].
      const float J0[6] = {a, 0.f, c, c * g.Y, a * g.Z - c * g.X, -a * g.Y};
      const float J1[6] = {0.f, b, d, d * g.Y - b * g.Z, -d * g.X, b * g.X};
#pragma unroll
      for (int k = 0; k < 6; ++k) {
#pragma unroll
        for (int l = k; l < 6; ++l) acc[upper(k, l)] += w * (J0[k] * J0[l] + J1[k] * J1[l]);
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) acc[21 + k] += w * (J0[k] * g.ru + J1[k] * g.rv);
    });
    block_sum(acc, partial, sums);
    if (threadIdx.x == 0) {
      float delta[6];
      solve6(sums, delta);
      update(T, delta);
    }
    __syncthreads();
  }

  // Re-gate at the refined pose and keep it only if it kept the consensus.
  float Tl[kPose];
#pragma unroll
  for (int k = 0; k < kPose; ++k) Tl[k] = T[k];
  float fin[kFinal] = {};
  each_point(p, T0, cache, [&](int, const Point& q) {
    const Gate g0 = gate(p, T0, q), gr = gate(p, Tl, q);
    fin[0] += q.valid ? 1.f : 0.f;
    fin[1] += g0.in ? 1.f : 0.f;
    fin[2] += gr.in ? 1.f : 0.f;
    fin[3] += g0.in ? sqrtf(g0.e2) : 0.f;
    fin[4] += gr.in ? sqrtf(gr.e2) : 0.f;
  });
  block_sum(fin, partial, sums);  // counts below 2^24: exact in float32
  const bool better = sums[2] >= sums[1];
  each_point(p, T0, cache, [&](int i, const Point& q) { inliers[i] = better ? gate(p, Tl, q).in : q.in0; });
  if (threadIdx.x == 0) {
    const float* F = better ? T : T0;
    const long long n_in = static_cast<long long>(better ? sums[2] : sums[1]);
    *n_inliers = n_in;
    *ok = static_cast<long long>(sums[0]) >= min_points && *any_valid != 0 && n_in >= 3;
    *mean_err = (better ? sums[4] : sums[3]) / static_cast<float>(n_in > 1 ? n_in : 1);
    // camera-to-world: [R^T | -R^T t]
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) pose_c2w[4 * i + j] = F[3 * j + i];
      pose_c2w[4 * i + 3] = -(F[i] * F[9] + F[3 + i] * F[10] + F[6 + i] * F[11]);
      pose_c2w[12 + i] = 0.f;
    }
    pose_c2w[15] = 1.f;
  }
}

}  // namespace

// px float32 [n, 2], pts float32 [n, 3], mask bool [n], R0 float32 [3, 3], t0 float32 [3],
// any_valid bool []; out: pose_c2w float32 [4, 4], inliers bool [n], n_inliers int64 [],
// ok bool [], mean_err float32 []. All contiguous on one device; one launch on `stream`.
extern "C" cudaError_t vo_pose_refine(const void* px, const void* pts, const void* mask, const void* R0,
                                      const void* t0, const void* any_valid, int n, float fu, float fv, float cu,
                                      float cv, float thr2, float huber, int iters, int min_points, void* pose_c2w,
                                      void* inliers, void* n_inliers, void* ok, void* mean_err, void* stream) {
  if (n < 0 || n >= (1 << 24) || iters < 0) return cudaErrorInvalidValue;
  const Problem p{static_cast<const float*>(px), static_cast<const float*>(pts),
                  static_cast<const unsigned char*>(mask), n, fu, fv, cu, cv, thr2};
  pose_refine_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float*>(R0), static_cast<const float*>(t0), static_cast<const unsigned char*>(any_valid),
      iters, huber, min_points, static_cast<float*>(pose_c2w), static_cast<unsigned char*>(inliers),
      static_cast<long long*>(n_inliers), static_cast<unsigned char*>(ok), static_cast<float*>(mean_err));
  return cudaGetLastError();
}
