// RAFT correlation-pyramid lookup, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel ptlflow_tpu/ops/correlation.py::_lookup_pallas
// (the pl.pallas_call at :273).  Same function: for every query q of
// Q = B*H1*W1 and every pyramid level l, the (2r+1)^2 window of bilinear
// samples of that query's map at (x/2^l + a - r, y/2^l + b - r), zero
// outside the map, written to channel l*n*n + a*n + b (n = 2r+1).  The first
// window axis `a` offsets x: the reference quirk that converted checkpoints
// depend on.  Accumulates in fp32, writes the pyramid's dtype.
//
// What bounds it.  Each query reads only the (2r+2)^2 integer patch around
// floor(x, y) of its own map, so per launch the kernel moves the in-range
// patches (at most Q*L*(2r+2)^2 elements, ~11 MB for raft at 1024x436) and
// writes the output (Q*L*n*n, ~9 MB in fp32): a few FLOPs per byte, so the
// card's memory rate bounds it, never its arithmetic.  The TPU kernel instead
// streamed every level map whole through one-hot MXU contractions; on Hopper
// a lookup is a gather, and the 261 MB pyramid is never read in full.
//
// What the design does about it.
// - One block takes TQ = 32 neighbouring queries and one level (grid.y), so
//   any Q works (the ragged last tile is masked) and all levels go in one
//   launch.
// - The block first stages each query's (2r+2)^2 patch in shared memory,
//   zero-filled outside the map, reading rows of 2r+2 contiguous elements.
//   The bilinear fractions are shared by the whole window, so every output
//   is one 2x2 stencil over the staged patch (the factorization of
//   AltCorrBlock._level_corr).
// - Output is NCHW (B, L*n*n, H1, W1).  A warp holds 32 neighbouring queries
//   of one channel, so each store instruction writes 128 contiguous bytes.
// - Patch rows are padded to (2r+2)^2 + 1 floats, odd because 2r+2 is even,
//   so the 32 lanes of a warp reading 32 patches hit 32 different banks.
// Left for later: cp.async/TMA staging of the patches, and overlapping one
// tile's loads with the previous tile's stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kQueriesPerBlock = 32;
constexpr int kThreads = 128;

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_lookup_kernel(const float* __restrict__ coords, Levels levels,
                   T* __restrict__ out, int q_total, int hw1, int radius,
                   int num_levels) {
  extern __shared__ float smem[];
  const int n = 2 * radius + 1;
  const int p = n + 1;             // patch side
  const int pp = p * p;
  const int pstride = pp + 1;      // odd stride: no bank conflicts
  float* patch = smem;                                          // TQ*pstride
  int* corner = reinterpret_cast<int*>(patch + kQueriesPerBlock * pstride);
  float* frac = reinterpret_cast<float*>(corner + 2 * kQueriesPerBlock);

  const int lvl = blockIdx.y;
  const int q0 = blockIdx.x * kQueriesPerBlock;
  const int h2 = levels.h[lvl];
  const int w2 = levels.w[lvl];
  const T* map = static_cast<const T*>(levels.ptr[lvl]);
  const float inv = 1.0f / static_cast<float>(1 << lvl);

  // 1. Window corner and shared bilinear fractions of each query.
  if (threadIdx.x < kQueriesPerBlock) {
    const int t = threadIdx.x;
    const int q = q0 + t;
    float fx = 0.f, fy = 0.f;
    int x0 = 0, y0 = 0;
    if (q < q_total) {
      const int b = q / hw1;
      const int s = q - b * hw1;
      const float x = coords[(size_t)b * 2 * hw1 + s] * inv;
      const float y = coords[(size_t)b * 2 * hw1 + hw1 + s] * inv;
      // clamp before the int conversion: a window that far out reads
      // nothing but zeros either way
      const float xf = fminf(fmaxf(floorf(x), -1048576.f), 1048576.f);
      const float yf = fminf(fmaxf(floorf(y), -1048576.f), 1048576.f);
      fx = x - floorf(x);
      fy = y - floorf(y);
      x0 = static_cast<int>(xf) - radius;
      y0 = static_cast<int>(yf) - radius;
    }
    corner[2 * t] = x0;
    corner[2 * t + 1] = y0;
    frac[2 * t] = fx;
    frac[2 * t + 1] = fy;
  }
  __syncthreads();

  // 2. Stage the (2r+2)^2 patches, zero outside the map.
  for (int idx = threadIdx.x; idx < kQueriesPerBlock * pp; idx += kThreads) {
    const int t = idx / pp;
    const int e = idx - t * pp;
    const int i = e / p;
    const int j = e - i * p;
    const int q = q0 + t;
    const int yy = corner[2 * t + 1] + i;
    const int xx = corner[2 * t] + j;
    float v = 0.f;
    if (q < q_total && yy >= 0 && yy < h2 && xx >= 0 && xx < w2) {
      v = load_f32(map + ((size_t)q * h2 + yy) * w2 + xx);
    }
    patch[t * pstride + e] = v;
  }
  __syncthreads();

  // 3. One 2x2 stencil per output; lane = query, warp strides channels.
  const int t = threadIdx.x % kQueriesPerBlock;
  const int q = q0 + t;
  if (q >= q_total) return;
  const int b = q / hw1;
  const int s = q - b * hw1;
  const int nn = n * n;
  T* o = out + ((size_t)b * num_levels * nn + (size_t)lvl * nn) * hw1 + s;
  const float fx = frac[2 * t];
  const float fy = frac[2 * t + 1];
  const float* pt = patch + t * pstride;
  for (int c = threadIdx.x / kQueriesPerBlock; c < nn;
       c += kThreads / kQueriesPerBlock) {
    const int a = c / n;       // x offset
    const int bb = c - a * n;  // y offset
    const float* r0 = pt + bb * p + a;
    const float* r1 = r0 + p;
    // y first, then x: the order of the JAX reference's two contractions
    const float t0 = (1.f - fy) * r0[0] + fy * r1[0];
    const float t1 = (1.f - fy) * r0[1] + fy * r1[1];
    store(o + (size_t)c * hw1, (1.f - fx) * t0 + fx * t1);
  }
}

}  // namespace

extern "C" {

// coords: (B, 2, H1, W1) fp32.  level_ptrs[l]: (B*H1*W1, level_h[l],
// level_w[l]) contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// out: (B, num_levels*(2r+1)^2, H1, W1) in the levels' dtype.
// Launches on `stream`; returns cudaGetLastError() after the launch.
int corr_lookup(const void* coords, const void* const* level_ptrs,
                const int* level_h, const int* level_w, int num_levels,
                void* out, int batch, int h1, int w1, int radius, int is_bf16,
                void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels levels;
  for (int l = 0; l < num_levels; ++l) {
    levels.ptr[l] = level_ptrs[l];
    levels.h[l] = level_h[l];
    levels.w[l] = level_w[l];
  }
  const int hw1 = h1 * w1;
  const int q_total = batch * hw1;
  const int p = 2 * radius + 2;
  const size_t smem = sizeof(float) * kQueriesPerBlock * (p * p + 1) +
                      sizeof(int) * 2 * kQueriesPerBlock +
                      sizeof(float) * 2 * kQueriesPerBlock;
  const dim3 grid((q_total + kQueriesPerBlock - 1) / kQueriesPerBlock,
                  num_levels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    corr_lookup_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(coords), levels,
        static_cast<__nv_bfloat16*>(out), q_total, hw1, radius, num_levels);
  } else {
    corr_lookup_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(coords), levels, static_cast<float*>(out),
        q_total, hw1, radius, num_levels);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
