// RAFT correlation-pyramid lookup, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel ptlflow_tpu/ops/correlation.py::_lookup_pallas
// (the pl.pallas_call at :273).  Same function: for every query q of
// Q = B*H1*W1 and every pyramid level l, the (2r+1)^2 window of bilinear
// samples of that query's map at (x/2^l + a - r, y/2^l + b - r), zero
// outside the map, written to channel l*n*n + a*n + b (n = 2r+1).  The first
// window axis `a` offsets x: the reference quirk that converted checkpoints
// depend on.  Accumulates in fp32 (y-lerp, then x-lerp), writes the
// pyramid's dtype.
//
// What bounds it.  Each query reads only the (2r+2)^2 integer patch around
// floor(x, y) of its own map, so per launch the kernel moves the in-range
// patches (6.6 MB of elements for raft at 1024x436, fp32) and writes the
// output (Q*L*n*n, 9.1 MB): a few FLOPs per byte, so the card's memory
// bounds it, never its arithmetic.  The TPU kernel instead streamed every
// level map whole through one-hot MXU contractions; on Hopper a lookup is a
// gather, and the 261 MB pyramid is never read in full.  A patch row is 2r+2
// elements at any offset, so the card fetches whole 32-byte sectors: 11 MB
// for those 6.6 MB, at random addresses, each query's rows in its own map.
//
// What the design does about it.  A gather of short rows at random
// addresses is latency-bound unless each SM keeps many loads in flight
// (3.35 TB/s at ~0.75 us needs ~19 KB in flight per SM).
// - One block takes TQ = 32 neighbouring queries and one level (grid.y), so
//   any Q works (the ragged last tile is masked) and all levels go in one
//   launch.  At raft's Q = 7040 that is 880 blocks of 128 threads, all
//   resident at once (~7 per SM).
// - The radius is a template parameter (0..8, dispatched by the C entry
//   point): patch side, area and strides are constants, the staging loop
//   has no runtime division and unrolls fully.  The level table is a
//   __grid_constant__ parameter, read in place: indexed by blockIdx.y, a
//   by-value copy would go to a 128-byte stack frame in local memory.
// - fp32 patches are staged with cp.async: every thread issues all of its
//   (2r+2)^2*TQ/128 4-byte copies (25 at r = 4) before it waits once, so a
//   block has its whole patch set (12.8 KB at r = 4) in flight without
//   spending registers.  Only in-range elements are copied; the others are
//   zeroed with a plain shared store, so no address outside a map is ever
//   formed, and an empty level (0 rows or columns, whose pointer may be 0)
//   is never read.
// - bf16 patches are staged with plain loads instead: cp.async moves only
//   4, 8 or 16 aligned bytes, while a bf16 patch row starts at any 2-byte
//   offset (and with an odd map width the rows alternate in alignment).
//   The loop is fully unrolled, all loads are issued into registers before
//   any is converted and stored to shared memory, so each thread has all
//   of its loads (25 at r = 4) in flight.
// - Patch reads carry an L2 evict-first policy: they are read once, and
//   the lines they displace would otherwise include other kernels' written
//   lines, each a write-back to memory inside this kernel's time.
// - The bilinear fractions are shared by the whole window, so every output
//   is one 2x2 stencil over the staged patch (the factorization of
//   AltCorrBlock._level_corr).
// - Output is NCHW (B, L*n*n, H1, W1).  A warp holds 32 neighbouring queries
//   of one channel, so each store instruction writes 128 contiguous bytes
//   (64 in bf16), with the default caching: the next convolution reads the
//   output from L2.
// - Patch rows are padded to (2r+2)^2 + 1 floats, odd because 2r+2 is even,
//   so the 32 lanes of a warp reading 32 patches hit 32 different banks.
// Measured and left out (PERF.md): staging and computing a block's queries
// in 2 or 4 parts to overlap stores with the later parts' loads (slower:
// the stores already overlap other blocks' loads), 64 queries or 256
// threads per block, rolled staging loops, and touching each block's map
// and output pages early (no change).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxRadius = 8;
constexpr int kQueriesPerBlock = 32;
constexpr int kThreads = 128;
// A coordinate is clamped to +-2^20 before the int conversion (a window that
// far out reads nothing but zeros either way); a query past Q gets a corner
// beyond that, outside every map.
constexpr float kClamp = 1048576.f;
constexpr int kNoQuery = -(1 << 22);

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

template <int R>
struct Tile {
  static constexpr int N = 2 * R + 1;  // window side
  static constexpr int P = N + 1;      // patch side
  static constexpr int PP = P * P;
  static constexpr int PS = PP + 1;    // odd patch stride: no bank conflicts
  static constexpr int ELEMS = kQueriesPerBlock * PP;
  static constexpr int PER_THREAD = (ELEMS + kThreads - 1) / kThreads;
};

// Per-block staging state: each query's window corner and the offset of
// element (0, 0) of its patch in the level tensor.
struct Corners {
  int x0[kQueriesPerBlock];
  int y0[kQueriesPerBlock];
  long long base[kQueriesPerBlock];
  float fx[kQueriesPerBlock];
  float fy[kQueriesPerBlock];
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// L2 policy for the patch reads: evict first.  Each patch element is read
// once, so its lines may go first, and a set takes them as victims before
// the lines of other kernels (written lines would cost a write-back).
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// 4-byte asynchronous copy global -> shared, cached in L1 (.ca): the
// neighbouring elements of a patch row share its 32-byte sectors.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          uint64_t policy) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;\n"
               ::"r"(d), "l"(src), "l"(policy)
               : "memory");
}

__device__ __forceinline__ float load_bf16(const __nv_bfloat16* p,
                                           uint64_t policy) {
  unsigned short r;
  asm("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;"
      : "=h"(r)
      : "l"(p), "l"(policy));
  return __bfloat162float(__ushort_as_bfloat16(r));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Element k of this thread's share of the block's patches: query t, row i,
// column j.  Returns false past the last element.
template <int R>
__device__ __forceinline__ bool element(int k, int& t, int& e, int& i,
                                        int& j) {
  using TL = Tile<R>;
  const int idx = threadIdx.x + k * kThreads;
  t = idx / TL::PP;
  e = idx - t * TL::PP;
  i = e / TL::P;
  j = e - i * TL::P;
  return TL::ELEMS % kThreads == 0 || idx < TL::ELEMS;
}

template <int R>
__device__ __forceinline__ void stage(const float* __restrict__ map,
                                      float* patch, const Corners& cs,
                                      int h2, int w2) {
  using TL = Tile<R>;
  const uint64_t policy = evict_first_policy();
#pragma unroll
  for (int k = 0; k < TL::PER_THREAD; ++k) {
    int t, e, i, j;
    if (!element<R>(k, t, e, i, j)) break;
    const int yy = cs.y0[t] + i;
    const int xx = cs.x0[t] + j;
    float* dst = patch + t * TL::PS + e;
    if (static_cast<unsigned>(yy) < static_cast<unsigned>(h2) &&
        static_cast<unsigned>(xx) < static_cast<unsigned>(w2)) {
      cp_async4(dst, map + cs.base[t] + static_cast<long long>(i) * w2 + j,
                policy);
    } else {
      *dst = 0.f;
    }
  }
  cp_async_wait_all();
}

template <int R>
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ map,
                                      float* patch, const Corners& cs,
                                      int h2, int w2) {
  using TL = Tile<R>;
  float v[TL::PER_THREAD];
  const uint64_t policy = evict_first_policy();
#pragma unroll
  for (int k = 0; k < TL::PER_THREAD; ++k) {
    int t, e, i, j;
    v[k] = 0.f;
    if (!element<R>(k, t, e, i, j)) break;
    const int yy = cs.y0[t] + i;
    const int xx = cs.x0[t] + j;
    if (static_cast<unsigned>(yy) < static_cast<unsigned>(h2) &&
        static_cast<unsigned>(xx) < static_cast<unsigned>(w2)) {
      v[k] = load_bf16(
          map + cs.base[t] + static_cast<long long>(i) * w2 + j, policy);
    }
  }
#pragma unroll
  for (int k = 0; k < TL::PER_THREAD; ++k) {
    int t, e, i, j;
    if (!element<R>(k, t, e, i, j)) break;
    patch[t * TL::PS + e] = v[k];
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
corr_lookup_kernel(const float* __restrict__ coords,
                   const __grid_constant__ Levels levels,
                   T* __restrict__ out, int q_total, int hw1,
                   int num_levels) {
  using TL = Tile<R>;
  __shared__ float patch[kQueriesPerBlock * TL::PS];
  __shared__ Corners cs;

  const int lvl = blockIdx.y;
  const int q0 = blockIdx.x * kQueriesPerBlock;
  const int h2 = levels.h[lvl];
  const int w2 = levels.w[lvl];
  const T* map = static_cast<const T*>(levels.ptr[lvl]);

  // 1. Window corner and shared bilinear fractions of each query.
  if (threadIdx.x < kQueriesPerBlock) {
    const int t = threadIdx.x;
    const int q = q0 + t;
    float fx = 0.f, fy = 0.f;
    int x0 = kNoQuery, y0 = kNoQuery;
    if (q < q_total) {
      const float inv = 1.0f / static_cast<float>(1 << lvl);
      const int b = q / hw1;
      const int s = q - b * hw1;
      const float x = coords[(size_t)b * 2 * hw1 + s] * inv;
      const float y = coords[(size_t)b * 2 * hw1 + hw1 + s] * inv;
      const float xf = floorf(x);
      const float yf = floorf(y);
      fx = x - xf;
      fy = y - yf;
      x0 = static_cast<int>(fminf(fmaxf(xf, -kClamp), kClamp)) - R;
      y0 = static_cast<int>(fminf(fmaxf(yf, -kClamp), kClamp)) - R;
    }
    cs.x0[t] = x0;
    cs.y0[t] = y0;
    cs.base[t] = (static_cast<long long>(q) * h2 + y0) * w2 + x0;
    cs.fx[t] = fx;
    cs.fy[t] = fy;
  }
  __syncthreads();

  // 2. Stage the (2r+2)^2 patches, zero outside the map.
  stage<R>(map, patch, cs, h2, w2);
  __syncthreads();

  // 3. One 2x2 stencil per output; lane = query, warp strides channels.
  const int t = threadIdx.x % kQueriesPerBlock;
  const int q = q0 + t;
  if (q >= q_total) return;
  const int b = q / hw1;
  const int s = q - b * hw1;
  constexpr int NN = TL::N * TL::N;
  T* o = out + ((size_t)b * num_levels * NN + (size_t)lvl * NN) * hw1 + s;
  const float fx = cs.fx[t];
  const float fy = cs.fy[t];
  const float* pt = patch + t * TL::PS;
#pragma unroll 4
  for (int c = threadIdx.x / kQueriesPerBlock; c < NN;
       c += kThreads / kQueriesPerBlock) {
    const int a = c / TL::N;       // x offset
    const int bb = c - a * TL::N;  // y offset
    const float* r0 = pt + bb * TL::P + a;
    const float* r1 = r0 + TL::P;
    // y first, then x: the order of the JAX reference's two contractions
    const float t0 = (1.f - fy) * r0[0] + fy * r1[0];
    const float t1 = (1.f - fy) * r0[1] + fy * r1[1];
    store(o + (size_t)c * hw1, (1.f - fx) * t0 + fx * t1);
  }
}

// Launch the instantiation for `radius`: R counts up from 0 to kMaxRadius.
template <typename T, int R = 0>
cudaError_t launch(int radius, dim3 grid, cudaStream_t st,
                   const float* coords, const Levels& levels, T* out,
                   int q_total, int hw1, int num_levels) {
  if constexpr (R > kMaxRadius) {
    return cudaErrorInvalidValue;
  } else {
    if (radius != R) {
      return launch<T, R + 1>(radius, grid, st, coords, levels, out, q_total,
                              hw1, num_levels);
    }
    corr_lookup_kernel<T, R><<<grid, kThreads, 0, st>>>(
        coords, levels, out, q_total, hw1, num_levels);
    return cudaGetLastError();
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
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 0 ||
      radius > kMaxRadius) {
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
  const dim3 grid((q_total + kQueriesPerBlock - 1) / kQueriesPerBlock,
                  num_levels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(radius, grid, st, c, levels,
                                      static_cast<__nv_bfloat16*>(out),
                                      q_total, hw1, num_levels)
              : launch<float>(radius, grid, st, c, levels,
                              static_cast<float*>(out), q_total, hw1,
                              num_levels);
  return static_cast<int>(err);
}

}  // extern "C"
