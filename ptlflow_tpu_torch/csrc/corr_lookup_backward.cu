// Gradient of the RAFT correlation-pyramid lookup with respect to the
// pyramid, written by hand for Hopper (sm_90a).
//
// It has no Pallas counterpart: the JAX package trains through its XLA
// lookup (ptlflow_tpu/ops/correlation.py::corr_pyramid_lookup, under
// jax.grad, with the coords under stop_gradient), and its one Pallas kernel,
// _lookup_pallas, is forward only.  This is the backward of
// csrc/corr_lookup.cu: the transpose of its stencil.  For every query q of
// Q = B*H1*W1 and level l, the forward reads the (2r+2)^2 patch of q's map
// around (x0, y0) = floor(coords / 2^l) - r and writes output channel
// l*n*n + a*n + b (n = 2r+1; the first window axis `a` offsets x) as
//   (1-fx)*((1-fy)*p[b][a] + fy*p[b+1][a]) + fx*((1-fy)*p[b][a+1] + fy*p[b+1][a+1]).
// So patch cell (i, j) of q receives
//   sum over (di, dj) in {0,1}^2 of wy(di)*wx(dj)*g[a = j-dj][b = i-di],
// with wy(0) = 1-fy, wy(1) = fy (wx likewise) and 0 <= a, b < n, and every
// other element of q's map receives 0, as does every patch cell outside the
// map.  Accumulates in fp32, writes the level's dtype (fp32 or bf16).
//
// What bounds it.  Each query owns its own map, so the gradient of level l
// is the dense (Q, H2, W2) array, nearly all zeros: per launch the kernel
// writes every level whole (429.5 MB at RAFT's training shape, 368x496,
// batch 10, fp32) and reads only grad_out (Q*L*n*n, 37 MB) and the coords.
// A few FLOPs per written byte: the card's write rate bounds it.
//
// What the design does about it.  Kept simple and right; speed is later
// work (a redesign would accumulate the 12 iterations' gradients in place).
// - No two queries write the same element, so there are no atomics and no
//   separate memset: each output element is written exactly once, by one
//   thread, with a fixed order of arithmetic.  The result is deterministic
//   to the bit.
// - One block takes TQ = 32 neighbouring queries and one level (grid.y), so
//   any Q works and all levels go in one launch.  It stages the queries'
//   n*n gradient windows in shared memory (a warp reads 32 neighbouring
//   queries of one channel: 128 contiguous bytes), then streams out the
//   block's whole contiguous slice of the level, TQ*H2*W2 elements, in
//   16-byte vector stores (a scalar head and tail where the slice is not
//   16-byte aligned).  A patch cell is a gather over its <= 4 staged window
//   neighbours; every other element is a zero.
// - Per vector the thread divides once to find its query, row and column,
//   then steps along the row.  Offsets into a level are 64-bit; a block's
//   slice is checked on the host to fit 32 bits.
// - The radius is a template parameter (0..8), as in the forward.  An empty
//   level (0 rows or columns, whose pointer may be 0) is never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxRadius = 8;
constexpr int kQueriesPerBlock = 32;
constexpr int kThreads = 256;
// As in the forward: a coordinate is clamped to +-2^20 before the int
// conversion; such a window lies outside every map.
constexpr float kClamp = 1048576.f;
constexpr int kNoQuery = -(1 << 22);

struct Levels {
  void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// Per-block state: each query's patch corner and bilinear fractions.
struct Corners {
  int x0[kQueriesPerBlock];
  int y0[kQueriesPerBlock];
  float fx[kQueriesPerBlock];
  float fy[kQueriesPerBlock];
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes: 4 fp32 or 8 bf16 values, to a 16-byte aligned address.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162 h;
  h = __floats2bfloat162_rn(v[0], v[1]);
  u.x = *reinterpret_cast<unsigned*>(&h);
  h = __floats2bfloat162_rn(v[2], v[3]);
  u.y = *reinterpret_cast<unsigned*>(&h);
  h = __floats2bfloat162_rn(v[4], v[5]);
  u.z = *reinterpret_cast<unsigned*>(&h);
  h = __floats2bfloat162_rn(v[6], v[7]);
  u.w = *reinterpret_cast<unsigned*>(&h);
  *reinterpret_cast<uint4*>(p) = u;
}

// Gradient of the map element at patch cell (i, j) of query t: a gather over
// the <= 4 window outputs that read it.  0 outside the patch.
template <int R>
__device__ __forceinline__ float cell_grad(const float* g, const Corners& cs,
                                           int t, int y, int x) {
  constexpr int N = 2 * R + 1;
  constexpr int P = N + 1;
  const int i = y - cs.y0[t];
  const int j = x - cs.x0[t];
  if (static_cast<unsigned>(i) >= static_cast<unsigned>(P) ||
      static_cast<unsigned>(j) >= static_cast<unsigned>(P)) {
    return 0.f;
  }
  const float fx = cs.fx[t];
  const float fy = cs.fy[t];
  const float* gt = g + t * N * N;  // gt[a * N + b]
  float acc = 0.f;
  if (j < N) {
    if (i < N) acc += (1.f - fy) * (1.f - fx) * gt[j * N + i];
    if (i > 0) acc += fy * (1.f - fx) * gt[j * N + i - 1];
  }
  if (j > 0) {
    if (i < N) acc += (1.f - fy) * fx * gt[(j - 1) * N + i];
    if (i > 0) acc += fy * fx * gt[(j - 1) * N + i - 1];
  }
  return acc;
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
corr_lookup_backward_kernel(const float* __restrict__ coords,
                            const T* __restrict__ grad_out,
                            const __grid_constant__ Levels levels,
                            int q_total, int hw1, int num_levels) {
  constexpr int N = 2 * R + 1;
  constexpr int NN = N * N;
  constexpr int V = Vec<T>::N;
  __shared__ float g[kQueriesPerBlock * NN];  // 37 KB at r = 8
  __shared__ Corners cs;

  const int lvl = blockIdx.y;
  const int h2 = levels.h[lvl];
  const int w2 = levels.w[lvl];
  const int hw2 = h2 * w2;
  if (hw2 == 0) return;  // an empty level has nothing to write
  const int q0 = blockIdx.x * kQueriesPerBlock;
  const int nq = min(kQueriesPerBlock, q_total - q0);

  // 1. Patch corner and bilinear fractions of each query, as the forward.
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
    cs.fx[t] = fx;
    cs.fy[t] = fy;
  }

  // 2. Stage the queries' gradient windows: lane = query, warp strides
  //    channels.
  {
    const int t = threadIdx.x % kQueriesPerBlock;
    const int q = q0 + t;
    if (q < q_total) {
      const int b = q / hw1;
      const int s = q - b * hw1;
      const T* src = grad_out +
                     ((size_t)b * num_levels * NN + (size_t)lvl * NN) * hw1 +
                     s;
      for (int c = threadIdx.x / kQueriesPerBlock; c < NN;
           c += kThreads / kQueriesPerBlock) {
        g[t * NN + c] = load(src + (size_t)c * hw1);
      }
    }
  }
  __syncthreads();

  // 3. Stream out the block's slice of the level: queries q0 .. q0+nq-1,
  //    each its whole H2*W2 map, contiguous in memory.
  T* out = static_cast<T*>(levels.ptr[lvl]) + (size_t)q0 * hw2;
  const int len = nq * hw2;
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(out) / sizeof(T)) % V);
  const int head = min(len, (V - mis) % V);
  for (int e = threadIdx.x; e < head; e += kThreads) {
    const int t = e / hw2;
    const int pos = e - t * hw2;
    const int y = pos / w2;
    store1(out + e, cell_grad<R>(g, cs, t, y, pos - y * w2));
  }
  const int nvec = (len - head) / V;
  for (int k = threadIdx.x; k < nvec; k += kThreads) {
    const int e0 = head + k * V;
    int t = e0 / hw2;
    const int pos = e0 - t * hw2;
    int y = pos / w2;
    int x = pos - y * w2;
    float v[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      v[u] = cell_grad<R>(g, cs, t, y, x);
      if (++x == w2) {
        x = 0;
        if (++y == h2) {
          y = 0;
          ++t;
        }
      }
    }
    store_vec(out + e0, v);
  }
  for (int e = head + nvec * V + threadIdx.x; e < len; e += kThreads) {
    const int t = e / hw2;
    const int pos = e - t * hw2;
    const int y = pos / w2;
    store1(out + e, cell_grad<R>(g, cs, t, y, pos - y * w2));
  }
}

// Launch the instantiation for `radius`: R counts up from 0 to kMaxRadius.
template <typename T, int R = 0>
cudaError_t launch(int radius, dim3 grid, cudaStream_t st,
                   const float* coords, const T* grad_out,
                   const Levels& levels, int q_total, int hw1,
                   int num_levels) {
  if constexpr (R > kMaxRadius) {
    return cudaErrorInvalidValue;
  } else {
    if (radius != R) {
      return launch<T, R + 1>(radius, grid, st, coords, grad_out, levels,
                              q_total, hw1, num_levels);
    }
    corr_lookup_backward_kernel<T, R><<<grid, kThreads, 0, st>>>(
        coords, grad_out, levels, q_total, hw1, num_levels);
    return cudaGetLastError();
  }
}

}  // namespace

extern "C" {

// coords: (B, 2, H1, W1) fp32.  grad_out: (B, num_levels*(2r+1)^2, H1, W1)
// contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1).  grad_ptrs[l]:
// (B*H1*W1, level_h[l], level_w[l]) contiguous, in grad_out's dtype; every
// element of every non-empty level is written.  Launches on `stream`;
// returns cudaGetLastError() after the launch.
int corr_lookup_backward(const void* coords, const void* grad_out,
                         void* const* grad_ptrs, const int* level_h,
                         const int* level_w, int num_levels, int batch,
                         int h1, int w1, int radius, int is_bf16,
                         void* stream) {
  const long long q_total = static_cast<long long>(batch) * h1 * w1;
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 0 ||
      radius > kMaxRadius || q_total < 1 || q_total > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels levels;
  for (int l = 0; l < num_levels; ++l) {
    // a block's slice, kQueriesPerBlock maps, is indexed in 32 bits
    const long long hw2 = static_cast<long long>(level_h[l]) * level_w[l];
    if (level_h[l] < 0 || level_w[l] < 0 ||
        hw2 * kQueriesPerBlock >= (1LL << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    levels.ptr[l] = grad_ptrs[l];
    levels.h[l] = level_h[l];
    levels.w[l] = level_w[l];
  }
  const int hw1 = h1 * w1;
  const int q = static_cast<int>(q_total);
  const dim3 grid((q + kQueriesPerBlock - 1) / kQueriesPerBlock, num_levels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(
                    radius, grid, st, c,
                    static_cast<const __nv_bfloat16*>(grad_out), levels, q,
                    hw1, num_levels)
              : launch<float>(radius, grid, st, c,
                              static_cast<const float*>(grad_out), levels, q,
                              hw1, num_levels);
  return static_cast<int>(err);
}

}  // extern "C"
