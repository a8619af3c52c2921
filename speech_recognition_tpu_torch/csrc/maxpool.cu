// Max pooling along a tensor's last axis for Hopper (sm_90a), forward and
// backward, with the gradient of a chain of torch.maximum: one launch a
// direction.
//
// Replaces no TPU kernel: the JAX package pools with a chain of jnp.maximum
// over strided slices (speech_recognition_tpu/models/layers.py
// _max_pool_axis), which XLA fuses. The port ran the same chain eagerly on
// the card (models/layers.py _max_pool_axis, the CPU path still): a -inf
// pad, pool - 1 torch.maximum over strided views, and autograd's
// derivative of each: 33 device activities a pool and step, most of them
// ATen's strided elementwise kernels.
//
// x is [R, T] contiguous: every leading axis flattened into rows. Window o
// of row r covers the taps v_j = x[r, o s - left + j], j = 0 .. pool - 1,
// a tap outside [0, T) being -inf (the pad). For SAME the wrapper passes
// left = total // 2 and out = ceil(T / s), for VALID left = 0.
//
//   forward:   m_0 = v_0,  m_j = maximum(m_{j-1}, v_j),  y[r, o] = m_{pool-1}
//              maximum(m, v): NaN where either side is NaN
//   backward:  torch.maximum's derivative, from the last tap back: with g
//              reaching m_j, v_j gets g where v_j > m_{j-1}, 0 where
//              v_j < m_{j-1}, g/2 where they are equal, and m_{j-1} gets
//              g, 0, g/2 likewise (both get g where either is NaN); tap 0
//              gets what reaches m_0. So tap i of a window gets
//              w_i dy[r, o], w_i a product of 1, 1/2 and 0: a three-way
//              tie in a window of 3 gives 1/4, 1/4, 1/2. A pad tap's share
//              is dropped.
//
// Bound: bytes. The function has to read x and write y forward, read x and
// dy and write dx backward (6 T + 4 out bytes a row in bf16). Each output
// (forward) and each input position (backward) is written by one thread
// once, so there are no atomics, no zero fill and no host sync, and a
// launch gives the same bits every time. What the card measured set the
// backward's design: one thread a position, recomputing from x each of the
// windows that cover it, read 23-33 % of the bytes whether or not its loads
// were all made first (so, likely, its instructions held it: 3 chains and 8
// loads a position); computing each window once read 37-46 %.
//
// 1. Forward (maxpool1d_fw_kernel): a thread takes kPerThread outputs of
//    the flattened [R, out], kThreads apart, so that a warp's loads of a tap
//    and its stores lie side by side in memory (the overlap of neighbouring
//    windows comes from L1); it loads every tap of them before the first
//    comparison.
// 2. Backward (maxpool1d_bw_kernel), by gathering, for a block's kTile
//    positions of the flattened [R, T]: first each window that covers one
//    of them, once (a run of at most kTile + pool - 1 windows of the
//    flattened [R, out], whatever T is), recomputes its chain from x and
//    stores w_i dy for each tap in shared memory (0 where w_i is); then each
//    position adds its windows' shares in the order of its tap index there,
//    in f32, and writes dx once in x's dtype. Recomputing reads x once more
//    than the forward does; a one-byte code per output saved by the forward
//    would read and write out bytes instead (4-5 % fewer bytes at the
//    benchmark's shapes), but holds the comparisons of at most five taps.
//
// One algorithm a direction for every window: the pool is compiled in, for
// each pool up to kMaxPool, so that a window's taps live in registers and
// its chain is unrolled; the stride, the padding and T are read at run
// time. (Pool and stride both read at run time, the taps past the pool
// -inf, took one step's pools from 0.77 to 1.31 ms at xception's shapes on
// an H100, the backward from 0.55 to 1.03.) The wrapper refuses a longer
// window, and the model layer pools it by the chain.
//
// maximum is PTX's max.NaN: the chain's value, NaN where either side is one
// (the NaN's payload and the sign of a zero that ties are not pinned).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kPerThread = 4;     // elements a thread, kThreads apart
constexpr int kTile = kThreads * kPerThread;
constexpr int kMaxPool = 5;       // the longest window the kernels take

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename X>
__device__ __forceinline__ X from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// n / d for 0 <= n, d < 2^31 by a multiply and a shift (the magic number
// of Granlund and Montgomery, as PyTorch's IntDivider computes it)
struct Div {
  uint32_t m, s;
  __device__ int operator()(int n) const {
    return static_cast<int>(
        (__umulhi(static_cast<uint32_t>(n), m) + static_cast<uint32_t>(n)) >> s);
  }
};

Div make_div(uint32_t d) {
  Div v;
  for (v.s = 0; v.s < 32; ++v.s) {
    if ((1u << v.s) >= d) break;
  }
  const uint64_t one = 1;
  v.m = static_cast<uint32_t>(((one << 32) * ((one << v.s) - d)) / d + 1);
  return v;
}

struct Window {
  int rows, steps, outs;          // R, T, out
  int pool, stride, left;
  Div by_steps, by_outs, by_stride;
};

// tap p of a row: x, or -inf outside [0, T)
template <typename X>
__device__ __forceinline__ float tap(const X* __restrict__ row, int p,
                                     int steps) {
  return p >= 0 && p < steps ? to_f(row[p]) : __int_as_float(0xff800000);
}

// torch.maximum(m, v)'s value: NaN if either is (one instruction)
__device__ __forceinline__ float maximum(float m, float v) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), "f"(v));
  return r;
}

// The weights of a window's P taps v[0..P) (the tap's share of the
// window's cotangent; see the head of this file): from the front, the
// factors of the running maximum (fm) and of the tap (fv) at each step,
// then each tap's factor times those of every later step.
template <int P>
__device__ __forceinline__ void window_weights(const float* v, float* w) {
  float m = v[0], fm[P], fv[P];
#pragma unroll
  for (int j = 1; j < P; ++j) {
    fm[j] = m == v[j] ? 0.5f : (m < v[j] ? 0.f : 1.f);
    fv[j] = m == v[j] ? 0.5f : (m > v[j] ? 0.f : 1.f);
    m = maximum(m, v[j]);
  }
  float later = 1.f;
#pragma unroll
  for (int i = P - 1; i > 0; --i) {
    w[i] = fv[i] * later;
    later *= fm[i];
  }
  w[0] = later;
}

// P: the pool (w.pool)
template <typename X, int P>
__global__ void __launch_bounds__(kThreads)
maxpool1d_fw_kernel(const X* __restrict__ x, X* __restrict__ y,
                    const Window w) {
  const int n = w.rows * w.outs;
  const int q0 = blockIdx.x * kTile + threadIdx.x;
  // every tap of the thread's outputs loaded before any comparison
  float v[kPerThread][P];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int q = min(q0 + u * kThreads, n - 1);
    const int r = w.by_outs(q), o = q - r * w.outs;
    const X* row = x + static_cast<int64_t>(r) * w.steps;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      v[u][j] = tap(row, o * w.stride - w.left + j, w.steps);
    }
  }
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int q = q0 + u * kThreads;
    float m = v[u][0];
#pragma unroll
    for (int j = 1; j < P; ++j) m = maximum(m, v[u][j]);
    if (q < n) y[q] = from_f<X>(m);
  }
}

// 1. each window that covers one of the block's positions, once: its taps'
//    weights times its cotangent, into shared memory; 2. each position's
//    sum over its windows, in the order of its tap index there. The
//    windows of a block's positions are a run of the flattened [R, out],
//    at most kTile + P - 1 long whatever T is.
template <typename X, int P>
__global__ void __launch_bounds__(kThreads)
maxpool1d_bw_kernel(const X* __restrict__ x, const X* __restrict__ dy,
                    X* __restrict__ dx, const Window w) {
  constexpr int kWindows = kTile + P - 1;
  __shared__ float share[kWindows * P];
  const int n = w.rows * w.steps, S = w.stride;
  const int first = blockIdx.x * kTile, last = min(first + kTile, n) - 1;
  int qa, nw;
  {
    const int r = w.by_steps(first), a = first - r * w.steps + w.left;
    const int lo = a < P - 1 ? 0 : w.by_stride(a - P + S);
    qa = r * w.outs + min(lo, w.outs);
    const int r1 = w.by_steps(last), a1 = last - r1 * w.steps + w.left;
    nw = min(r1 * w.outs + min(w.by_stride(a1), w.outs - 1) - qa + 1,
             kWindows);
  }
  for (int wi = threadIdx.x; wi < nw; wi += kThreads) {
    const int q = qa + wi, r = w.by_outs(q), o = q - r * w.outs;
    const X* row = x + static_cast<int64_t>(r) * w.steps;
    float v[P], wt[P];
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] = tap(row, o * S - w.left + j, w.steps);
    const float g = to_f(dy[q]);
    window_weights<P>(v, wt);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      share[wi * P + i] = wt[i] == 0.f ? 0.f : wt[i] * g;
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int p = first + threadIdx.x + u * kThreads;
    if (p < n) {
      const int r = w.by_steps(p), a = p - r * w.steps + w.left;
      const int q = w.by_stride(a), rem = a - q * S;
      const int c = (r * w.outs + q - qa) * P + rem;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        // window q - k, tap rem + k S
        if (rem + k * S < P && q - k >= 0 && q - k < w.outs) {
          acc += share[c + k * (S - P)];
        }
      }
      dx[p] = from_f<X>(acc);
    }
  }
}

// ---- launches -----------------------------------------------------------------

constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);
// the flattened sizes the kernels' 32-bit positions take, with a block's
// worth of room
constexpr int64_t kMaxElements = (int64_t(1) << 31) - kTile;

bool window(int64_t rows, int64_t steps, int64_t outs, int64_t pool,
            int64_t stride, int64_t left, Window* w) {
  if (rows < 1 || steps < 1 || outs < 1 || pool < 1 || pool > kMaxPool ||
      stride < 1 || left < 0 || left >= pool || rows * steps > kMaxElements ||
      rows * outs > kMaxElements || (outs - 1) * stride + pool > kMaxElements) {
    return false;
  }
  w->rows = static_cast<int>(rows);
  w->steps = static_cast<int>(steps);
  w->outs = static_cast<int>(outs);
  w->pool = static_cast<int>(pool);
  w->stride = static_cast<int>(stride);
  w->left = static_cast<int>(left);
  w->by_steps = make_div(static_cast<uint32_t>(steps));
  w->by_outs = make_div(static_cast<uint32_t>(outs));
  w->by_stride = make_div(static_cast<uint32_t>(stride));
  return true;
}

unsigned blocks(int64_t n) {
  return static_cast<unsigned>((n + kTile - 1) / kTile);
}

template <typename X, int P>
int fw_launch(const Window& w, const void* x, void* y, cudaStream_t s) {
  maxpool1d_fw_kernel<X, P>
      <<<blocks(int64_t(w.rows) * w.outs), kThreads, 0, s>>>(
          static_cast<const X*>(x), static_cast<X*>(y), w);
  return static_cast<int>(cudaGetLastError());
}

template <typename X, int P>
int bw_launch(const Window& w, const void* x, const void* dy, void* dx,
              cudaStream_t s) {
  maxpool1d_bw_kernel<X, P>
      <<<blocks(int64_t(w.rows) * w.steps), kThreads, 0, s>>>(
          static_cast<const X*>(x), static_cast<const X*>(dy),
          static_cast<X*>(dx), w);
  return static_cast<int>(cudaGetLastError());
}

#define MAXPOOL_BY_POOL(pool, FN, ...)                  \
  switch (pool) {                                       \
    case 1: return FN<X, 1>(__VA_ARGS__);               \
    case 2: return FN<X, 2>(__VA_ARGS__);               \
    case 3: return FN<X, 3>(__VA_ARGS__);               \
    case 4: return FN<X, 4>(__VA_ARGS__);               \
    case 5: return FN<X, 5>(__VA_ARGS__);               \
    default: return kBad;                               \
  }

template <typename X>
int fw(const Window& w, const void* x, void* y, cudaStream_t s) {
  MAXPOOL_BY_POOL(w.pool, fw_launch, w, x, y, s)
}

template <typename X>
int bw(const Window& w, const void* x, const void* dy, void* dx,
       cudaStream_t s) {
  MAXPOOL_BY_POOL(w.pool, bw_launch, w, x, dy, dx, s)
}

}  // namespace

// The C interface. dtype: 0 float32, 1 bfloat16, 2 float16 (x, y, dy and
// dx alike); x [rows, steps] and dx, y and dy [rows, outs], contiguous.
// The wrapper (ops/kernels/maxpool.py) checks devices, dtypes, shapes and
// contiguity, works out outs and left from the padding and allocates y and
// dx. Each entry returns cudaGetLastError() after its launch (0 when it was
// taken), or cudaErrorInvalidValue for a shape or dtype it does not take.

#define MAXPOOL_BY_DTYPE(dtype, FN, ...)                \
  switch (dtype) {                                      \
    case 0: return FN<float>(__VA_ARGS__);              \
    case 1: return FN<bf16>(__VA_ARGS__);               \
    case 2: return FN<__half>(__VA_ARGS__);             \
    default: return kBad;                               \
  }

extern "C" int maxpool1d_fw(int dtype, const void* x, void* y, int64_t rows,
                            int64_t steps, int64_t outs, int64_t pool,
                            int64_t stride, int64_t left, void* stream) {
  Window w;
  if (!window(rows, steps, outs, pool, stride, left, &w)) return kBad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  MAXPOOL_BY_DTYPE(dtype, fw, w, x, y, s)
}

extern "C" int maxpool1d_bw(int dtype, const void* x, const void* dy,
                            void* dx, int64_t rows, int64_t steps,
                            int64_t outs, int64_t pool, int64_t stride,
                            int64_t left, void* stream) {
  Window w;
  if (!window(rows, steps, outs, pool, stride, left, &w)) return kBad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  MAXPOOL_BY_DTYPE(dtype, bw, w, x, dy, dx, s)
}

extern "C" const char* maxpool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
