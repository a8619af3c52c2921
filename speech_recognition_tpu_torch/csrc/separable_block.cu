// Fused separable block, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   speech_recognition_tpu/ops/pallas/experiments/separable_kernel.py::fused_separable_block
// (body `_kernel`). One DepthwiseConvBlock's convolutions in one pass, on NWC
// tensors x [B, T, Cin] -> y [B, To, Cout]:
//
//   xin = relu6(x * a + b)                      (optional prologue)
//   dw[t, c] = sum_i xin[t * stride + i - pad_lo, c] * w_dw[i, c]
//   y = dw @ w_pw                               ("fuse")
//   y = sum_i xin[t * stride + i - pad_lo] @ W_i,
//       W_i = diag(w_dw[i]) @ w_pw              ("fold", W built by the caller)
//   s1[n] = sum y[:, n], s2[n] = sum y[:, n]^2  (optional statistics)
//
// Rows of xin outside [0, T) are zero: the padding comes after the prologue,
// so a padded row is 0, not relu6(b).
//
// Rounding follows the TPU kernel, and the plain PyTorch version follows the
// same points: a and b are cast to the compute type S before the affine; the
// affine, each tap product and each running depthwise sum ("fuse") are
// rounded to S one at a time (no FMA contraction, hence __fmul_rn and
// __fadd_rn); the matrix product takes S operands and sums in f32; y is
// rounded to S before the statistics; y * y is rounded to S and summed in
// f32.
//
// Design. The TPU grid walks the batch in order and carries the statistics
// in scratch from step to step. Here the output rows are flattened to
// (b, t_out), and each block computes one 64-row x 64-column tile of y with
// 256 threads, 4 x 4 outputs each in f32 registers. It loops over Cin in
// chunks of 32: for each chunk it builds the A tile (64 rows x 32 channels)
// in shared memory straight from x (gathering the taps, applying the
// prologue, writing 0 outside [0, T)) and loads the B tile (w_pw, or W_i for
// "fold", which runs the chunk once per tap). Shared memory is 17,024 bytes
// at every shape, with no window or halo logic. Each block reduces its tile's
// column sums in shared memory and adds them to the f32 [2, Cout] statistics
// buffer with atomicAdd; the caller zeroes it first. The order of those
// additions changes from run to run, so s1 and s2 are not bit-reproducible.
//
// Bound: arithmetic. At the flagship's trunk shapes (batch 384) "fuse" does
// 2 * B * To * Cin * Cout FLOP of pointwise product, ~38 GFLOP over the 11
// shapes, and "fold" k times that, against ~0.4 GB of x and y. On the CUDA
// cores in f32 FMA, reading operands from shared memory, the kernel is bound
// by instruction issue; tensor cores (mma.sync, wgmma) with TMA loads are
// the way to the memory bound, and later work.
//
// Offsets are 32-bit: the wrapper refuses tensors of 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 64;        // output channels per block
constexpr int kBK = 32;        // input channels per chunk
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kRowsPerThread = kBM * kBK / kThreads;  // A tile loads: 8
constexpr int kColsPerThread = kBK * kBN / kThreads;  // B tile loads: 8

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename S>
__device__ __forceinline__ S from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the compute type S, held as a float.
template <typename S>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<S>(v));
}

// xin[ti, c] of the batch row starting at element `base` of x: the prologue,
// then 0 outside [0, T) and for rows or channels past the edge (ok false).
template <typename S>
__device__ __forceinline__ float load_in(const S* __restrict__ x, bool ok,
                                         int base, int ti, int t_in, int cin,
                                         int c, bool prologue, float av,
                                         float bv) {
  if (!ok || ti < 0 || ti >= t_in) return 0.0f;
  float v = to_float(x[base + ti * cin + c]);
  if (prologue) {
    v = round_to<S>(__fadd_rn(round_to<S>(__fmul_rn(v, av)), bv));
    v = fminf(fmaxf(v, 0.0f), 6.0f);
  }
  return v;
}

template <typename S, bool kFold>
__global__ void __launch_bounds__(kThreads)
separable_block_kernel(const S* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ b,
                       const S* __restrict__ w_dw,  // [k, Cin]
                       const S* __restrict__ w,     // [(k,) Cin, Cout]
                       S* __restrict__ y,           // [B * To, Cout]
                       float* __restrict__ stats,   // [2, Cout] or null
                       int batch, int t_in, int cin, int cout, int k,
                       int stride, int pad_lo, int t_out) {
  __shared__ float As[kBK][kBM + 1];  // [channel][row], padded: no conflicts
  __shared__ float Bs[kBK][kBN];
  __shared__ float s1s[kBN];
  __shared__ float s2s[kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx + 16 j
  const int ty = tid / 16;  // output rows ty + 16 i
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int rows = batch * t_out;
  const bool prologue = a != nullptr;

  // The A tile rows this thread loads: lr0 + 8 r, for channel lc of a chunk.
  const int lc = tid % kBK;
  const int lr0 = tid / kBK;
  int row_base[kRowsPerThread];  // b * T * Cin, or -1 past the last row
  int row_t0[kRowsPerThread];    // t * stride - pad_lo
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int m = m0 + lr0 + 8 * r;
    if (m < rows) {
      row_base[r] = (m / t_out) * t_in * cin;
      row_t0[r] = (m % t_out) * stride - pad_lo;
    } else {
      row_base[r] = -1;
      row_t0[r] = 0;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int c0 = 0; c0 < cin; c0 += kBK) {
    const int c = c0 + lc;
    const bool c_ok = c < cin;
    float av = 0.0f, bv = 0.0f;
    if (prologue && c_ok) {
      av = round_to<S>(a[c]);
      bv = round_to<S>(b[c]);
    }
    const int passes = kFold ? k : 1;
    for (int pass = 0; pass < passes; ++pass) {
      __syncthreads();  // the previous tiles are no longer read
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const bool ok = c_ok && row_base[r] >= 0;
        float v = 0.0f;
        if (kFold) {
          v = load_in<S>(x, ok, row_base[r], row_t0[r] + pass, t_in, cin, c,
                         prologue, av, bv);
        } else {
          for (int tap = 0; tap < k; ++tap) {
            const float xv = load_in<S>(x, ok, row_base[r], row_t0[r] + tap,
                                        t_in, cin, c, prologue, av, bv);
            const float wv = c_ok ? to_float(w_dw[tap * cin + c]) : 0.0f;
            const float term = round_to<S>(__fmul_rn(xv, wv));
            v = tap == 0 ? term : round_to<S>(__fadd_rn(v, term));
          }
        }
        As[lc][lr0 + 8 * r] = v;
      }
      const S* wk = w + static_cast<int64_t>(pass) * cin * cout;
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) {
        const int kk = tid / kBN + (kThreads / kBN) * q;
        const int nn = tid % kBN;
        const int ci = c0 + kk, n = n0 + nn;
        Bs[kk][nn] =
            (ci < cin && n < cout) ? to_float(wk[ci * cout + n]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        float ar[4], br[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ar[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) br[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
  }

  // Epilogue: round y to S, store it, and add it into the statistics.
  if (stats != nullptr && tid < kBN) {
    s1s[tid] = 0.0f;
    s2s[tid] = 0.0f;
  }
  __syncthreads();
  float part1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float part2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= cout) continue;
      const S yv = from_float<S>(acc[i][j]);
      y[m * cout + n] = yv;
      const float yf = to_float(yv);
      part1[j] += yf;
      part2[j] += round_to<S>(__fmul_rn(yf, yf));
    }
  }
  if (stats == nullptr) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    atomicAdd(&s1s[tx + 16 * j], part1[j]);
    atomicAdd(&s2s[tx + 16 * j], part2[j]);
  }
  __syncthreads();
  if (tid < kBN && n0 + tid < cout) {
    atomicAdd(&stats[n0 + tid], s1s[tid]);
    atomicAdd(&stats[cout + n0 + tid], s2s[tid]);
  }
}

template <typename S>
int launch(const void* x, const void* a, const void* b, const void* w_dw,
           const void* w, void* y, void* stats, int64_t batch, int64_t t_in,
           int64_t cin, int64_t cout, int64_t k, int64_t stride,
           int64_t pad_lo, int64_t t_out, int fold, void* stream) {
  const int64_t rows = batch * t_out;
  if (rows == 0 || cout == 0) return 0;
  const dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM),
                  static_cast<unsigned>((cout + kBN - 1) / kBN));
  auto kernel = fold ? separable_block_kernel<S, true>
                     : separable_block_kernel<S, false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const S*>(w_dw),
      static_cast<const S*>(w), static_cast<S*>(y), static_cast<float*>(stats),
      static_cast<int>(batch), static_cast<int>(t_in), static_cast<int>(cin),
      static_cast<int>(cout), static_cast<int>(k), static_cast<int>(stride),
      static_cast<int>(pad_lo), static_cast<int>(t_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes: every pointer and the stream as void*,
// sizes as int64, `fold` 0 or 1. `a` and `b` are f32 [Cin] or both null (no
// prologue); `stats` is a zeroed f32 [2, Cout] or null (no statistics).
// `w_dw`, `w`, `x` and `y` are in the entry's compute type. They return
// cudaGetLastError() after the launch (0 when the launch was accepted).
extern "C" int separable_block_bf16(const void* x, const void* a, const void* b,
                                    const void* w_dw, const void* w, void* y,
                                    void* stats, int64_t batch, int64_t t_in,
                                    int64_t cin, int64_t cout, int64_t k,
                                    int64_t stride, int64_t pad_lo,
                                    int64_t t_out, int fold, void* stream) {
  return launch<__nv_bfloat16>(x, a, b, w_dw, w, y, stats, batch, t_in, cin,
                               cout, k, stride, pad_lo, t_out, fold, stream);
}

extern "C" int separable_block_f32(const void* x, const void* a, const void* b,
                                   const void* w_dw, const void* w, void* y,
                                   void* stats, int64_t batch, int64_t t_in,
                                   int64_t cin, int64_t cout, int64_t k,
                                   int64_t stride, int64_t pad_lo,
                                   int64_t t_out, int fold, void* stream) {
  return launch<float>(x, a, b, w_dw, w, y, stats, batch, t_in, cin, cout, k,
                       stride, pad_lo, t_out, fold, stream);
}

extern "C" const char* separable_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
