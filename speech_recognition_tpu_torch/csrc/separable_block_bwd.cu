// Fused separable block, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   speech_recognition_tpu/ops/pallas/experiments/separable_kernel.py::_fused_block_bwd_pallas
// (body `_bwd_kernel`), the backward of csrc/separable_block.cu. From the
// block's input x [B, T, Cin], its rounded output y [B, To, Cout] and the
// cotangents dy, ds1, ds2 of (y, s1 = sum y, s2 = sum y^2) it computes, in the
// compute type S (bf16 or f32), with xp the zero-padded relu6(x * a + b):
//
//   dyt = dy + ds1 + 2 y ds2                     (f32, rounded to S once)
//   dw[t, c] = sum_i xp[t * stride + i, c] * w_dw[i, c]      (recomputed)
//   dw_pw = dw^T @ dyt                           [Cin, Cout], f32
//   ddw = dyt @ w_pw^T                           [B * To, Cin], rounded to S
//   dw_dw[i, c] = sum_rows xp[t * stride + i, c] * ddw[t, c]  f32
//   dxp[t * stride + i] += ddw[t] * w_dw[i]      (taps in ascending order)
//   dpre = dxp[pad_lo + ti] where 0 < x * a + b < 6, else 0
//   dx = dpre * a,  da = sum dpre * x,  db = sum dpre         (f32 sums)
//
// Without the prologue (a and b null) dx = dxp[pad_lo + ti] and da, db are
// not computed. Padded input rows that no tap reads (VALID with T - k odd at
// stride 2) get dx = 0.
//
// Rounding follows the TPU kernel, as the plain PyTorch version
// (ops/kernels/separable_block.py::separable_block_bwd_plain) does: the
// depthwise output is recomputed with the forward's "fuse" chain (each tap
// product and running sum rounded to S) whatever variant ran forward; dyt is
// formed in f32 in the order (dy + ds1) + (2 y) ds2 and rounded once; the two
// matrix products take S operands and sum in f32; ddw is rounded to S; every
// product that is summed (xp * ddw, dpre * x) is rounded to S first; each tap
// piece ddw * w_dw[i] and each running sum of dxp is rounded to S; the relu6
// mask is strict (no gradient where x * a + b is exactly 0 or 6). __fmul_rn
// and __fadd_rn keep nvcc from contracting any of these into an FMA.
//
// Design. Three launches on the caller's stream, where the TPU kernel walks
// the batch in order and carries its sums in scratch from step to step:
//
//  (a) ddw_kernel: 64 x 64 tiles of ddw [B * To rows, Cin] with 256 threads,
//      4 x 4 f32 accumulators each, the K loop over Cout in chunks of 32 (the
//      forward's tiling). The A tile is dyt, formed from dy and y as it is
//      loaded; the B tile is w_pw read transposed. The epilogue stores ddw
//      rounded to S in a scratch buffer the caller allocates, then gathers the
//      k tap rows of xp for its tile (prologue applied, 0 outside [0, T)) and
//      adds the dw_dw partials into the f32 sums through shared memory and
//      atomicAdd.
//  (b) dwpw_kernel: 64 x 64 tiles of dw_pw [Cin, Cout], the reduction over
//      rows split into slices of 1,024 rows, one block per (slice, tile). The
//      A tile is dw, recomputed from x with the fuse chain as the forward's
//      "fuse" gathers it; the B tile is dyt. Each block adds its tile into the
//      f32 sums with atomicAdd.
//  (c) dx_kernel: one thread per (b, ti, c), c along the warp so that loads of
//      ddw and x and stores of dx are coalesced. It sums the tap pieces that
//      reach its row, applies the mask, writes dx, and adds its da, db
//      partials through shared memory and atomicAdd.
//
// The caller zeroes the f32 sums [dw_dw (k * Cin) | dw_pw (Cin * Cout) | da
// (Cin) | db (Cin)] first. Atomics add in an order that changes from run to
// run, so the four sums are not bit-reproducible.
//
// Bound: arithmetic. (a) and (b) each do 2 * B * To * Cin * Cout FLOP, as
// much as the forward's "fuse", in f32 FMA on the CUDA cores with both
// operands read from shared memory, so the kernel is bound by instruction
// issue; (b) also rebuilds the depthwise chain for every 64-column tile of
// Cout, as "fuse" does. ddw makes one round trip through device memory.
// Tensor cores (mma.sync, wgmma), TMA and keeping ddw on chip are later work.
//
// Offsets are 32-bit: the wrapper refuses tensors of 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBM = 64;           // tile rows (ddw: rows; dw_pw: channels)
constexpr int kBN = 64;           // tile columns (ddw: channels; dw_pw: Cout)
constexpr int kBK = 32;           // reduction chunk (ddw: Cout; dw_pw: rows)
constexpr int kThreads = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int kSliceRows = 1024;  // rows of the dw_pw reduction per block
constexpr int kPwLanes = kThreads / kBM;      // dw_pw: rows loaded at once: 4
constexpr int kDxCols = 64;       // dx_kernel: channels per block
constexpr int kDxLanes = kThreads / kDxCols;  // rows processed at once: 4
constexpr int kDxRows = 64;       // dx_kernel: input rows per block

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

// x * a + b with each operation rounded to S (the prologue's argument).
template <typename S>
__device__ __forceinline__ float affine(float v, float av, float bv) {
  return round_to<S>(__fadd_rn(round_to<S>(__fmul_rn(v, av)), bv));
}

// xp[ti, c] of the batch row starting at element `base` of x: the prologue,
// then 0 outside [0, T) and for rows or channels past the edge (ok false).
// The same gather as the forward's.
template <typename S>
__device__ __forceinline__ float load_in(const S* __restrict__ x, bool ok,
                                         int base, int ti, int t_in, int cin,
                                         int c, bool prologue, float av,
                                         float bv) {
  if (!ok || ti < 0 || ti >= t_in) return 0.0f;
  float v = to_float(x[base + ti * cin + c]);
  if (prologue) v = fminf(fmaxf(affine<S>(v, av, bv), 0.0f), 6.0f);
  return v;
}

// dyt at element `idx` of dy and y, for output channel n (ds1n, ds2n).
template <typename S, typename D>
__device__ __forceinline__ float load_dyt(const D* __restrict__ dy,
                                          const S* __restrict__ y, int idx,
                                          float ds1n, float ds2n) {
  const float yv = to_float(y[idx]);
  return round_to<S>(__fadd_rn(__fadd_rn(to_float(dy[idx]), ds1n),
                               __fmul_rn(__fmul_rn(2.0f, yv), ds2n)));
}

// (a) ddw = dyt @ w_pw^T, rounded to S and stored; dw_dw partials.
template <typename S, typename D>
__global__ void __launch_bounds__(kThreads)
ddw_kernel(const S* __restrict__ x, const float* __restrict__ a,
           const float* __restrict__ b, const S* __restrict__ w_pw,  // [Cin, Cout]
           const S* __restrict__ y, const D* __restrict__ dy,
           const float* __restrict__ ds1, const float* __restrict__ ds2,
           S* __restrict__ ddw,                   // [B * To, Cin]
           float* __restrict__ dwdw,              // [k, Cin], zeroed
           int batch, int t_in, int cin, int cout, int k, int stride,
           int pad_lo, int t_out) {
  __shared__ float As[kBK][kBM + 1];  // dyt [n][row]
  __shared__ float Bs[kBK][kBN + 1];  // w_pw [n][channel], padded: no conflicts
  __shared__ float part[kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channels c0 + tx + 16 j
  const int ty = tid / 16;  // rows m0 + ty + 16 i
  const int m0 = blockIdx.x * kBM;
  const int c0 = blockIdx.y * kBN;
  const int rows = batch * t_out;
  const bool prologue = a != nullptr;

  // tile loads: column lk of a chunk, rows (or channels) lr0 + 8 r
  const int lk = tid % kBK;
  const int lr0 = tid / kBK;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int n0 = 0; n0 < cout; n0 += kBK) {
    const int n = n0 + lk;
    const bool n_ok = n < cout;
    const float ds1n = n_ok ? ds1[n] : 0.0f;
    const float ds2n = n_ok ? ds2[n] : 0.0f;
    __syncthreads();  // the previous tiles are no longer read
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = m0 + lr0 + 8 * r;
      As[lk][lr0 + 8 * r] =
          (n_ok && m < rows) ? load_dyt<S, D>(dy, y, m * cout + n, ds1n, ds2n)
                             : 0.0f;
      const int c = c0 + lr0 + 8 * r;
      Bs[lk][lr0 + 8 * r] =
          (n_ok && c < cin) ? to_float(w_pw[c * cout + n]) : 0.0f;
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

  // Epilogue: ddw rounded to S and stored, then the dw_dw partials.
  int base[4], t0[4];  // row i: b * T * Cin (-1 past the last row), t * s - lo
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    base[i] = m < rows ? (m / t_out) * t_in * cin : -1;
    t0[i] = m < rows ? (m % t_out) * stride - pad_lo : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      const S v = from_float<S>(acc[i][j]);
      if (m < rows && c < cin) ddw[m * cin + c] = v;
      acc[i][j] = to_float(v);
    }
  }
  float av[4], bv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + tx + 16 * j;
    av[j] = (prologue && c < cin) ? round_to<S>(a[c]) : 0.0f;
    bv[j] = (prologue && c < cin) ? round_to<S>(b[c]) : 0.0f;
  }
  for (int tap = 0; tap < k; ++tap) {
    __syncthreads();  // the previous tap's sums are read
    if (tid < kBN) part[tid] = 0.0f;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = load_in<S>(x, base[i] >= 0 && c < cin, base[i],
                                    t0[i] + tap, t_in, cin, c, prologue,
                                    av[j], bv[j]);
        s = __fadd_rn(s, round_to<S>(__fmul_rn(xv, acc[i][j])));
      }
      atomicAdd(&part[tx + 16 * j], s);
    }
    __syncthreads();
    if (tid < kBN && c0 + tid < cin) atomicAdd(&dwdw[tap * cin + c0 + tid],
                                               part[tid]);
  }
}

// (b) dw_pw = dw^T @ dyt over one slice of rows, added into the sums.
template <typename S, typename D>
__global__ void __launch_bounds__(kThreads)
dwpw_kernel(const S* __restrict__ x, const float* __restrict__ a,
            const float* __restrict__ b, const S* __restrict__ w_dw,  // [k, Cin]
            const S* __restrict__ y, const D* __restrict__ dy,
            const float* __restrict__ ds1, const float* __restrict__ ds2,
            float* __restrict__ dwpw,             // [Cin, Cout], zeroed
            int batch, int t_in, int cin, int cout, int k, int stride,
            int pad_lo, int t_out) {
  __shared__ float As[kBK][kBM + 1];  // dw [row][channel]
  __shared__ float Bs[kBK][kBN + 1];  // dyt [row][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns n0 + tx + 16 j
  const int ty = tid / 16;  // channels c0 + ty + 16 i
  const int r_begin = blockIdx.x * kSliceRows;
  const int c0 = blockIdx.y * kBM;
  const int n0 = blockIdx.z * kBN;
  const int rows = batch * t_out;
  const int r_end = min(rows, r_begin + kSliceRows);
  const bool prologue = a != nullptr;

  // tile loads: channel (A) and column (B) lc, rows lk0 + 4 q of a chunk
  const int lc = tid % kBM;
  const int lk0 = tid / kBM;
  const int c = c0 + lc;
  const bool c_ok = c < cin;
  const float av = (prologue && c_ok) ? round_to<S>(a[c]) : 0.0f;
  const float bv = (prologue && c_ok) ? round_to<S>(b[c]) : 0.0f;
  const int n = n0 + lc;
  const bool n_ok = n < cout;
  const float ds1n = n_ok ? ds1[n] : 0.0f;
  const float ds2n = n_ok ? ds2[n] : 0.0f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int r0 = r_begin; r0 < r_end; r0 += kBK) {
    __syncthreads();  // the previous tiles are no longer read
#pragma unroll
    for (int q = 0; q < kBK / kPwLanes; ++q) {
      const int kk = lk0 + kPwLanes * q;
      const int m = r0 + kk;
      const bool row_ok = m < r_end;
      float v = 0.0f;
      if (row_ok && c_ok) {
        const int base = (m / t_out) * t_in * cin;
        const int t0 = (m % t_out) * stride - pad_lo;
        for (int tap = 0; tap < k; ++tap) {
          const float xv = load_in<S>(x, true, base, t0 + tap, t_in, cin, c,
                                      prologue, av, bv);
          const float term =
              round_to<S>(__fmul_rn(xv, to_float(w_dw[tap * cin + c])));
          v = tap == 0 ? term : round_to<S>(__fadd_rn(v, term));
        }
      }
      As[kk][lc] = v;
      Bs[kk][lc] = (row_ok && n_ok)
                       ? load_dyt<S, D>(dy, y, m * cout + n, ds1n, ds2n)
                       : 0.0f;
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = c0 + ty + 16 * i;
    if (ci >= cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nj = n0 + tx + 16 * j;
      if (nj < cout) atomicAdd(&dwpw[ci * cout + nj], acc[i][j]);
    }
  }
}

// (c) dx from ddw (the transposed depthwise conv and the relu6 mask); da, db.
template <typename S>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const S* __restrict__ x, const float* __restrict__ a,
          const float* __restrict__ b, const S* __restrict__ w_dw,  // [k, Cin]
          const S* __restrict__ ddw,             // [B * To, Cin]
          S* __restrict__ dx,                    // [B, T, Cin]
          float* __restrict__ dadb,              // [2, Cin], zeroed
          int batch, int t_in, int cin, int k, int stride, int pad_lo,
          int t_out) {
  __shared__ float red[2][kDxLanes][kDxCols];

  const int tid = threadIdx.x;
  const int lc = tid % kDxCols;
  const int lane = tid / kDxCols;
  const int c = blockIdx.y * kDxCols + lc;
  const int rows = batch * t_in;
  const int r0 = blockIdx.x * kDxRows;
  const bool prologue = a != nullptr;
  const bool c_ok = c < cin;
  const float av = (prologue && c_ok) ? round_to<S>(a[c]) : 0.0f;
  const float bv = (prologue && c_ok) ? round_to<S>(b[c]) : 0.0f;

  float da = 0.0f, db = 0.0f;
  for (int r = r0 + lane; c_ok && r < min(rows, r0 + kDxRows);
       r += kDxLanes) {
    const int bb = r / t_in;
    const int p = r % t_in + pad_lo;  // the row of the padded input
    float dxp = 0.0f;
    for (int tap = 0; tap < k && p - tap >= 0; ++tap) {
      const int q = p - tap;
      if (q % stride != 0 || q / stride >= t_out) continue;
      const float dv = to_float(ddw[(bb * t_out + q / stride) * cin + c]);
      const float piece =
          round_to<S>(__fmul_rn(dv, to_float(w_dw[tap * cin + c])));
      dxp = round_to<S>(__fadd_rn(dxp, piece));
    }
    if (!prologue) {
      dx[r * cin + c] = from_float<S>(dxp);
      continue;
    }
    const float xv = to_float(x[r * cin + c]);
    const float pre = affine<S>(xv, av, bv);
    const float dpre = (pre > 0.0f && pre < 6.0f) ? dxp : 0.0f;
    dx[r * cin + c] = from_float<S>(__fmul_rn(dpre, av));
    da = __fadd_rn(da, round_to<S>(__fmul_rn(dpre, xv)));
    db = __fadd_rn(db, dpre);
  }
  if (!prologue) return;
  red[0][lane][lc] = da;
  red[1][lane][lc] = db;
  __syncthreads();
  if (lane < 2 && c_ok) {
    float s = 0.0f;
#pragma unroll
    for (int l = 0; l < kDxLanes; ++l) s = __fadd_rn(s, red[lane][l][lc]);
    atomicAdd(&dadb[lane * cin + c], s);
  }
}

int div_up(int64_t n, int64_t d) { return static_cast<int>((n + d - 1) / d); }

template <typename S, typename D>
int launch(const void* x, const void* a, const void* b, const void* w_dw,
           const void* w_pw, const void* y, const void* dy, const void* ds1,
           const void* ds2, void* dx, void* ddw, void* sums, int64_t batch,
           int64_t t_in, int64_t cin, int64_t cout, int64_t k, int64_t stride,
           int64_t pad_lo, int64_t t_out, cudaStream_t stream) {
  const int64_t rows = batch * t_out;
  if (batch == 0 || cin == 0) return 0;
  const S* xs = static_cast<const S*>(x);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const S* wdw = static_cast<const S*>(w_dw);
  const S* ys = static_cast<const S*>(y);
  const D* dys = static_cast<const D*>(dy);
  const float* ds1f = static_cast<const float*>(ds1);
  const float* ds2f = static_cast<const float*>(ds2);
  S* ddws = static_cast<S*>(ddw);
  float* dwdw = static_cast<float*>(sums);
  float* dwpw = dwdw + k * cin;
  float* dadb = dwpw + cin * cout;
  const int bi = static_cast<int>(batch), ti = static_cast<int>(t_in),
            ci = static_cast<int>(cin), co = static_cast<int>(cout),
            ki = static_cast<int>(k), si = static_cast<int>(stride),
            lo = static_cast<int>(pad_lo), to = static_cast<int>(t_out);

  ddw_kernel<S, D><<<dim3(div_up(rows, kBM), div_up(cin, kBN)), kThreads, 0,
                     stream>>>(xs, af, bf, static_cast<const S*>(w_pw), ys,
                               dys, ds1f, ds2f, ddws, dwdw, bi, ti, ci, co, ki,
                               si, lo, to);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cout > 0) {
    dwpw_kernel<S, D><<<dim3(div_up(rows, kSliceRows), div_up(cin, kBM),
                             div_up(cout, kBN)),
                        kThreads, 0, stream>>>(xs, af, bf, wdw, ys, dys, ds1f,
                                               ds2f, dwpw, bi, ti, ci, co, ki,
                                               si, lo, to);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dx_kernel<S><<<dim3(div_up(batch * t_in, kDxRows), div_up(cin, kDxCols)),
                 kThreads, 0, stream>>>(xs, af, bf, wdw, ddws,
                                        static_cast<S*>(dx), dadb, bi, ti, ci,
                                        ki, si, lo, to);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes: every pointer and the stream as void*,
// sizes as int64. `a` and `b` are f32 [Cin] or both null (no prologue);
// `w_dw` [k, Cin], `w_pw` [Cin, Cout], `x`, `y`, `dx` and the scratch `ddw`
// [B * To, Cin] are in the entry's compute type; `dy` is in the compute type,
// or f32 when `dy_f32` is 1; `ds1`, `ds2` are f32 [Cout]; `sums` is a zeroed
// f32 buffer of k * Cin + Cin * Cout + 2 * Cin elements that receives dw_dw,
// dw_pw, da and db in that order. They return cudaGetLastError() after the
// launches (0 when all three were accepted).
extern "C" int separable_block_bwd_bf16(
    const void* x, const void* a, const void* b, const void* w_dw,
    const void* w_pw, const void* y, const void* dy, int dy_f32,
    const void* ds1, const void* ds2, void* dx, void* ddw, void* sums,
    int64_t batch, int64_t t_in, int64_t cin, int64_t cout, int64_t k,
    int64_t stride, int64_t pad_lo, int64_t t_out, void* stream) {
  auto fn = dy_f32 ? launch<__nv_bfloat16, float>
                   : launch<__nv_bfloat16, __nv_bfloat16>;
  return fn(x, a, b, w_dw, w_pw, y, dy, ds1, ds2, dx, ddw, sums, batch, t_in,
            cin, cout, k, stride, pad_lo, t_out,
            static_cast<cudaStream_t>(stream));
}

extern "C" int separable_block_bwd_f32(
    const void* x, const void* a, const void* b, const void* w_dw,
    const void* w_pw, const void* y, const void* dy, int dy_f32,
    const void* ds1, const void* ds2, void* dx, void* ddw, void* sums,
    int64_t batch, int64_t t_in, int64_t cin, int64_t cout, int64_t k,
    int64_t stride, int64_t pad_lo, int64_t t_out, void* stream) {
  (void)dy_f32;  // dy is f32 either way
  return launch<float, float>(x, a, b, w_dw, w_pw, y, dy, ds1, ds2, dx, ddw,
                              sums, batch, t_in, cin, cout, k, stride, pad_lo,
                              t_out, static_cast<cudaStream_t>(stream));
}

extern "C" const char* separable_block_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
