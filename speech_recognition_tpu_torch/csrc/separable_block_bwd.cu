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
// Design. Two launches on the caller's stream, where the TPU kernel walks the
// batch in order and carries its sums in VMEM scratch from step to step:
//
//  (a) ddw_dx_kernel: ddw, then everything that reads it, so that ddw never
//      reaches device memory. A block takes 128 consecutive rows of the
//      flattened (b, t) output and 64 channels of Cin. Its first `halo` rows
//      (k - 1 at stride 1, one at stride 2 for k = 3) are recomputed: they
//      belong to the block before, and are there for the taps of dx only.
//      It forms dyt from dy and y as it stages it (chunks of 128 bytes of
//      Cout, w_pw beside it; 16-byte accesses where Cout is a multiple of 8)
//      and computes the 128 x 64 tile of ddw = dyt @ w_pw^T; ddw, rounded to
//      S, replaces the staged tiles in shared memory. Meanwhile cp.async
//      brings the padded rows of x that its own rows' taps read into a tile
//      of shared memory, each row once (the trunk's builds, k = 3 at stride
//      1 or 2; the general build reads x in the epilogue). The epilogue
//      works on pairs of channels, in bf16x2 arithmetic that rounds once per
//      operation (the contract's rounding, see Pair). From ddw and x it adds
//      the dw_dw partials of the block's own rows (never the halo's),
//      writes dx for the input rows whose last contributing output row is
//      one of its own (rows t * stride .. t * stride + stride - 1 of the
//      padded input for output row t, and for the last row of a batch row
//      everything up to the input's end: every other output row that reaches
//      such an input row lies at most `halo` rows before, so in the tile,
//      and a batch row's first rows take nothing from the rows before them),
//      and adds da and db. The tiles overlap by `halo` rows and cross batch
//      rows freely. It also writes, for (b), the depthwise output dw of its
//      own rows (the fuse chain, from the x it holds) and, in the blocks of
//      the first 64 channels, dyt of its own rows.
//  (b) dwpw_kernel: dw_pw = dw^T @ dyt from those two buffers, a plain
//      bf16 product: the reduction over the B * To rows is split into
//      slices, one block per (slice, 64 channels, 128 columns of Cout),
//      chunks of rows copied by cp.async in two stages, and each block adds
//      its tile into the sums with atomicAdd. Writing dw and dyt once costs
//      a write and a read of x's and y's size. The first design rebuilt them
//      in (b) instead, from x with the fuse chain and from dy and y, for
//      every 128 columns and every 64 channels, and was slower (PERF.md).
//
// The pointwise products run on the tensor cores in bf16: mma.sync m16n8k16
// with f32 accumulators, which is the rounding contract above (S operands,
// f32 sums). Operands come from shared memory through ldmatrix, `.trans`
// where the tile is stored K-major (dw and dyt in (b), rows of the reduction
// along the tile's rows). Each warp holds a 32 x 32 tile: 2 x 4 products of
// m16n8. The f32 entry runs the same tiles with CUDA-core FMAs in the same
// accumulator layout (TF32 would break the f32 contract). Everything that is
// not a product of the two GEMMs runs on the CUDA cores in the order above.
//
// The caller zeroes the f32 sums [dw_dw (k * Cin) | dw_pw (Cin * Cout) | da
// (Cin) | db (Cin)] first. Atomics add in an order that changes from run to
// run, so the four sums are not bit-reproducible.
//
// Bound: bytes, 0.2394 ms over the flagship's 11 trunk shapes at batch 384
// on an H100 (x, y, dy read once and dx written once; the products are 76
// GFLOP, 0.08 ms at the bf16 tensor-core peak). On top of that the kernel
// writes and reads dw and dyt once, and reads y and dy once per 64 channels
// of Cin in (a), mostly from L2. What holds (a) back is latency: a block's
// phases (stage, multiply, epilogue, reduce) run one after the other, with
// two or three blocks per SM. Left for later: wgmma with TMA-fed operand
// tiles and a warp-specialised producer, a persistent (a) that overlaps one
// tile's epilogue with the next tile's product, and a deterministic second
// pass over the slices instead of atomics.
//
// Offsets are 32-bit: the wrapper refuses tensors of 2^31 elements or more.

#include "separable_common.cuh"

namespace {

constexpr int kThreads = 256;                // 8 warps
// (a) ddw_dx_kernel
constexpr int kRows = 128;                   // ddw rows per block, halo included
constexpr int kCols = 64;                    // Cin channels per block
constexpr int kLanes = kThreads / (kCols / 2);  // epilogue: rows at once: 8
constexpr int kRowBatch = 4;                 // epilogue: rows loaded at once
// (b) dwpw_kernel
constexpr int kPwM = 64;                     // Cin channels per block
constexpr int kPwN = 128;                    // Cout columns per block
constexpr int kPwBlocks = 264;               // blocks aimed at: 2 per SM
// taps the general build unrolls for any k up to it (k = 3 at stride 1 and 2
// have builds of their own)
constexpr int kMaxTaps = 8;

// (a): Cout per staged chunk, 128 bytes of S
template <typename S>
constexpr int kChunk = 128 / static_cast<int>(sizeof(S));
// (b): rows per chunk, 64 bytes of S (two stages fit in 48 KB either way)
template <typename S>
constexpr int kPwK = 64 / static_cast<int>(sizeof(S));
// row padding of the staged tiles, 16 bytes: ldmatrix (bf16) and the FMA loop
// (f32) read them without bank conflicts
template <typename S>
constexpr int kPad = 16 / static_cast<int>(sizeof(S));

// dyt from dy and y, for output channel n (ds1n, ds2n).
template <typename S>
__device__ __forceinline__ float dyt_of(float dyv, float yv, float ds1n,
                                        float ds2n) {
  return round_to<S>(__fadd_rn(__fadd_rn(dyv, ds1n),
                               __fmul_rn(__fmul_rn(2.0f, yv), ds2n)));
}

// ---- (a) ddw, dw_dw, dx, da, db ----------------------------------------------
//
// K is the number of taps when the launch knows it (3, the trunk's), or
// kMaxTaps with the runtime k below it: the loops over taps unroll, so that a
// row's k loads of x are in flight together and every per-tap value lives in
// registers.

extern __shared__ __align__(16) unsigned char dyn_smem[];

template <typename S, typename D, int K, int kS>
__global__ void __launch_bounds__(kThreads)
ddw_dx_kernel(const S* __restrict__ x, const float* __restrict__ a,
              const float* __restrict__ b, const S* __restrict__ w_dw,
              const S* __restrict__ w_pw,             // [Cin, Cout]
              const S* __restrict__ y, const D* __restrict__ dy,
              const float* __restrict__ ds1, const float* __restrict__ ds2,
              S* __restrict__ dx,                     // [B, T, Cin]
              S* __restrict__ dw_out,                 // [B * To, Cin]
              S* __restrict__ dyt_out,                // [B * To, Cout]
              float* __restrict__ dwdw,               // [k, Cin], zeroed
              float* __restrict__ dadb,               // [2, Cin], zeroed
              int batch, int t_in, int cin, int cout, int k, int stride,
              int pad_lo, int t_out, int halo) {
  constexpr int kK = kChunk<S>;                 // Cout per chunk
  constexpr int kLd = kK + kPad<S>;
  constexpr int kLoadLanes = kThreads / kK;     // staged rows loaded at once
  constexpr int kDdwLd = kCols + kPad<S>;
  constexpr int kStageBytes = (kRows + kCols) * kLd * sizeof(S);
  constexpr int kDdwBytes = kRows * kDdwLd * sizeof(S);
  // The trunk's builds (k = 3, stride 1 or 2) copy the rows of x that the
  // epilogue reads into shared memory as the block starts, so that they
  // arrive while the product runs; the general build reads x in the
  // epilogue.
  constexpr bool kTiled = K == 3 && kS > 0;
  // dyt [kRows][kLd] and w_pw [kCols][kLd] while the product runs; then ddw
  // [kRows][kDdwLd], rounded to S
  __shared__ __align__(16)
      unsigned char smem[kStageBytes > kDdwBytes ? kStageBytes : kDdwBytes];
  __shared__ float red[2][kLanes][kCols];
  // per tile row r: its output row t, the offset in x of padded input row
  // t * stride (input row ti0 = t * stride - pad_lo), channel 0, and the slot
  // of that row in the x tile
  __shared__ int row_t[kRows], row_ti0[kRows], row_x[kRows], row_slot[kRows];
  S* As = reinterpret_cast<S*>(smem);
  S* Bs = As + kRows * kLd;
  S* ddw = reinterpret_cast<S*>(smem);
  // the x tile [slots][kCols] (dynamic shared memory, sized by the launch):
  // the padded input rows of the tile's output rows, each once. Row r's tap
  // i is slot row_slot[r] + i; consecutive rows of one batch row share their
  // overlapping taps, a batch row's last row has all k.
  S* xs = reinterpret_cast<S*>(dyn_smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cblocks = (cin + kCols - 1) / kCols;
  const int c0 = (blockIdx.x % cblocks) * kCols;
  const int e0 = (blockIdx.x / cblocks) * (kRows - halo) - halo;  // row 0
  const int rows = batch * t_out;
  const bool prologue = a != nullptr;
  const int s = kS > 0 ? kS : stride;
  const int u = min(s, k);  // slots a row adds within its batch row
  if (tid < kRows) {
    const int m = max(e0 + tid, 0);
    const int t = m % t_out, ti0 = t * s - pad_lo;
    row_t[tid] = t;
    row_ti0[tid] = ti0;
    row_x[tid] = ((m / t_out) * t_in + ti0) * cin;
    row_slot[tid] = u * tid + (k - u) * (m / t_out - max(e0, 0) / t_out);
  }
  if constexpr (kTiled) {
    constexpr int kV = 16 / static_cast<int>(sizeof(S));  // per copy
    constexpr int kCopies = kCols / kV;                   // per slot
    const bool xvec = cin % kV == 0;
    __syncthreads();  // the row tables are written
    for (int e = tid; e < kRows * K * kCopies; e += kThreads) {
      const int q = e % kCopies, i = e / kCopies % K, r = e / (kCopies * K);
      const int m = e0 + r;
      if (m < 0 || m >= rows) continue;
      // tap i >= u of a row that is not its batch row's last in the tile is
      // the next row's tap i - s
      if (i >= u && r < kRows - 1 && row_t[r] < t_out - 1 && m < rows - 1)
        continue;
      const int ti = row_ti0[r] + i, c = c0 + q * kV;
      const bool in = ti >= 0 && ti < t_in;
      S* dst = xs + (row_slot[r] + i) * kCols + q * kV;
      const S* src = x + row_x[r] + i * cin + c;
      if (xvec) {
        cp_async16(dst, in && c < cin ? src : x, in && c < cin);
      } else {
#pragma unroll
        for (int v = 0; v < kV; ++v)
          dst[v] = in && c + v < cin ? src[v] : from_float<S>(0.0f);
      }
    }
    cp_async_commit();
  }

  // ddw = dyt @ w_pw^T: warps 4 (rows) x 2 (channels), 32 x 32 each
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  // One block of each row tile writes its own rows of dyt for (b).
  const bool write_dyt = blockIdx.x % cblocks == 0;
  // Staging: with Cout a multiple of 8, 8 columns per thread and 16-byte
  // accesses (dyt rounded once per pair of values); else one column per
  // thread. Either way a thread's loads come before their first use.
  const bool vec8 = cout % 8 == 0;
  constexpr int kGroups = kK / 8;                 // 8-column groups per row
  constexpr int kGroupRows = kThreads / kGroups;  // rows staged at once
  const int gq = tid % kGroups, gr = tid / kGroups;
  const int lk = tid % kK, lr = tid / kK;
  for (int n0 = 0; n0 < cout; n0 += kK) {
    __syncthreads();  // the previous chunk is no longer read
    if (vec8) {
      const int n = n0 + 8 * gq;
      const bool n_ok = n < cout;
      float s1[8], s2[8];
      load8(ds1 + (n_ok ? n : 0), s1);
      load8(ds2 + (n_ok ? n : 0), s2);
#pragma unroll 4
      for (int q = 0; q < kRows / kGroupRows; ++q) {
        const int r = gr + q * kGroupRows;
        const int m = e0 + r;
        const bool ok = n_ok && m >= 0 && m < rows;
        float dv[8], yv[8], v[8];
        load8(dy + (ok ? m * cout + n : 0), dv);
        load8(y + (ok ? m * cout + n : 0), yv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = ok ? __fadd_rn(__fadd_rn(dv[e], s1[e]),
                                __fmul_rn(__fmul_rn(2.0f, yv[e]), s2[e]))
                    : 0.0f;
        store8(As + r * kLd + 8 * gq, v);
        if (write_dyt && ok && r >= halo) store8(dyt_out + m * cout + n, v);
      }
#pragma unroll
      for (int q = 0; q < kCols / kGroupRows; ++q) {
        const int cc = gr + q * kGroupRows;
        const bool ok = n_ok && c0 + cc < cin;
        float wv8[8];
        load8(w_pw + (ok ? (c0 + cc) * cout + n : 0), wv8);
#pragma unroll
        for (int e = 0; e < 8; ++e) wv8[e] = ok ? wv8[e] : 0.0f;
        store8(Bs + cc * kLd + 8 * gq, wv8);
      }
    } else {
      const int n = n0 + lk;
      const bool n_ok = n < cout;
      const float ds1n = n_ok ? ds1[n] : 0.0f;
      const float ds2n = n_ok ? ds2[n] : 0.0f;
#pragma unroll 8
      for (int q = 0; q < kRows / kLoadLanes; ++q) {
        const int r = lr + q * kLoadLanes;
        const int m = e0 + r;
        const bool ok = n_ok && m >= 0 && m < rows;
        const int idx = ok ? m * cout + n : 0;
        const float v = ok ? dyt_of<S>(to_float(dy[idx]), to_float(y[idx]),
                                       ds1n, ds2n)
                           : 0.0f;
        As[r * kLd + lk] = from_float<S>(v);
        if (write_dyt && ok && r >= halo) dyt_out[idx] = from_float<S>(v);
      }
#pragma unroll
      for (int q = 0; q < kCols / kLoadLanes; ++q) {
        const int cc = lr + q * kLoadLanes;
        const bool ok = n_ok && c0 + cc < cin;
        Bs[cc * kLd + lk] = ok ? w_pw[(c0 + cc) * cout + n]
                               : from_float<S>(0.0f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kK; kk += 16)
      mma_step<2, 4, false, false>(acc, As + wm * kLd + kk, kLd,
                                   Bs + wn * kLd + kk, kLd, lane);
  }
  __syncthreads();  // the staged tiles are read: ddw takes their place
  using P = Pair<S>;
  using T2 = typename P::T;
  {
    const int g = lane >> 2, u = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<T2*>(
              &ddw[(wm + 16 * i + g + 8 * h) * kDdwLd + wn + 8 * j + 2 * u]) =
              P::of(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  }
  if constexpr (kTiled) cp_async_wait_all();  // the x tile has landed
  __syncthreads();

  // Epilogue: thread (lp, ln) takes channels c and c + 1, c = c0 + 2 lp, and
  // the tile's own rows halo + ln, halo + ln + kLanes, ... For own row r
  // (output row t) it reads the k padded input rows t * stride + i once: they
  // give its dw_dw terms and dw[t], and rows t * stride + j (j < stride, or
  // up to the input's end at a batch row's last t) are the dx rows it
  // writes. Tap i reaches padded row t * stride + j from output row
  // t - (i - j) / stride, where i >= j and i - j is a multiple of the stride
  // (known at compile time for the trunk's k and strides).
  const int lp = tid % (kCols / 2), ln = tid / (kCols / 2);
  const int c = c0 + 2 * lp;
  const bool ok0 = c < cin, ok1 = c + 1 < cin, pairs = cin % 2 == 0;
  const T2 zero = P::zero();
  const T2 a2 = P::of(prologue && ok0 ? a[c] : 0.0f,
                      prologue && ok1 ? a[c + 1] : 0.0f);
  const T2 b2 = P::of(prologue && ok0 ? b[c] : 0.0f,
                      prologue && ok1 ? b[c + 1] : 0.0f);
  T2 w2[K];
#pragma unroll
  for (int i = 0; i < K; ++i)
    w2[i] = i < k ? load_pair(w_dw + i * cin + c, ok0, ok1, pairs) : zero;
  float2 part[K];
#pragma unroll
  for (int i = 0; i < K; ++i) part[i] = make_float2(0.0f, 0.0f);
  float2 da = make_float2(0.0f, 0.0f), db = make_float2(0.0f, 0.0f);
  // rows in batches of kRowBatch (the general build issues their loads of x
  // together)
  for (int r0 = halo + ln; r0 < kRows; r0 += kRowBatch * kLanes) {
    T2 xv[kRowBatch][K];
#pragma unroll
    for (int h = 0; h < kRowBatch; ++h) {
      const int r = r0 + h * kLanes;
      const bool own = ok0 && r < kRows && e0 + r < rows;
      const int ti0 = own ? row_ti0[r] : 0;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const bool in = own && i < k && ti0 + i >= 0 && ti0 + i < t_in;
        if constexpr (kTiled) {
          xv[h][i] = in ? *reinterpret_cast<const T2*>(
                              &xs[(row_slot[r] + i) * kCols + 2 * lp])
                        : zero;
        } else {
          const T2 v = load_pair(in ? x + row_x[r] + c + i * cin : x, ok0,
                                 ok1, pairs);
          xv[h][i] = in ? v : zero;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kRowBatch; ++h) {
      const int r = r0 + h * kLanes;
      if (!ok0 || r >= kRows || e0 + r >= rows) break;
      const int t = row_t[r], ti0 = row_ti0[r];
      const T2 d = *reinterpret_cast<const T2*>(&ddw[r * kDdwLd + 2 * lp]);
      T2 dwv = zero;  // dw[t] for (b), the fuse chain
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (i >= k) break;
        const bool in = ti0 + i >= 0 && ti0 + i < t_in;
        const T2 xin = prologue && in
                           ? P::relu6(P::add(P::mul(xv[h][i], a2), b2))
                           : xv[h][i];
        const float2 term = P::f(P::mul(xin, d));
        part[i].x = __fadd_rn(part[i].x, term.x);
        part[i].y = __fadd_rn(part[i].y, term.y);
        const T2 piece = P::mul(xin, w2[i]);
        dwv = i == 0 ? piece : P::add(dwv, piece);
      }
      store_pair(dw_out + (e0 + r) * cin + c, dwv, ok0, ok1, pairs);
      // dx rows ti0 + j, j in [max(0, -ti0), j_end)
      S* dxr = dx + row_x[r] + c;
      const int j_end = t == t_out - 1 ? t_in - ti0 : min(s, t_in - ti0);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (j >= j_end || ti0 + j < 0) continue;
        T2 dxp = zero;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          if (i >= k || i < j || (i - j) % s != 0) continue;
          const int bk = (i - j) / s;
          if (bk > t) continue;
          const T2 dv =
              *reinterpret_cast<const T2*>(&ddw[(r - bk) * kDdwLd + 2 * lp]);
          dxp = P::add(dxp, P::mul(dv, w2[i]));
        }
        if (!prologue) {
          store_pair(dxr + j * cin, dxp, ok0, ok1, pairs);
          continue;
        }
        const T2 dpre =
            P::mul(dxp, P::inside(P::add(P::mul(xv[h][j], a2), b2)));
        store_pair(dxr + j * cin, P::mul(dpre, a2), ok0, ok1, pairs);
        const float2 dax = P::f(P::mul(dpre, xv[h][j])), dbx = P::f(dpre);
        da.x = __fadd_rn(da.x, dax.x);
        da.y = __fadd_rn(da.y, dax.y);
        db.x = __fadd_rn(db.x, dbx.x);
        db.y = __fadd_rn(db.y, dbx.y);
      }
      // rows past every tap (VALID at stride 2 with T - k odd): dx = 0
      for (int j = K; j < j_end; ++j)
        store_pair(dxr + j * cin, prologue ? P::mul(zero, a2) : zero, ok0,
                   ok1, pairs);
    }
  }

  // the sums over the block's rows: lanes through shared memory, then one
  // atomicAdd per channel
  const int lc = tid % kCols, rl = tid / kCols;  // reduction: channel, lane
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i >= k) break;  // the same for every thread of the block
    red[0][ln][2 * lp] = part[i].x;
    red[0][ln][2 * lp + 1] = part[i].y;
    __syncthreads();
    if (rl == 0 && c0 + lc < cin) {
      float sum = 0.0f;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) sum = __fadd_rn(sum, red[0][l][lc]);
      atomicAdd(&dwdw[i * cin + c0 + lc], sum);
    }
    __syncthreads();
  }
  if (!prologue) return;
  red[0][ln][2 * lp] = da.x;
  red[0][ln][2 * lp + 1] = da.y;
  red[1][ln][2 * lp] = db.x;
  red[1][ln][2 * lp + 1] = db.y;
  __syncthreads();
  if (rl < 2 && c0 + lc < cin) {
    float sum = 0.0f;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) sum = __fadd_rn(sum, red[rl][l][lc]);
    atomicAdd(&dadb[rl * cin + c0 + lc], sum);
  }
}

// ---- (b) dw_pw ----------------------------------------------------------------
//
// dw_pw = dw^T @ dyt from the two buffers that (a) writes: a product of bf16
// (or f32) tiles with nothing to recompute. Chunks of kPwK rows are copied
// into shared memory with cp.async, two stages, so that the next chunk is in
// flight while the tensor cores take this one; where Cin or Cout is no
// multiple of 8 (4 in f32) the rows are not 16-byte aligned and the copies
// go element by element.

template <typename S>
__global__ void __launch_bounds__(kThreads)
dwpw_kernel(const S* __restrict__ dw,      // [B * To, Cin]
            const S* __restrict__ dyt,     // [B * To, Cout]
            float* __restrict__ dwpw,      // [Cin, Cout], zeroed
            int rows, int cin, int cout, int slice_rows) {
  constexpr int kK = kPwK<S>;
  constexpr int kLdA = kPwM + kPad<S>, kLdB = kPwN + kPad<S>;
  constexpr int kV = 16 / static_cast<int>(sizeof(S));  // elements per copy
  constexpr int kAc = kPwM / kV, kBc = kPwN / kV;       // copies per row
  __shared__ __align__(16) S As[2][kK * kLdA];  // dw [row][channel]
  __shared__ __align__(16) S Bs[2][kK * kLdB];  // dyt [row][column]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nblocks = (cout + kPwN - 1) / kPwN;
  const int cblocks = (cin + kPwM - 1) / kPwM;
  const int n0 = (blockIdx.x % nblocks) * kPwN;
  const int c0 = (blockIdx.x / nblocks % cblocks) * kPwM;
  const int r_begin = (blockIdx.x / nblocks / cblocks) * slice_rows;
  const int r_end = min(rows, r_begin + slice_rows);
  const bool vec = cin % kV == 0 && cout % kV == 0;

  // stage rows [r0, r0 + kK) of both tiles into buffer `buf`
  auto stage = [&](int r0, int buf) {
#pragma unroll
    for (int e = tid; e < kK * kAc; e += kThreads) {
      const int kk = e / kAc, cc = (e % kAc) * kV;
      const int m = r0 + kk, c = c0 + cc;
      S* dst = &As[buf][kk * kLdA + cc];
      if (vec) {
        const bool ok = m < r_end && c < cin;
        cp_async16(dst, dw + (ok ? m * cin + c : 0), ok);
      } else {
#pragma unroll
        for (int v = 0; v < kV; ++v)
          dst[v] = (m < r_end && c + v < cin) ? dw[m * cin + c + v]
                                              : from_float<S>(0.0f);
      }
    }
#pragma unroll
    for (int e = tid; e < kK * kBc; e += kThreads) {
      const int kk = e / kBc, nn = (e % kBc) * kV;
      const int m = r0 + kk, n = n0 + nn;
      S* dst = &Bs[buf][kk * kLdB + nn];
      if (vec) {
        const bool ok = m < r_end && n < cout;
        cp_async16(dst, dyt + (ok ? m * cout + n : 0), ok);
      } else {
#pragma unroll
        for (int v = 0; v < kV; ++v)
          dst[v] = (m < r_end && n + v < cout) ? dyt[m * cout + n + v]
                                               : from_float<S>(0.0f);
      }
    }
  };

  // dw^T @ dyt: warps 2 (channels) x 4 (columns), 32 x 32 each
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int chunks = (r_end - r_begin + kK - 1) / kK;
  stage(r_begin, 0);
  cp_async_commit();
  for (int ci = 0; ci < chunks; ++ci) {
    if (ci + 1 < chunks) stage(r_begin + (ci + 1) * kK, (ci + 1) & 1);
    cp_async_commit();
    cp_async_wait_prev();  // this chunk's copies have landed
    __syncthreads();
    const S* a = As[ci & 1];
    const S* b = Bs[ci & 1];
#pragma unroll
    for (int kk = 0; kk < kK; kk += 16)
      mma_step<2, 4, true, true>(acc, a + kk * kLdA + wm, kLdA,
                                 b + kk * kLdB + wn, kLdB, lane);
    __syncthreads();  // read before the stage after next overwrites it
  }

  const int g = lane >> 2, u = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = c0 + wm + 16 * i + g + 8 * (e >> 1);
      if (ci >= cin) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nj = n0 + wn + 8 * j + 2 * u + (e & 1);
        if (nj < cout) atomicAdd(&dwpw[ci * cout + nj], acc[i][j][e]);
      }
    }
}

int64_t div_up(int64_t n, int64_t d) { return (n + d - 1) / d; }

template <typename S, typename D, int K, int kS>
int launch_taps(const S* x, const float* a, const float* b, const S* w_dw,
                const S* w_pw, const S* y, const D* dy, const float* ds1,
                const float* ds2, S* dx, S* dw, S* dyt, float* sums,
                int batch, int t_in, int cin, int cout, int k, int stride,
                int pad_lo, int t_out, int halo, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(batch) * t_out;
  float* dwdw = sums;
  float* dwpw = dwdw + k * cin;
  float* dadb = dwpw + cin * cout;
  const int64_t tiles = div_up(rows, kRows - halo) * div_up(cin, kCols);
  // the x tile: per row min(stride, k) slots, and k - that at the last row
  // of each of the (at most) (kRows - 1) / To + 2 batch rows of a tile
  int xs_bytes = 0;
  if (K == 3 && kS > 0) {
    const int u = kS < k ? kS : k;
    const int slots = u * kRows + (k - u) * ((kRows - 1) / t_out + 2);
    xs_bytes = slots * kCols * static_cast<int>(sizeof(S));
    const cudaError_t err = cudaFuncSetAttribute(
        ddw_dx_kernel<S, D, K, kS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, xs_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ddw_dx_kernel<S, D, K, kS><<<static_cast<unsigned>(tiles), kThreads,
                               xs_bytes, stream>>>(x, a, b, w_dw, w_pw, y, dy, ds1, ds2, dx,
                                     dw, dyt, dwdw, dadb, batch, t_in, cin,
                                     cout, k, stride, pad_lo, t_out, halo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || cout == 0) return static_cast<int>(err);

  // slices of the rows, each a multiple of the chunk, so that the grid holds
  // about kPwBlocks blocks
  const int64_t tiles_pw = div_up(cin, kPwM) * div_up(cout, kPwN);
  const int64_t want = kPwBlocks / tiles_pw > 1 ? kPwBlocks / tiles_pw : 1;
  const int64_t slice_rows = div_up(div_up(rows, want), kPwK<S>) * kPwK<S>;
  dwpw_kernel<S><<<static_cast<unsigned>(div_up(rows, slice_rows) * tiles_pw),
                   kThreads, 0, stream>>>(dw, dyt, dwpw,
                                          static_cast<int>(rows), cin, cout,
                                          static_cast<int>(slice_rows));
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename D>
int launch(const void* x, const void* a, const void* b, const void* w_dw,
           const void* w_pw, const void* y, const void* dy, const void* ds1,
           const void* ds2, void* dx, void* dw, void* dyt, void* sums,
           int64_t batch, int64_t t_in, int64_t cin, int64_t cout, int64_t k,
           int64_t stride, int64_t pad_lo, int64_t t_out,
           cudaStream_t stream) {
  if (batch == 0 || cin == 0) return 0;
  // output rows before a block's own that reach its dx rows
  const int64_t halo = (k - 1 + stride - 1) / stride;
  if (k < 1 || k > kMaxTaps || halo >= kRows / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  // the trunk's k and strides have builds of their own
  auto fn = k == 3 && stride == 1   ? launch_taps<S, D, 3, 1>
            : k == 3 && stride == 2 ? launch_taps<S, D, 3, 2>
                                    : launch_taps<S, D, kMaxTaps, 0>;
  return fn(static_cast<const S*>(x), static_cast<const float*>(a),
            static_cast<const float*>(b), static_cast<const S*>(w_dw),
            static_cast<const S*>(w_pw), static_cast<const S*>(y),
            static_cast<const D*>(dy), static_cast<const float*>(ds1),
            static_cast<const float*>(ds2), static_cast<S*>(dx),
            static_cast<S*>(dw), static_cast<S*>(dyt),
            static_cast<float*>(sums), static_cast<int>(batch),
            static_cast<int>(t_in), static_cast<int>(cin),
            static_cast<int>(cout), static_cast<int>(k),
            static_cast<int>(stride), static_cast<int>(pad_lo),
            static_cast<int>(t_out), static_cast<int>(halo), stream);
}

}  // namespace

// Plain C entry points for ctypes: every pointer and the stream as void*,
// sizes as int64. `a` and `b` are f32 [Cin] or both null (no prologue);
// `w_dw` [k, Cin], `w_pw` [Cin, Cout], `x`, `y` and `dx` are in the entry's
// compute type; `dy` is in the compute type, or f32 when `dy_f32` is 1;
// `ds1`, `ds2` are f32 [Cout]; `dw` [B * To, Cin] and `dyt` [B * To, Cout]
// are scratch in the compute type that (a) writes and (b) reads; `sums` is a
// zeroed f32 buffer of k * Cin + Cin * Cout + 2 * Cin elements that receives
// dw_dw, dw_pw, da and db in that order. k is at most 8. They return
// cudaGetLastError() after the launches (0 when both were accepted).
extern "C" int separable_block_bwd_bf16(
    const void* x, const void* a, const void* b, const void* w_dw,
    const void* w_pw, const void* y, const void* dy, int dy_f32,
    const void* ds1, const void* ds2, void* dx, void* dw, void* dyt,
    void* sums, int64_t batch, int64_t t_in, int64_t cin, int64_t cout,
    int64_t k, int64_t stride, int64_t pad_lo, int64_t t_out, void* stream) {
  auto fn = dy_f32 ? launch<bf16, float> : launch<bf16, bf16>;
  return fn(x, a, b, w_dw, w_pw, y, dy, ds1, ds2, dx, dw, dyt, sums, batch,
            t_in, cin, cout, k, stride, pad_lo, t_out,
            static_cast<cudaStream_t>(stream));
}

extern "C" int separable_block_bwd_f32(
    const void* x, const void* a, const void* b, const void* w_dw,
    const void* w_pw, const void* y, const void* dy, int dy_f32,
    const void* ds1, const void* ds2, void* dx, void* dw, void* dyt,
    void* sums, int64_t batch, int64_t t_in, int64_t cin, int64_t cout,
    int64_t k, int64_t stride, int64_t pad_lo, int64_t t_out, void* stream) {
  (void)dy_f32;  // dy is f32 either way
  return launch<float, float>(x, a, b, w_dw, w_pw, y, dy, ds1, ds2, dx, dw,
                              dyt, sums, batch, t_in, cin, cout, k, stride,
                              pad_lo, t_out,
                              static_cast<cudaStream_t>(stream));
}

extern "C" const char* separable_block_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
