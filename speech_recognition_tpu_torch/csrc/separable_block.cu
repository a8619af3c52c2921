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
// (b, t_out), and each block computes a tile of 128 of them (fewer only in
// the general build at very large k, see below) by 64 columns of Cout with
// 8 warps of 32 x 32, on the tensor cores in bf16 (mma.sync m16n8k16 fed by
// ldmatrix, f32 accumulators: the contract's S operands and f32 sums); the
// f32 entry runs the same tiles with CUDA-core FMAs in the same accumulator
// layout (TF32 would break the f32 contract). Products and helpers are in
// separable_common.cuh, shared with the backward.
//
// The block loops over Cin in chunks of 128 bytes of S (64 channels in
// bf16). For each chunk it stages the padded input rows that its output
// rows read into a tile of shared memory, each row once: consecutive output
// rows of one batch row share their overlapping taps, so tap i of tile row
// r is slot row_slot[r] + i (the backward's slot arithmetic, with a table of
// where each slot comes from). The copy goes through registers, 16 bytes at
// a time where Cin is a multiple of 8 (bf16) or 4 (f32), and applies the
// prologue there once per element in bf16x2 / float2 arithmetic (Pair),
// which knows the slot's validity: a slot outside [0, T) is written as 0.
// The chunk of W_i ("fold") or of w_pw ("fuse") comes by cp.async beside it.
//  - "fold" is one product of depth k * Cin with no im2col copy: for tap i
//    the A operand's rows are slots row_slot[r] + i of the staged tile,
//    handed to ldmatrix as gathered row addresses (mma_step_rows). W_i is
//    staged three taps at a time (all of them at the trunk's k = 3).
//  - "fuse" first forms the depthwise output of the chunk from the staged
//    tile with the fuse chain in Pair arithmetic (each tap product and each
//    running sum rounded to S), writes it as a [128 x chunk] A tile, and
//    multiplies that by the w_pw chunk (mma_step).
// The epilogue rounds y to S, stages the tile in shared memory and writes it
// with 16-byte stores where Cout is a multiple of 8 (bf16) or 4 (f32). The
// statistics are taken from the rounded values: each thread sums its rows,
// warp shuffles sum over the fragment's rows, shared memory over the four
// warps of a column, and the block adds one value per column into the f32
// [2, Cout] buffer with atomicAdd; the entry zeroes it first (a memset on
// the stream, no kernel of its own). The order of
// those additions changes from run to run, so s1 and s2 are not
// bit-reproducible.
//
// k = 3 (the trunk's, at any stride) has builds of its own with the taps
// unrolled; the general build takes any other k up to kMaxTaps. Its x tile
// grows with k: the launch sizes the row tile (128 rows, or fewer) so that
// the tile fits in shared memory; rows of a smaller tile past its end are
// computed and dropped.
//
// Bound: bytes, 0.1194 ms over the flagship's 11 trunk shapes at batch 384
// on an H100 (x and y once, ~0.4 GB; the pointwise products are ~38 GFLOP
// for "fuse" and k = 3 times that for "fold", 0.04 and 0.12 ms at the bf16
// tensor-core peak). Each block stages its x rows once per 64 columns of
// Cout (from L2 after the first) and its weight chunk once per 128 rows. A
// block's phases (stage, multiply, epilogue) run one after the other; what
// comes next, in order: double-buffering the next chunk by cp.async while
// the current one multiplies, then wgmma with TMA-fed tiles, then a
// persistent block that overlaps one tile's epilogue with the next tile's
// loads.
//
// Offsets are 32-bit: the wrapper refuses tensors of 2^31 elements or more.

#include "separable_common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: 4 (rows) x 2 (columns), 32 x 32 each
constexpr int kRows = 128;     // output rows per block, at most
constexpr int kCols = 64;      // output columns per block
constexpr int kTapsB = 3;      // taps of W staged at once ("fold")
constexpr int kMaxTaps = 1024;  // the general build's largest k
// dynamic shared memory the x tile and its slot table may take
constexpr int kMaxDynBytes = 160 * 1024;

// Cin per chunk: 128 bytes of S
template <typename S>
constexpr int kChunk = 128 / static_cast<int>(sizeof(S));
// elements per 16-byte access, and the row padding of the staged tiles (16
// bytes: ldmatrix (bf16) and the FMA loop (f32) read them without bank
// conflicts)
template <typename S>
constexpr int kV = 16 / static_cast<int>(sizeof(S));
template <typename S>
constexpr int kLdX = kChunk<S> + kV<S>;  // x tile and dw tile rows
template <typename S>
constexpr int kLdB = kCols + kV<S>;      // weight and y tile rows
// blocks per SM the build is held to (registers: 65,536 / (256 x blocks));
// three bf16 blocks fit in shared memory at the trunk's shapes, f32 tiles
// are twice the bytes
template <typename S>
constexpr int kMinBlocks = sizeof(S) == 2 ? 3 : 2;

// The 16 bytes of S at p, of which the first `n` lie inside the tensor (the
// rest read as 0): one access when `vec` and all are inside.
template <typename S>
__device__ __forceinline__ uint4 load16(const S* p, int n, bool vec) {
  if (vec && n >= kV<S>) return *reinterpret_cast<const uint4*>(p);
  uint4 v = make_uint4(0, 0, 0, 0);
  S* e = reinterpret_cast<S*>(&v);
#pragma unroll
  for (int i = 0; i < kV<S>; ++i)
    if (i < n) e[i] = p[i];
  return v;
}

// The (up to kV) elements of `v` at p, the first `n` of them: one access
// when `vec` and all are inside.
template <typename S>
__device__ __forceinline__ void store16(S* p, uint4 v, int n, bool vec) {
  if (vec && n >= kV<S>) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  const S* e = reinterpret_cast<const S*>(&v);
#pragma unroll
  for (int i = 0; i < kV<S>; ++i)
    if (i < n) p[i] = e[i];
}

extern __shared__ __align__(16) unsigned char dyn_smem[];

// K is 3 when the launch knows k = 3, else 0 (the runtime k).
template <typename S, bool kFold, int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks<S>)
separable_block_kernel(const S* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ b,
                       const S* __restrict__ w_dw,  // [k, Cin]
                       const S* __restrict__ w,     // [(k,) Cin, Cout]
                       S* __restrict__ y,           // [B * To, Cout]
                       float* __restrict__ stats,   // [2, Cout] or null
                       int batch, int t_in, int cin, int cout, int k,
                       int stride, int pad_lo, int t_out, int tile_rows,
                       int max_slots) {
  using P = Pair<S>;
  using T2 = typename P::T;
  constexpr int kC = kChunk<S>, kLx = kLdX<S>, kLb = kLdB<S>;
  constexpr int kVe = kV<S>;
  constexpr int kPairs = kVe / 2;                    // pairs per 16 bytes
  constexpr int kGroups = kC / kVe;                  // 16-byte groups per row
  constexpr int kSlotStep = kThreads / kGroups;      // x rows staged at once
  constexpr int kBTaps = kFold ? kTapsB : 1;
  constexpr int kBBytes = kBTaps * kC * kLb * static_cast<int>(sizeof(S));
  constexpr int kDwBytes = kFold ? 0 : kRows * kLx * static_cast<int>(sizeof(S));
  constexpr int kYBytes = kRows * kLb * static_cast<int>(sizeof(S));
  constexpr int kTileBytes =
      kBBytes + kDwBytes > kYBytes ? kBBytes + kDwBytes : kYBytes;
  // the weight chunk [taps][chunk][kLb] and ("fuse") the dw tile
  // [kRows][kLx] while the chunks run; then the y tile [kRows][kLb]
  __shared__ __align__(16) unsigned char smem[kTileBytes];
  __shared__ int row_slot[kRows];
  __shared__ float red[2][4][kCols];
  S* Bs = reinterpret_cast<S*>(smem);
  S* dws = reinterpret_cast<S*>(smem + kBBytes);
  S* ys = reinterpret_cast<S*>(smem);
  // the x tile [max_slots][kLx] and, after it, each slot's offset in x of
  // its input row (-1: outside [0, T) or past the last output row): dynamic
  // shared memory sized by the launch
  S* xs = reinterpret_cast<S*>(dyn_smem);
  int* slot_src = reinterpret_cast<int*>(
      dyn_smem + static_cast<size_t>(max_slots) * kLx * sizeof(S));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nblocks = (cout + kCols - 1) / kCols;
  const int n0 = (blockIdx.x % nblocks) * kCols;
  const int m0 = (blockIdx.x / nblocks) * tile_rows;
  const int rows = batch * t_out;
  const bool prologue = a != nullptr;
  const int taps = K > 0 ? K : k;
  const int u = min(stride, taps);  // slots a row adds within its batch row

  // The slot table. Row r's tap i is slot row_slot[r] + i; a row writes the
  // sources of its first u slots, and of all k if it is its batch row's
  // last in the tile (the rest are the next row's). Rows past the tile get
  // slot 0 and are dropped.
  if (tid < kRows) {
    int slot = 0;
    if (tid < tile_rows) {
      const int m = m0 + tid;
      const int bi = m / t_out, t = m - bi * t_out;
      slot = u * tid + (taps - u) * (bi - m0 / t_out);
      const bool last = tid == tile_rows - 1 || t == t_out - 1;
      const int ti0 = t * stride - pad_lo;
      const int n = last ? taps : u;
      for (int i = 0; i < n; ++i) {
        const int ti = ti0 + i;
        slot_src[slot + i] =
            m < rows && ti >= 0 && ti < t_in ? (bi * t_in + ti) * cin : -1;
      }
    }
    row_slot[tid] = slot;
  }
  __syncthreads();
  const int nslots = row_slot[tile_rows - 1] + taps;

  // this warp's 32 x 32 tile, and the slots of the rows its lane addresses
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  int aslot[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      aslot[i][h] = row_slot[wm + a_row<S>(i, h, lane)];
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // staging: thread (q, sr) takes the 16-byte group q of the chunk's rows
  // sr, sr + kSlotStep, ...
  const int q = tid % kGroups, sr = tid / kGroups;
  const bool xvec = cin % kVe == 0, wvec = cout % kVe == 0;
  constexpr int kBGroups = kCols / kVe;  // 16-byte groups per weight row

  // weight rows [tap0, tap0 + kBTaps) x the chunk's channels, columns
  // [n0, n0 + kCols), by cp.async (zeros outside) or element by element
  auto stage_w = [&](int c0, int tap0) {
    for (int e = tid; e < kBTaps * kC * kBGroups; e += kThreads) {
      const int gq = e % kBGroups, kr = e / kBGroups;  // kr: tap * kC + ci
      const int tap = tap0 + kr / kC, ci = c0 + kr % kC, n = n0 + gq * kVe;
      const bool in = tap < taps && ci < cin;
      S* dst = Bs + kr * kLb + gq * kVe;
      const S* src = w + (static_cast<size_t>(tap) * cin + ci) * cout + n;
      if (wvec) {
        const bool ok = in && n < cout;
        cp_async16(dst, ok ? src : w, ok);
      } else {
        store16(dst, load16(src, in ? cout - n : 0, false), kVe, true);
      }
    }
    cp_async_commit();
  };

  for (int c0 = 0; c0 < cin; c0 += kC) {
    __syncthreads();  // the previous chunk's tiles are no longer read
    stage_w(c0, 0);
    // the x tile: each slot's 16-byte group q, loaded 4 slots at a time,
    // the prologue applied where the slot lies inside [0, T)
    {
      const int c = c0 + q * kVe;
      T2 a2[kPairs], b2[kPairs];
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const int cp = c + 2 * p;
        a2[p] = P::of(prologue && cp < cin ? a[cp] : 0.0f,
                      prologue && cp + 1 < cin ? a[cp + 1] : 0.0f);
        b2[p] = P::of(prologue && cp < cin ? b[cp] : 0.0f,
                      prologue && cp + 1 < cin ? b[cp + 1] : 0.0f);
      }
      constexpr int kBatch = 4;
      for (int s0 = sr; s0 < nslots; s0 += kBatch * kSlotStep) {
        uint4 v[kBatch];
        int src[kBatch];
#pragma unroll
        for (int h = 0; h < kBatch; ++h) {
          const int s = s0 + h * kSlotStep;
          src[h] = s < nslots ? slot_src[s] : -1;
          v[h] = load16(x + (src[h] >= 0 ? src[h] + c : 0),
                        src[h] >= 0 ? cin - c : 0, xvec);
        }
#pragma unroll
        for (int h = 0; h < kBatch; ++h) {
          const int s = s0 + h * kSlotStep;
          if (s >= nslots) break;
          if (prologue && src[h] >= 0) {
            T2* vp = reinterpret_cast<T2*>(&v[h]);
#pragma unroll
            for (int p = 0; p < kPairs; ++p)
              vp[p] = P::relu6(P::add(P::mul(vp[p], a2[p]), b2[p]));
          }
          *reinterpret_cast<uint4*>(xs + s * kLx + q * kVe) = v[h];
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the x tile and the weight chunk have landed

    if constexpr (kFold) {
      for (int t0 = 0; t0 < taps; t0 += kTapsB) {
        if (t0 > 0) {  // the general build's next taps of W
          __syncthreads();
          stage_w(c0, t0);
          cp_async_wait_all();
          __syncthreads();
        }
#pragma unroll
        for (int ti = 0; ti < kTapsB; ++ti) {
          if (t0 + ti >= taps) break;
#pragma unroll
          for (int kk = 0; kk < kC; kk += 16) {
            const S* arow[2][2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                arow[i][h] = xs + (aslot[i][h] + t0 + ti) * kLx + kk;
            mma_step_rows<2, 4, true>(acc, arow,
                                      Bs + (ti * kC + kk) * kLb + wn, kLb,
                                      lane);
          }
        }
      }
    } else {
      // the depthwise output of the chunk, the fuse chain: thread (q, sr)
      // takes group q of rows sr, sr + kSlotStep, ...
      {
        const int c = c0 + q * kVe;
        const bool pairs = cin % 2 == 0;
        // w_dw of tap i for the thread's channels
        auto w_of = [&](int i, T2 (&wv)[kPairs]) {
#pragma unroll
          for (int p = 0; p < kPairs; ++p)
            wv[p] = load_pair(w_dw + i * cin + c + 2 * p, c + 2 * p < cin,
                              c + 2 * p + 1 < cin, pairs);
        };
        // tap i's term of the chain for the rows at xr
        auto add_tap = [&](int i, const S* xr, const T2 (&wv)[kPairs],
                           T2* dwv) {
          const uint4 xv = *reinterpret_cast<const uint4*>(xr + i * kLx);
          const T2* xp = reinterpret_cast<const T2*>(&xv);
#pragma unroll
          for (int p = 0; p < kPairs; ++p) {
            const T2 piece = P::mul(xp[p], wv[p]);
            dwv[p] = i == 0 ? piece : P::add(dwv[p], piece);
          }
        };
        T2 w2[K > 0 ? K : 1][kPairs];
        if constexpr (K > 0) {
#pragma unroll
          for (int i = 0; i < K; ++i) w_of(i, w2[i]);
        }
#pragma unroll
        for (int j = 0; j < kRows / kSlotStep; ++j) {
          const int r = sr + j * kSlotStep;
          const S* xr = xs + row_slot[r] * kLx + q * kVe;
          uint4 out;
          T2* dwv = reinterpret_cast<T2*>(&out);
          if constexpr (K > 0) {
#pragma unroll
            for (int i = 0; i < K; ++i) add_tap(i, xr, w2[i], dwv);
          } else {
            for (int i = 0; i < taps; ++i) {
              T2 wv[kPairs];
              w_of(i, wv);
              add_tap(i, xr, wv, dwv);
            }
          }
          *reinterpret_cast<uint4*>(dws + r * kLx + q * kVe) = out;
        }
      }
      __syncthreads();  // the dw tile is written
#pragma unroll
      for (int kk = 0; kk < kC; kk += 16)
        mma_step<2, 4, false, true>(acc, dws + wm * kLx + kk, kLx,
                                    Bs + kk * kLb + wn, kLb, lane);
    }
  }

  // Epilogue: y rounded to S into the y tile (in place of the chunk's
  // tiles), the statistics of the rounded values, then the tile to y.
  __syncthreads();
  const int g = lane >> 2, uq = lane & 3;
  float s1[4][2], s2[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) s1[j][e] = s2[j][e] = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + 16 * i + g + 8 * h;
      const bool own = r < tile_rows && m0 + r < rows;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T2 v = P::of(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        *reinterpret_cast<T2*>(&ys[r * kLb + wn + 8 * j + 2 * uq]) = v;
        if (own) {
          const float2 f = P::f(v), f2 = P::f(P::mul(v, v));
          s1[j][0] += f.x;
          s1[j][1] += f.y;
          s2[j][0] += f2.x;
          s2[j][1] += f2.y;
        }
      }
    }
  if (stats != nullptr) {
    // over the fragment's rows (lanes of one uq), then the 4 row warps
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s1[j][e] += __shfl_xor_sync(0xffffffffu, s1[j][e], off);
          s2[j][e] += __shfl_xor_sync(0xffffffffu, s2[j][e], off);
        }
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[0][warp & 3][wn + 8 * j + 2 * uq + e] = s1[j][e];
          red[1][warp & 3][wn + 8 * j + 2 * uq + e] = s2[j][e];
        }
    }
  }
  __syncthreads();  // the y tile and the warps' sums are written
  if (stats != nullptr && tid < 2 * kCols) {
    const int col = tid % kCols, which = tid / kCols;
    if (n0 + col < cout) {
      const float sum = red[which][0][col] + red[which][1][col] +
                        red[which][2][col] + red[which][3][col];
      atomicAdd(&stats[which * cout + n0 + col], sum);
    }
  }
  constexpr int kYGroups = kCols / kVe;
  for (int e = tid; e < kRows * kYGroups; e += kThreads) {
    const int r = e / kYGroups, gq = e % kYGroups;
    const int m = m0 + r, n = n0 + gq * kVe;
    if (r >= tile_rows || m >= rows || n >= cout) continue;
    store16(y + m * cout + n,
            *reinterpret_cast<const uint4*>(ys + r * kLb + gq * kVe),
            cout - n, wvec);
  }
}

int64_t div_up(int64_t n, int64_t d) { return (n + d - 1) / d; }

// The x tile's slots for a tile of `r` rows: min(stride, k) per row, and
// k - that at the last row of each of the (at most) (r - 1) / To + 2 batch
// rows it crosses.
int64_t tile_slots(int64_t r, int64_t k, int64_t stride, int64_t t_out) {
  const int64_t u = stride < k ? stride : k;
  const int64_t crossed = (r - 1) / t_out + 2;
  return u * r + (k - u) * (crossed < r ? crossed : r);
}

template <typename S, bool kFold, int K>
int launch_kernel(const S* x, const float* a, const float* b, const S* w_dw,
                  const S* w, S* y, float* stats, int64_t batch, int64_t t_in,
                  int64_t cin, int64_t cout, int64_t k, int64_t stride,
                  int64_t pad_lo, int64_t t_out, cudaStream_t stream) {
  const int64_t slot_bytes = kLdX<S> * sizeof(S) + sizeof(int);
  // the largest row tile whose x tile fits
  int64_t tile_rows = kRows;
  while (tile_rows > 1 &&
         tile_slots(tile_rows, k, stride, t_out) * slot_bytes > kMaxDynBytes)
    tile_rows /= 2;
  const int64_t max_slots = tile_slots(tile_rows, k, stride, t_out);
  const int64_t dyn = max_slots * slot_bytes;
  if (dyn > kMaxDynBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = separable_block_kernel<S, kFold, K>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks =
      div_up(batch * t_out, tile_rows) * div_up(cout, kCols);
  kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(dyn),
           stream>>>(x, a, b, w_dw, w, y, stats, static_cast<int>(batch),
                     static_cast<int>(t_in), static_cast<int>(cin),
                     static_cast<int>(cout), static_cast<int>(k),
                     static_cast<int>(stride), static_cast<int>(pad_lo),
                     static_cast<int>(t_out), static_cast<int>(tile_rows),
                     static_cast<int>(max_slots));
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch(const void* x, const void* a, const void* b, const void* w_dw,
           const void* w, void* y, void* stats, int64_t batch, int64_t t_in,
           int64_t cin, int64_t cout, int64_t k, int64_t stride,
           int64_t pad_lo, int64_t t_out, int fold, void* stream) {
  if (stats != nullptr) {  // the blocks add into it
    const cudaError_t err = cudaMemsetAsync(
        stats, 0, 2 * cout * sizeof(float), static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (batch * t_out == 0 || cout == 0) return 0;
  if (k < 1 || k > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  // k = 3, the trunk's, has builds of its own
  auto fn = fold ? (k == 3 ? launch_kernel<S, true, 3>
                           : launch_kernel<S, true, 0>)
                 : (k == 3 ? launch_kernel<S, false, 3>
                           : launch_kernel<S, false, 0>);
  return fn(static_cast<const S*>(x), static_cast<const float*>(a),
            static_cast<const float*>(b), static_cast<const S*>(w_dw),
            static_cast<const S*>(w), static_cast<S*>(y),
            static_cast<float*>(stats), batch, t_in, cin, cout, k, stride,
            pad_lo, t_out, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points for ctypes: every pointer and the stream as void*,
// sizes as int64, `fold` 0 or 1. `a` and `b` are f32 [Cin] or both null (no
// prologue); `stats` is an f32 [2, Cout], which the entry zeroes on the
// stream before the launch, or null (no statistics).
// `w_dw`, `w`, `x` and `y` are in the entry's compute type, `x`, `w` and `y`
// 16-byte aligned. k is at most 1024. They return cudaGetLastError() after
// the launch (0 when the launch was accepted).
extern "C" int separable_block_bf16(const void* x, const void* a, const void* b,
                                    const void* w_dw, const void* w, void* y,
                                    void* stats, int64_t batch, int64_t t_in,
                                    int64_t cin, int64_t cout, int64_t k,
                                    int64_t stride, int64_t pad_lo,
                                    int64_t t_out, int fold, void* stream) {
  return launch<bf16>(x, a, b, w_dw, w, y, stats, batch, t_in, cin, cout, k,
                      stride, pad_lo, t_out, fold, stream);
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
