// The 1-D depthwise convolution for Hopper (sm_90a), forward and backward,
// with TF's zero pad applied inside: one launch forward; one backward launch
// that gives the input's and the weight's gradients from one read of x and
// dy, and a small launch that adds the weight gradient's partial sums in a
// fixed order.
//
// Replaces no TPU kernel: the JAX package's depthwise conv is flax's
// nn.Conv with feature_group_count = C, which XLA compiles. The port ran
// ATen's: an F.pad copy for SAME, then conv_depthwise2d's forward, input
// gradient and weight gradient kernels, a 1-D conv treated as a 2-D one of
// height 1 (models/layers.py Conv, the CPU path still), the largest op
// class in four of the benchmark's five cells at about a tenth of its
// bytes.
//
// x is [B, C, T] contiguous, w [C, K] float32 (the master weights: read
// as they are, so no cast of them runs), y and dy [B, C, T_out]. With a
// left pad L (TF SAME puts total // 2 on the left; VALID pads 0), and
// x_pad[p] = x[p] for 0 <= p < T, 0 outside:
//
//   forward:   y[b, c, o]  = sum_j w[c, j] x_pad[b, c, o s - L + j]
//   backward:  dx[b, c, p] = sum over (o, j) with o s - L + j = p of
//                            w[c, j] dy[b, c, o]   (a pad position dropped)
//              dw[c, j]    = sum_b sum_o dy[b, c, o] x_pad[b, c, o s - L + j]
//
// Every sum in float32: over the taps j in ascending order for y and dx;
// dw in a fixed tree (below), so two launches give the same bits. y and dx
// are stored in x's dtype, dw in float32.
//
// Bound: bytes. The function has to read x and write y forward, read x and
// dy and write dx backward: three reads or writes of an x-sized tensor and
// two of a y-sized one a conv; the operations (2 K a product) are far below
// the card's ridge. What the design does about it:
//
// 1. Tiles. A block takes a tile: `cb` channels by an output slice
//    [o0, o1) of `tt` outputs, at most kSlots outputs in all, and a split
//    of `per` batch rows. A row of up to tt outputs is taken whole, as many
//    channels of it as fit, so that in each batch row the tile's x, y, dy
//    and dx are each one contiguous run of memory (short rows: many (b, c)
//    rows of the flattened tensor a block). A longer row is cut into
//    slices, one channel a tile, each with its halo of x and dy. The
//    wrapper (ops/kernels/dwconv1d.py plan) picks the tile from the input's
//    shape alone, a batch row's runs within kStageBytes, and the split so
//    that about four blocks an SM fill the card at 32 channels as at 1,536.
// 2. Staging. A ring of kStages stages in shared memory, each as many batch
//    rows of the tile's x (and dy) runs as fit in kStageBytes, copied by
//    cp.async in 16-byte vectors aligned as the tensor (so whatever a row's
//    alignment, every vector but the tensor's last is whole; that one is
//    filled with zeros past the end), the next kStages - 1 stages in flight
//    while one is used. A thread computes an element at a time from shared
//    memory into a shared run of y (dx), the neighbouring threads on
//    neighbouring elements, and the run goes to y (dx) in 16-byte vectors,
//    its partial first and last vector element by element.
// 3. Forward (dwconv1d_fw_kernel): each thread owns up to kSlotsPerThread
//    outputs of the tile (the same channel and step in every batch row:
//    their taps' places and weights in registers), for each batch row.
// 4. Backward (dwconv1d_bw_kernel): in each batch row, dy x into the
//    threads' f32 registers, for the same slots as the forward's, and the
//    row's dx, a position a thread at a time. After the last row the
//    slots' sums go through shared memory to one sum a (channel, tap) in a
//    fixed order (a thread's serial sum for short rows, a warp's lanes and
//    then a butterfly of shuffles for long ones): one partial sum a block.
// 5. dwconv1d_merge_kernel adds the splits' partial sums of each (c, j) in
//    split order. No float atomics.
//
// The taps are compiled in, for each K up to kMaxTaps, so that a window's
// taps are unrolled and its sums live in registers; the stride, the pad and
// every length are read at run time.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kSlotsPerThread = 4;
constexpr int kSlots = kThreads * kSlotsPerThread;  // outputs a tile
constexpr int kMaxTaps = 5;
constexpr int kStages = 4;           // the ring of staged batch rows
constexpr int kStageBytes = 8192;    // the most bytes of a stage
constexpr int kShortRow = 64;        // a (c, j) sum by one thread up to this
constexpr int kBwBlocks = 4;         // backward blocks an SM holds at once
constexpr int kMaxSmem = 48 * 1024;  // shared memory a block, no opt-in

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

__host__ __device__ Div make_div(uint32_t d) {
  Div v;
  for (v.s = 0; v.s < 32; ++v.s) {
    if ((1u << v.s) >= d) break;
  }
  const uint64_t one = 1;
  v.m = static_cast<uint32_t>(((one << 32) * ((one << v.s) - d)) / d + 1);
  return v;
}

struct Plan {
  int batch, channels, steps, outs;   // B, C, T, T_out
  int stride, left;
  int cb, tt, slices, per;            // the tile; batch rows a block
  int xcap, dcap, ocap;               // elements of a row's staged x, dy, y
  int nb_fw, nb_bw;                   // batch rows a stage
  int64_t x_elems, y_elems;           // B C T, B C T_out
  Div by_stride;
};

// A tile's channels and its runs: outputs [o0, o1), x staged [xa, xb),
// dy staged [da, o1), dx written [pa, pb) (the positions it owns)
struct Tile {
  int c0, cb, slice, o0, o1, xa, xb, da, pa, pb;
};

template <int K>
__device__ Tile tile_of(const Plan& p, int t) {
  Tile q;
  const int g = t / p.slices;
  q.slice = t - g * p.slices;
  q.c0 = g * p.cb;
  q.cb = min(p.cb, p.channels - q.c0);
  q.o0 = q.slice * p.tt;
  q.o1 = min(p.outs, q.o0 + p.tt);
  const bool last = q.o1 == p.outs;
  q.pa = q.o0 == 0 ? 0 : q.o0 * p.stride - p.left;
  q.pb = last ? p.steps : q.o1 * p.stride - p.left;
  q.xa = q.pa;
  q.xb = last ? p.steps
              : max(q.pb, min(p.steps, (q.o1 - 1) * p.stride - p.left + K));
  q.da = max(0, q.o0 - (K - 1) / p.stride);
  return q;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copies src[g0, g0 + len) (src has n elements, 16-byte aligned) to dst
// by cp.async in the 16-byte vectors of src that hold it; src[g0] lands at
// dst[g0 % V]. The tensor's last vector is filled with zeros past n.
template <typename X>
__device__ void stage(const X* __restrict__ src, int64_t n, int64_t g0,
                      int len, X* dst) {
  constexpr int V = 16 / sizeof(X);
  const int64_t v0 = g0 / V;
  const int nv = static_cast<int>((g0 + len + V - 1) / V - v0);
  for (int i = threadIdx.x; i < nv; i += kThreads) {
    const int64_t e = (v0 + i) * V;
    const int bytes =
        e + V <= n ? 16 : static_cast<int>((n - e) * sizeof(X));
    cp_async16(dst + i * V, src + e, bytes);
  }
}

template <typename X>
__device__ __forceinline__ int lead(int64_t g0) {
  return static_cast<int>(g0 % (16 / sizeof(X)));
}

// the most 16-byte vectors a run of len elements touches
template <typename X>
__host__ __device__ int vectors(int len) {
  return (len + 16 / sizeof(X) - 1) / (16 / sizeof(X)) + 1;
}

// Copies each of `rows` runs from shared memory to out: run r is
// out[g0(r), g0(r) + len), held at buf + r * cap + g0(r) % V; by 16-byte
// vectors where they lie whole in the run, element by element at its
// partial ends. The block's threads take the vectors of all the rows at
// once.
template <typename X, typename G0>
__device__ void copy_out(X* __restrict__ out, int rows, int len,
                         const X* buf, int cap, const Div& by_nvm,
                         G0 g0_of) {
  constexpr int V = 16 / sizeof(X);
  const int nvm = vectors<X>(len);
  for (int idx = threadIdx.x; idx < rows * nvm; idx += kThreads) {
    const int r = by_nvm(idx), i = idx - r * nvm;
    const int64_t g0 = g0_of(r);
    const int64_t v0 = g0 / V;
    if (v0 + i > (g0 + len - 1) / V) continue;
    const int64_t e0 = (v0 + i) * V;
    const int l = static_cast<int>(e0 - g0);
    const X* src = buf + r * cap + i * V;
    if (l >= 0 && l + V <= len) {
      *reinterpret_cast<uint4*>(out + e0) =
          *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (l + e >= 0 && l + e < len) out[e0 + e] = src[e];
      }
    }
  }
}

// A ring of kStages stages in shared memory, each nb batch rows of a
// tile's runs; load(i, buf) issues stage i's copies into buffer buf. Runs
// body(i, buf) for each of the n stages in turn, with the copies of the
// kStages - 1 stages after it in flight.
template <typename Load, typename Body>
__device__ void pipeline(int n, Load& load, Body& body) {
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) load(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    if (i + kStages - 1 < n) load(i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    body(i, i % kStages);
    __syncthreads();
  }
}

// A thread's slots: outputs q = threadIdx.x + u kThreads of the tile
// (channel cl = q / olen, step o = o0 + q % olen), the same in every batch
// row: where tap 0 of each lies in a row's staged x run (counted from the
// run's first position xa), where its dy lies in the staged dy run, and
// which of its taps fall inside the row.
template <int K>
struct Slots {
  int xo[kSlotsPerThread], doff[kSlotsPerThread], cl[kSlotsPerThread];
  unsigned taps[kSlotsPerThread];
  __device__ Slots(const Plan& p, const Tile& q, int xlen, int dlen) {
    const int olen = q.o1 - q.o0;
#pragma unroll
    for (int u = 0; u < kSlotsPerThread; ++u) {
      const int s = threadIdx.x + u * kThreads;
      cl[u] = s / olen;
      const int o = q.o0 + s - cl[u] * olen;
      const int a = o * p.stride - p.left;
      xo[u] = cl[u] * xlen + a - q.xa;
      doff[u] = cl[u] * dlen + o - q.da;
      taps[u] = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (s < q.cb * olen && a + j >= 0 && a + j < p.steps) {
          taps[u] |= 1u << j;
        }
      }
    }
  }
};

// blocks: (tile, split of the batch rows). Each batch row's y of the tile:
// a thread's slots from the staged x run into a shared y run, then the run
// to y by vectors.
template <typename X, int K>
__global__ void __launch_bounds__(kThreads)
dwconv1d_fw_kernel(const X* __restrict__ x, const float* __restrict__ w,
                   X* __restrict__ y, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  X* const sx = reinterpret_cast<X*>(smem);
  const Tile q = tile_of<K>(p, blockIdx.x);
  const int b0 = blockIdx.y * p.per, b1 = min(p.batch, b0 + p.per);
  const int xlen = q.xb - q.xa, olen = q.o1 - q.o0, slots = q.cb * olen;
  const int nb = p.nb_fw, stage_elems = nb * p.xcap;
  X* const sy = sx + kStages * stage_elems;
  const Slots<K> sl(p, q, xlen, 0);
  float wt[kSlotsPerThread][K];
#pragma unroll
  for (int u = 0; u < kSlotsPerThread; ++u) {
    const int c = min(q.c0 + sl.cl[u], p.channels - 1);
#pragma unroll
    for (int j = 0; j < K; ++j) wt[u][j] = __ldg(w + c * K + j);
  }
  const Div by_nvm = make_div(vectors<X>(slots));
  auto load = [&](int i, int buf) {
    for (int r = 0, b = b0 + i * nb; r < nb && b < b1; ++r, ++b) {
      const int64_t row = static_cast<int64_t>(b) * p.channels + q.c0;
      stage(x, p.x_elems, row * p.steps + q.xa, q.cb * xlen,
            sx + buf * stage_elems + r * p.xcap);
    }
  };
  auto body = [&](int i, int buf) {
    const int b = b0 + i * nb, rows = min(nb, b1 - b);
    const int64_t row0 = static_cast<int64_t>(b) * p.channels + q.c0;
    auto gy = [&](int r) {
      return (row0 + static_cast<int64_t>(r) * p.channels) * p.outs + q.o0;
    };
    for (int r = 0; r < rows; ++r) {
      const int64_t row = row0 + static_cast<int64_t>(r) * p.channels;
      const X* xs = sx + buf * stage_elems + r * p.xcap +
                    lead<X>(row * p.steps + q.xa);
      X* ys = sy + r * p.ocap + lead<X>(gy(r));
#pragma unroll
      for (int u = 0; u < kSlotsPerThread; ++u) {
        const int s = threadIdx.x + u * kThreads;
        if (s < slots) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            if (sl.taps[u] >> j & 1u) {
              acc = fmaf(wt[u][j], to_f(xs[sl.xo[u] + j]), acc);
            }
          }
          ys[s] = from_f<X>(acc);
        }
      }
    }
    __syncthreads();
    copy_out(y, rows, slots, sy, p.ocap, by_nvm, gy);
  };
  pipeline((b1 - b0 + nb - 1) / nb, load, body);
}

// dx (when it is not null) and each block's partial sums of dw, written to
// partial[split * slices + slice][c][j]. In each batch row: dy x into the
// thread's slots' f32 sums; each position of the tile's dx run from the
// staged dy run into a shared dx run, then the run to dx by vectors.
template <typename X, int K>
__global__ void __launch_bounds__(kThreads, kBwBlocks)
dwconv1d_bw_kernel(const X* __restrict__ x, const X* __restrict__ dy,
                   const float* __restrict__ w, X* __restrict__ dx,
                   float* __restrict__ partial, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  X* const sm = reinterpret_cast<X*>(smem);
  const Tile q = tile_of<K>(p, blockIdx.x);
  const int b0 = blockIdx.y * p.per, b1 = min(p.batch, b0 + p.per);
  const int xlen = q.xb - q.xa, dlen = q.o1 - q.da, olen = q.o1 - q.o0;
  const int plen = q.pb - q.pa, slots = q.cb * olen, run = q.cb * plen;
  const int nb = p.nb_bw, stage_elems = nb * (p.xcap + p.dcap);
  X* const sdx = sm + kStages * stage_elems;
  const Div by_plen = make_div(plen), by_nvm = make_div(vectors<X>(run));
  const float* wt = w + static_cast<int64_t>(q.c0) * K;
  const Slots<K> sl(p, q, xlen, dlen);
  float acc[kSlotsPerThread][K];
#pragma unroll
  for (int u = 0; u < kSlotsPerThread; ++u) {
#pragma unroll
    for (int j = 0; j < K; ++j) acc[u][j] = 0.f;
  }

  auto load = [&](int i, int buf) {
    X* base = sm + buf * stage_elems;
    for (int r = 0, b = b0 + i * nb; r < nb && b < b1; ++r, ++b) {
      const int64_t row = static_cast<int64_t>(b) * p.channels + q.c0;
      stage(x, p.x_elems, row * p.steps + q.xa, q.cb * xlen,
            base + r * p.xcap);
      stage(dy, p.y_elems, row * p.outs + q.da, q.cb * dlen,
            base + nb * p.xcap + r * p.dcap);
    }
  };
  auto body = [&](int i, int buf) {
    const X* base = sm + buf * stage_elems;
    const int b = b0 + i * nb, rows = min(nb, b1 - b);
    const int64_t row0 = static_cast<int64_t>(b) * p.channels + q.c0;
    auto gdx = [&](int r) {
      return (row0 + static_cast<int64_t>(r) * p.channels) * p.steps + q.pa;
    };
    for (int r = 0; r < rows; ++r) {
      const int64_t row = row0 + static_cast<int64_t>(r) * p.channels;
      const X* xs = base + r * p.xcap + lead<X>(row * p.steps + q.xa);
      const X* ds = base + nb * p.xcap + r * p.dcap +
                    lead<X>(row * p.outs + q.da);
#pragma unroll
      for (int u = 0; u < kSlotsPerThread; ++u) {
        if (sl.taps[u]) {
          const float g = to_f(ds[sl.doff[u]]);
#pragma unroll
          for (int j = 0; j < K; ++j) {
            if (sl.taps[u] >> j & 1u) {
              acc[u][j] = fmaf(g, to_f(xs[sl.xo[u] + j]), acc[u][j]);
            }
          }
        }
      }
      if (dx == nullptr) continue;
      // position pa + pl of channel cl gathers the windows o = oh - m
      // that hold it as tap rem + m s (for s = 1: o = a - j)
      X* dxs = sdx + r * p.xcap + lead<X>(gdx(r));
      for (int e = threadIdx.x; e < run; e += kThreads) {
        const int cl = by_plen(e), pl = e - cl * plen;
        const int a = q.pa + pl + p.left;
        const X* dr = ds + cl * dlen - q.da;
        const float* wc = wt + cl * K;
        float v = 0.f;
        if (p.stride == 1) {
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int o = a - j;
            if (o >= 0 && o < p.outs) v = fmaf(__ldg(wc + j), to_f(dr[o]), v);
          }
        } else {
          const int oh = p.by_stride(a), rem = a - oh * p.stride;
#pragma unroll
          for (int m = 0; m < K; ++m) {
            const int j = rem + m * p.stride, o = oh - m;
            if (j < K && o >= 0 && o < p.outs) {
              v = fmaf(__ldg(wc + j), to_f(dr[o]), v);
            }
          }
        }
        dxs[e] = from_f<X>(v);
      }
    }
    if (dx != nullptr) {
      __syncthreads();
      copy_out(dx, rows, run, sdx, p.xcap, by_nvm, gdx);
    }
  };
  pipeline((b1 - b0 + nb - 1) / nb, load, body);

  // the slots' sums, then one sum a (channel, tap) in a fixed order
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int u = 0; u < kSlotsPerThread; ++u) {
    const int s = threadIdx.x + u * kThreads;
    if (s < slots) {
#pragma unroll
      for (int j = 0; j < K; ++j) red[s * K + j] = acc[u][j];
    }
  }
  __syncthreads();
  float* out = partial +
      (static_cast<int64_t>(blockIdx.y) * p.slices + q.slice) * p.channels * K +
      static_cast<int64_t>(q.c0) * K;
  const int pairs = q.cb * K;
  if (olen <= kShortRow) {
    for (int i = threadIdx.x; i < pairs; i += kThreads) {
      const int cl = i / K, j = i - cl * K;
      const float* r = red + cl * olen * K + j;
      float v = 0.f;
      for (int ol = 0; ol < olen; ++ol) v += r[ol * K];
      out[i] = v;
    }
  } else {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = warp; i < pairs; i += kThreads / 32) {
      const int cl = i / K, j = i - cl * K;
      const float* r = red + cl * olen * K + j;
      float v = 0.f;
      for (int ol = lane; ol < olen; ol += 32) v += r[ol * K];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
      if (lane == 0) out[i] = v;
    }
  }
}

// dw[i] = sum over parts of partial[part][i], in part order
__global__ void __launch_bounds__(kThreads)
dwconv1d_merge_kernel(const float* __restrict__ partial,
                      float* __restrict__ dw, int parts, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int k = 0; k < parts; ++k) v += partial[static_cast<int64_t>(k) * n + i];
  dw[i] = v;
}

// ---- launches -----------------------------------------------------------------

constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);
constexpr int64_t kMaxElements = (int64_t(1) << 31) - 1;

int64_t round_up(int64_t n, int64_t m) { return (n + m - 1) / m * m; }

// Checks the shape and the tile the wrapper chose and fills the plan; false
// for what the kernels do not take.
bool plan(int64_t batch, int64_t channels, int64_t steps, int64_t outs,
          int64_t taps, int64_t stride, int64_t left, int64_t cb, int64_t tt,
          int64_t per, int64_t item, Plan* p) {
  // every window starts inside the row or its left pad, every slice
  // boundary inside the row
  if (batch < 1 || channels < 1 || steps < 1 || outs < 1 || taps < 1 ||
      taps > kMaxTaps || stride < 1 || left < 0 || left >= taps ||
      (outs - 1) * stride - left >= steps || cb < 1 || tt < 1 || per < 1 ||
      cb * tt > kSlots || (cb > 1 && tt != outs) || tt > outs ||
      cb > channels || (tt < outs && tt * stride < left)) {
    return false;
  }
  if (batch * channels * steps > kMaxElements ||
      batch * channels * outs > kMaxElements) {
    return false;
  }
  const int64_t v = 16 / item;
  const int64_t slices = (outs + tt - 1) / tt;
  // the longest x and dy runs of a tile and batch row, with room for their
  // first and last vectors
  const int64_t xlen = slices == 1 ? cb * steps : tt * stride + 2 * taps;
  const int64_t dlen = slices == 1 ? cb * outs : tt + taps - 1;
  const int64_t ylen = slices == 1 ? cb * outs : tt;
  const int64_t xcap = round_up(xlen + 2 * v, v);
  const int64_t dcap = round_up(dlen + 2 * v, v);
  if ((xcap + dcap) * item > kStageBytes) return false;
  p->xcap = static_cast<int>(xcap);
  p->dcap = static_cast<int>(dcap);
  p->ocap = static_cast<int>(round_up(ylen + 2 * v, v));
  p->nb_fw = static_cast<int>(std::min<int64_t>(per, kStageBytes / (xcap * item)));
  p->nb_bw = static_cast<int>(
      std::min<int64_t>(per, kStageBytes / ((xcap + dcap) * item)));
  p->batch = static_cast<int>(batch);
  p->channels = static_cast<int>(channels);
  p->steps = static_cast<int>(steps);
  p->outs = static_cast<int>(outs);
  p->stride = static_cast<int>(stride);
  p->left = static_cast<int>(left);
  p->cb = static_cast<int>(cb);
  p->tt = static_cast<int>(tt);
  p->slices = static_cast<int>(slices);
  p->per = static_cast<int>(per);
  p->x_elems = batch * channels * steps;
  p->y_elems = batch * channels * outs;
  p->by_stride = make_div(static_cast<uint32_t>(stride));
  return true;
}

int tiles(const Plan& p) {
  return (p.channels + p.cb - 1) / p.cb * p.slices;
}
int splits(const Plan& p) { return (p.batch + p.per - 1) / p.per; }

// shared memory: the ring, then the y (dx) runs of a stage; the backward's
// sums of its slots later reuse it from the start
template <typename X>
size_t fw_smem(const Plan& p) {
  return static_cast<size_t>(p.nb_fw) *
         (kStages * p.xcap + p.ocap) * sizeof(X);
}

template <typename X, int K>
size_t bw_smem(const Plan& p) {
  const size_t staged = static_cast<size_t>(p.nb_bw) *
                        (kStages * (p.xcap + p.dcap) + p.xcap) * sizeof(X);
  const size_t reduced = static_cast<size_t>(p.cb) * p.tt * K * sizeof(float);
  return std::max(staged, reduced);
}

template <typename X, int K>
int fw_launch(const Plan& p, const void* x, const void* w, void* y,
              cudaStream_t s) {
  if (fw_smem<X>(p) > kMaxSmem) return kBad;
  dwconv1d_fw_kernel<X, K>
      <<<dim3(tiles(p), splits(p)), kThreads, fw_smem<X>(p), s>>>(
          static_cast<const X*>(x), static_cast<const float*>(w),
          static_cast<X*>(y), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename X, int K>
int bw_launch(const Plan& p, const void* x, const void* dy, const void* w,
              void* dx, void* partial, void* dw, cudaStream_t s) {
  if (bw_smem<X, K>(p) > kMaxSmem) return kBad;
  dwconv1d_bw_kernel<X, K>
      <<<dim3(tiles(p), splits(p)), kThreads, bw_smem<X, K>(p), s>>>(
          static_cast<const X*>(x), static_cast<const X*>(dy),
          static_cast<const float*>(w), static_cast<X*>(dx),
          static_cast<float*>(partial), p);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n = p.channels * K;
  dwconv1d_merge_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw),
      splits(p) * p.slices, n);
  return static_cast<int>(cudaGetLastError());
}

#define DWCONV_BY_TAPS(taps, FN, ...)                   \
  switch (taps) {                                       \
    case 1: return FN<X, 1>(__VA_ARGS__);               \
    case 2: return FN<X, 2>(__VA_ARGS__);               \
    case 3: return FN<X, 3>(__VA_ARGS__);               \
    case 4: return FN<X, 4>(__VA_ARGS__);               \
    case 5: return FN<X, 5>(__VA_ARGS__);               \
    default: return kBad;                               \
  }

template <typename X>
int fw(int taps, const Plan& p, const void* x, const void* w, void* y,
       cudaStream_t s) {
  DWCONV_BY_TAPS(taps, fw_launch, p, x, w, y, s)
}

template <typename X>
int bw(int taps, const Plan& p, const void* x, const void* dy, const void* w,
       void* dx, void* partial, void* dw, cudaStream_t s) {
  DWCONV_BY_TAPS(taps, bw_launch, p, x, dy, w, dx, partial, dw, s)
}

int item_size(int dtype) {
  return dtype == 0 ? 4 : (dtype == 1 || dtype == 2 ? 2 : 0);
}

}  // namespace

// The C interface. dtype: 0 float32, 1 bfloat16, 2 float16 (x, y, dy and
// dx alike); w, dw and partial float32. x [batch, channels, steps], y and
// dy [batch, channels, outs], w and dw [channels, taps], partial
// [ceil(batch / per) ceil(outs / tt), channels, taps], all contiguous, x
// and dy 16-byte aligned; dx may be null (no input gradient). The wrapper
// (ops/kernels/dwconv1d.py) checks devices, dtypes, shapes and contiguity,
// works out outs and left from the padding, picks the tile (cb channels of
// tt outputs, per batch rows a backward block) and allocates the outputs.
// Each entry returns cudaGetLastError() after its launches (0 when they
// were taken), or cudaErrorInvalidValue for a shape, tile or dtype it does
// not take.

#define DWCONV_BY_DTYPE(dtype, FN, ...)                 \
  switch (dtype) {                                      \
    case 0: return FN<float>(__VA_ARGS__);              \
    case 1: return FN<bf16>(__VA_ARGS__);               \
    case 2: return FN<__half>(__VA_ARGS__);             \
    default: return kBad;                               \
  }

extern "C" int dwconv1d_fw(int dtype, const void* x, const void* w, void* y,
                           int64_t batch, int64_t channels, int64_t steps,
                           int64_t outs, int64_t taps, int64_t stride,
                           int64_t left, int64_t cb, int64_t tt, int64_t per,
                           void* stream) {
  Plan p;
  if (item_size(dtype) == 0 ||
      !plan(batch, channels, steps, outs, taps, stride, left, cb, tt, per,
            item_size(dtype), &p)) {
    return kBad;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = static_cast<int>(taps);
  DWCONV_BY_DTYPE(dtype, fw, k, p, x, w, y, s)
}

extern "C" int dwconv1d_bw(int dtype, const void* x, const void* dy,
                           const void* w, void* dx, void* partial, void* dw,
                           int64_t batch, int64_t channels, int64_t steps,
                           int64_t outs, int64_t taps, int64_t stride,
                           int64_t left, int64_t cb, int64_t tt, int64_t per,
                           void* stream) {
  Plan p;
  if (item_size(dtype) == 0 ||
      !plan(batch, channels, steps, outs, taps, stride, left, cb, tt, per,
            item_size(dtype), &p)) {
    return kBad;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = static_cast<int>(taps);
  DWCONV_BY_DTYPE(dtype, bw, k, p, x, dy, w, dx, partial, dw, s)
}

extern "C" const char* dwconv1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
