// Train-mode BatchNorm for Hopper (sm_90a): the batch statistics taken once,
// in f32, straight from the activation in its own dtype, then the
// normalisation; the backward's two per-channel sums, then the input's
// gradient. Two launches a direction.
//
// Replaces no TPU kernel: the JAX package's BatchNorm is flax's, which XLA
// fuses. The port ran ATen's: an f32 copy of the activation and
// torch.var_mean over it (for the running statistics), then
// F.batch_norm's own statistics and normalisation, and its backward
// kernel (models/layers.py BatchNorm, the CPU path still).
//
// x is [B, C, T] contiguous (T = 1 for [B, C], H W for NCHW); a channel's
// statistics run over B and T. With N = B T, per channel c:
//
//   forward:   mean = K + S1 / N,  var = S2 / N - (S1 / N)^2,
//              S1 = sum (x - K),  S2 = sum (x - K)^2,  K = x[0, c, 0]
//              invstd = 1 / sqrt(var + eps)
//              y = (x - mean) invstd gamma + beta
//   backward:  dbeta = sum dy,  dgamma = invstd sum dy (x - mean)
//              dx = gamma invstd (dy - dbeta / N - xhat dgamma / N),
//              xhat = (x - mean) invstd
//
// The pivot K (the channel's first element) keeps the shifted sums near
// the spread of the data, so the variance does not cancel as E[x^2] -
// E[x]^2 would for a channel whose mean is far from 0.
//
// Bound: below the card's ridge, so bytes alone. The function has to read
// x and write y forward, read x and dy and write dx backward: 10 B an
// element in bf16. This design reads x once more forward and x and dy once
// more backward (16 B), the second reads meant to come from L2: the
// consumer kernel walks the tiles in the reverse of the order in which the
// reducing kernel read them.
//
// 1. Tiles. A block takes one tile: the rows of one of `rg` row groups
//    (rg = min(8, B), set by the wrapper, which allocates the partial sums
//    [rg, 2, C]) and the channels of one channel group, about as many
//    tiles as the card holds blocks of the kernel at once (asked of the
//    CUDA occupancy calculator), so that one wave runs them all and no
//    block waits for another to end. In each row of its group the tile is one
//    contiguous run of its channels' elements. The reducing and the
//    consumer kernels group the channels each their own way; the partial
//    sums are per channel.
// 2. Reducing kernels (bn_fw_stats_kernel, bn_bw_reduce_kernel). Each
//    thread owns one W-element slot of the run, W elements aligned as the
//    tensor (W = 16 bytes of x where a row's C T elements are a multiple of
//    it, so every row puts its run at the same alignment; 1 element
//    otherwise), in every row of one phase of the group's rows: the
//    channel of each of its elements is the same in every row, and it sums
//    them in registers, four rows' loads in flight at a time. The threads'
//    sums then go through shared memory and a fixed tree of warp shuffles
//    to a per-channel sum. No float atomics: a launch gives the same bits
//    every time.
// 3. Consumer kernels (bn_fw_apply_kernel, bn_bw_dx_kernel). Each block
//    first adds the rg partial sums of its channels, in row-group order,
//    and derives the channels' coefficients (the blocks of row group 0
//    also store mean, var and invstd, or dgamma and dbeta); then it maps
//    its runs with 16-byte loads and stores (a run's unaligned first and
//    last vector element by element), finding each element's channel by a
//    multiply-shift division of its position by T.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxRowGroups = 8;       // the wrapper's ROW_GROUPS
constexpr int kRows = 4;               // rows a reducing thread loads at once

// f32 <-> X, one element or one of a 16-byte vector's (as four 32-bit words)
template <typename X>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static float get(const uint32_t* w, int i) {
    return __uint_as_float(w[i]);
  }
  __device__ static void put(uint32_t* w, int i, float v) {
    w[i] = __float_as_uint(v);
  }
};

template <>
struct Elem<bf16> {
  static constexpr int kVec = 8;
  __device__ static float load(const bf16* p) { return __bfloat162float(*p); }
  __device__ static void store(bf16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  __device__ static float get(const uint32_t* w, int i) {
    return __uint_as_float(((w[i >> 1] >> (16 * (i & 1))) & 0xffffu) << 16);
  }
  __device__ static void put(uint32_t* w, int i, float v) {
    const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    const int s = 16 * (i & 1);
    w[i >> 1] = (w[i >> 1] & ~(0xffffu << s)) | (h << s);
  }
};

template <>
struct Elem<__half> {
  static constexpr int kVec = 8;
  __device__ static float load(const __half* p) { return __half2float(*p); }
  __device__ static void store(__half* p, float v) {
    *p = __float2half_rn(v);
  }
  __device__ static float get(const uint32_t* w, int i) {
    return __half2float(__ushort_as_half(
        static_cast<unsigned short>((w[i >> 1] >> (16 * (i & 1))) & 0xffffu)));
  }
  __device__ static void put(uint32_t* w, int i, float v) {
    const uint32_t h = __half_as_ushort(__float2half_rn(v));
    const int s = 16 * (i & 1);
    w[i >> 1] = (w[i >> 1] & ~(0xffffu << s)) | (h << s);
  }
};

// W elements of X from one aligned load, kept as loaded until read
template <typename X, int W>
struct Slot {
  static_assert(W == Elem<X>::kVec, "a slot is 16 bytes or one element");
  uint4 u;
  __device__ void load(const X* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ float get(int i) const {
    return Elem<X>::get(reinterpret_cast<const uint32_t*>(&u), i);
  }
};

template <typename X>
struct Slot<X, 1> {
  float f;
  __device__ void load(const X* p) { f = Elem<X>::load(p); }
  __device__ float get(int) const { return f; }
};

// n / d for 0 <= n, d < 2^31 by a multiply and a shift (the magic number
// of Granlund and Montgomery, as PyTorch's IntDivider computes it)
struct Div {
  uint32_t m, s;
  __device__ int operator()(int n) const {
    return static_cast<int>(
        (__umulhi(static_cast<uint32_t>(n), m) + static_cast<uint32_t>(n)) >> s);
  }
};

__host__ __device__ inline Div make_div(uint32_t d) {
  Div v;
  for (v.s = 0; v.s < 32; ++v.s) {
    if ((1u << v.s) >= d) break;
  }
  const uint64_t one = 1;
  v.m = static_cast<uint32_t>(((one << 32) * ((one << v.s) - d)) / d + 1);
  return v;
}

struct Geo {
  int64_t batch, channels, row;   // B, C, and C T: a batch row's elements
  int steps;                      // T
  int rg, cb, cg;                 // row groups, channels a tile, channel groups
  Div by_steps;
};

// A block's tile: channels [c0, c0 + nc), rows [b0, b1)
struct Tile {
  int64_t c0, b0, b1;
  int nc, rgi;
};

__device__ Tile tile_of(const Geo& g, int tile) {
  Tile t;
  const int cgi = tile % g.cg;
  t.rgi = tile / g.cg;
  t.c0 = static_cast<int64_t>(cgi) * g.cb;
  t.nc = static_cast<int>(min(static_cast<int64_t>(g.cb), g.channels - t.c0));
  t.b0 = t.rgi * g.batch / g.rg;
  t.b1 = (t.rgi + 1) * g.batch / g.rg;
  return t;
}

// The reducing kernels' body, for slots of W elements. Per element of
// channel c, with d = x - center: forward (kGrad false) the center is the
// pivot x[0, c, 0], s1 += d, s2 += d d; backward the center is mean[c],
// s1 += dy, s2 += dy d. Stores the tile's (s1, s2) of each channel in
// part[rgi][0..1].
//
// The run's nv slots start at its first element aligned down to W (`mis`
// elements before it, the same in every row). With nv <= 256 thread t
// takes slot t % nv in the rows b0 + t / nv, stepping by 256 / nv rows;
// a longer run has one channel (the host's tiling sees to it), and thread
// t takes slots t, t + 256, ... in every row.
template <typename X, int W, bool kGrad>
__device__ __forceinline__ void tile_sums(const X* __restrict__ x,
                                          const X* __restrict__ dy,
                                          const float* __restrict__ mean,
                                          float* __restrict__ part, const Geo g) {
  __shared__ float acc[2][kThreads * W];
  __shared__ float red[2][kThreads];

  const Tile tl = tile_of(g, blockIdx.x);
  const int tid = threadIdx.x, T = g.steps, nc = tl.nc;
  const int seg = nc * T;
  const int64_t first = tl.c0 * T;
  const int mis = static_cast<int>(first % W);
  const int nv = (mis + seg + W - 1) / W;
  const bool spread = nv <= kThreads;        // a slot a thread, rows split
  const int phases = spread ? kThreads / nv : 1;
  const int phase = spread ? tid / nv : 0;
  float s1[W], s2[W];
#pragma unroll
  for (int i = 0; i < W; ++i) s1[i] = s2[i] = 0.f;
  if (phase < phases) {
    for (int k = spread ? tid - phase * nv : tid; k < nv; k += kThreads) {
      float c[W];
      bool in[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int p = k * W + i - mis;         // the element's place in the run
        in[i] = p >= 0 && p < seg;
        const int64_t ch = tl.c0 + (in[i] ? g.by_steps(p) : 0);
        if constexpr (kGrad) {
          c[i] = mean[ch];
        } else {
          c[i] = Elem<X>::load(x + ch * T);
        }
      }
      const int64_t at = first - mis + static_cast<int64_t>(k) * W;
      for (int64_t r = tl.b0 + phase; r < tl.b1; r += kRows * phases) {
        Slot<X, W> vx[kRows], vd[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int64_t ru = r + static_cast<int64_t>(u) * phases;
          if (ru < tl.b1) {
            vx[u].load(x + ru * g.row + at);
            if constexpr (kGrad) vd[u].load(dy + ru * g.row + at);
          }
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (r + static_cast<int64_t>(u) * phases < tl.b1) {
#pragma unroll
            for (int i = 0; i < W; ++i) {
              if (in[i]) {
                const float d = vx[u].get(i) - c[i];
                if constexpr (kGrad) {
                  const float gr = vd[u].get(i);
                  s1[i] += gr;
                  s2[i] = fmaf(gr, d, s2[i]);
                } else {
                  s1[i] += d;
                  s2[i] = fmaf(d, d, s2[i]);
                }
              }
            }
          }
        }
      }
    }
  }

  // per channel: S threads (a power of two) each sum a share of its
  // elements (by phase, then step), then a fixed tree of shuffles and, past
  // a warp, one thread add their sums
  int S = 1;
  while (2 * S * nc <= kThreads) S *= 2;
  const int j = tid / S, s = tid - j * S;
  float b1 = 0.f, b2 = 0.f;
  if (spread) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      acc[0][tid * W + i] = s1[i];
      acc[1][tid * W + i] = s2[i];
    }
    __syncthreads();
    if (j < nc) {
      for (int ph = 0; ph < phases; ++ph) {
        const int base = ph * nv * W + j * T + mis;
        for (int t = s; t < T; t += S) {
          b1 += acc[0][base + t];
          b2 += acc[1][base + t];
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      b1 += s1[i];
      b2 += s2[i];
    }
  }
  const int lanes = min(S, 32);
  for (int o = lanes / 2; o > 0; o /= 2) {
    b1 += __shfl_xor_sync(0xffffffffu, b1, o);
    b2 += __shfl_xor_sync(0xffffffffu, b2, o);
  }
  if (tid % lanes == 0) {
    red[0][tid / lanes] = b1;
    red[1][tid / lanes] = b2;
  }
  __syncthreads();
  const int per = S / lanes;
  for (int c = tid; c < nc; c += kThreads) {
    float a = 0.f, b = 0.f;
    for (int i = 0; i < per; ++i) {
      a += red[0][c * per + i];
      b += red[1][c * per + i];
    }
    part[(2 * tl.rgi) * g.channels + tl.c0 + c] = a;
    part[(2 * tl.rgi + 1) * g.channels + tl.c0 + c] = b;
  }
}

// Channel c's sums over the row groups, added in their order
__device__ __forceinline__ float2 merged(const float* __restrict__ part,
                                         const Geo& g, int64_t c) {
  float a[kMaxRowGroups], b[kMaxRowGroups];
#pragma unroll
  for (int r = 0; r < kMaxRowGroups; ++r) {
    if (r < g.rg) {
      a[r] = part[(2 * r) * g.channels + c];
      b[r] = part[(2 * r + 1) * g.channels + c];
    }
  }
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxRowGroups; ++r) {
    if (r < g.rg) {
      sa += a[r];
      sb += b[r];
    }
  }
  return make_float2(sa, sb);
}

// The consumer kernels' map over a tile: out = apply(coef(j), x, dy) for
// each element of the tile's runs, j its channel (local); dy is read where
// kGrad. The runs' 16-byte vectors (aligned down from each run's start, nv
// a row) are numbered over the tile's rows and dealt to the threads four
// at a time, their loads issued before any of their stores; a vector only
// partly in the run goes element by element.
template <typename X, bool kGrad, typename Coef, typename Apply>
__device__ __forceinline__ void map_tile(const Geo& g, const Tile& tl,
                                         const X* __restrict__ x,
                                         const X* __restrict__ dy,
                                         X* __restrict__ out, Coef coef,
                                         Apply apply) {
  constexpr int kVec = Elem<X>::kVec;
  constexpr int kUnroll = 4;
  const int T = g.steps, seg = tl.nc * T;
  const int nv = (seg + kVec - 1) / kVec + 1;
  const Div by_nv = make_div(static_cast<uint32_t>(nv));
  const int n = static_cast<int>(tl.b1 - tl.b0) * nv;
  for (int v0 = threadIdx.x; v0 < n; v0 += kUnroll * kThreads) {
    uint4 rx[kUnroll], rd[kUnroll];
    int64_t at[kUnroll];        // the vector's first element
    int p[kUnroll];             // its place in the run
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      p[u] = seg;
      at[u] = 0;
      if (v < n) {
        const int ri = by_nv(v), k = v - ri * nv;
        const int64_t start = (tl.b0 + ri) * g.row + tl.c0 * T;
        const int mis = static_cast<int>(start & (kVec - 1));
        p[u] = k * kVec - mis;
        at[u] = start - mis + static_cast<int64_t>(k) * kVec;
        if (p[u] >= 0 && p[u] + kVec <= seg) {
          rx[u] = __ldg(reinterpret_cast<const uint4*>(x + at[u]));
          if constexpr (kGrad) {
            rd[u] = __ldg(reinterpret_cast<const uint4*>(dy + at[u]));
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p[u] >= seg) continue;
      const int lo = max(0, -p[u]), hi = min(kVec, seg - p[u]);
      int j = g.by_steps(p[u] + lo), t = p[u] + lo - j * T;
      auto k = coef(j);
      if (lo == 0 && hi == kVec) {
        uint4 ro = make_uint4(0, 0, 0, 0);
        const uint32_t* wx = reinterpret_cast<const uint32_t*>(&rx[u]);
        const uint32_t* wd = reinterpret_cast<const uint32_t*>(&rd[u]);
        uint32_t* wo = reinterpret_cast<uint32_t*>(&ro);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          float d = 0.f;
          if constexpr (kGrad) d = Elem<X>::get(wd, i);
          Elem<X>::put(wo, i, apply(k, Elem<X>::get(wx, i), d));
          if (++t == T && i + 1 < kVec) {
            t = 0;
            k = coef(++j);
          }
        }
        *reinterpret_cast<uint4*>(out + at[u]) = ro;
      } else {
        for (int i = lo; i < hi; ++i) {
          float d = 0.f;
          if constexpr (kGrad) d = Elem<X>::load(dy + at[u] + i);
          Elem<X>::store(out + at[u] + i,
                         apply(k, Elem<X>::load(x + at[u] + i), d));
          if (++t == T && i + 1 < hi) {
            t = 0;
            k = coef(++j);
          }
        }
      }
    }
  }
}

template <typename X, int W>
__global__ void __launch_bounds__(kThreads)
bn_fw_stats_kernel(const X* __restrict__ x, float* __restrict__ part, const Geo g) {
  tile_sums<X, W, false>(x, nullptr, nullptr, part, g);
}

template <typename X, int W>
__global__ void __launch_bounds__(kThreads)
bn_bw_reduce_kernel(const X* __restrict__ x, const X* __restrict__ dy,
                    const float* __restrict__ mean, float* __restrict__ part,
                    const Geo g) {
  tile_sums<X, W, true>(x, dy, mean, part, g);
}

template <typename X>
__global__ void __launch_bounds__(kThreads)
bn_fw_apply_kernel(const X* __restrict__ x, const float* __restrict__ part,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   X* __restrict__ y, float* __restrict__ mean_out,
                   float* __restrict__ var_out, float* __restrict__ invstd_out,
                   const Geo g, float eps) {
  __shared__ float3 coefs[kThreads];   // mean, invstd gamma, beta
  const Tile tl = tile_of(g, gridDim.x - 1 - blockIdx.x);
  const float n = static_cast<float>(g.batch * g.steps);
  for (int j = threadIdx.x; j < tl.nc; j += kThreads) {
    const int64_t c = tl.c0 + j;
    const float2 s = merged(part, g, c);
    const float m1 = s.x / n;
    const float mu = Elem<X>::load(x + c * g.steps) + m1;
    const float var = fmaxf(s.y / n - m1 * m1, 0.f);
    const float is = 1.f / sqrtf(var + eps);
    coefs[j] = make_float3(mu, is * gamma[c], beta[c]);
    if (tl.rgi == 0) {
      mean_out[c] = mu;
      var_out[c] = var;
      invstd_out[c] = is;
    }
  }
  __syncthreads();
  map_tile<X, false>(
      g, tl, x, static_cast<const X*>(nullptr), y,
      [&](int j) { return coefs[j]; },
      [](const float3& k, float v, float) { return fmaf(v - k.x, k.y, k.z); });
}

template <typename X>
__global__ void __launch_bounds__(kThreads)
bn_bw_dx_kernel(const X* __restrict__ x, const X* __restrict__ dy,
                const float* __restrict__ part, const float* __restrict__ mean,
                const float* __restrict__ invstd,
                const float* __restrict__ gamma, X* __restrict__ dx,
                float* __restrict__ dgamma, float* __restrict__ dbeta,
                const Geo g) {
  __shared__ float4 coefs[kThreads];   // mean, gamma invstd, dbeta / N, k
  const Tile tl = tile_of(g, gridDim.x - 1 - blockIdx.x);
  const float n = static_cast<float>(g.batch * g.steps);
  for (int j = threadIdx.x; j < tl.nc; j += kThreads) {
    const int64_t c = tl.c0 + j;
    const float2 s = merged(part, g, c);
    const float is = invstd[c];
    const float dg = s.y * is;
    coefs[j] = make_float4(mean[c], gamma[c] * is, s.x / n, is * (dg / n));
    if (tl.rgi == 0) {
      dgamma[c] = dg;
      dbeta[c] = s.x;
    }
  }
  __syncthreads();
  map_tile<X, true>(
      g, tl, x, dy, dx, [&](int j) { return coefs[j]; },
      [](const float4& k, float v, float d) {
        return k.y * fmaf(-(v - k.x), k.w, d - k.z);
      });
}

// ---- launches -----------------------------------------------------------------

constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);
constexpr int64_t kInt31 = int64_t(1) << 31;

// The blocks of Kernel the card holds at once: a wave. Asked once a
// kernel and process (no stream operation, so a CUDA graph's capture may
// come after it).
template <auto Kernel>
int wave() {
  static const int blocks = [] {
    int per_sm = 0, device = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads,
                                                  0);
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    return per_sm * sms > 0 ? per_sm * sms : 1;
  }();
  return blocks;
}

// The tiling of [B, C, T] with rg row groups into about `want` tiles, a
// wave of the kernel that runs them, so that every tile runs at once;
// false if the shape is out of the kernels' range (their positions within
// a tile are 32-bit)
bool geometry(int64_t batch, int64_t channels, int64_t steps, int64_t rg,
              int want, Geo* g) {
  if (batch < 1 || channels < 1 || steps < 1 || rg < 1 ||
      rg > kMaxRowGroups || rg > batch || steps >= kInt31 ||
      batch * steps >= kInt31) {
    return false;
  }
  const int64_t want_cg = (want + rg - 1) / rg;
  int64_t cb = (channels + want_cg - 1) / want_cg;
  cb = cb > kThreads ? kThreads : cb;
  const int64_t cg = (channels + cb - 1) / cb;
  const int64_t rows = batch / rg + 1;
  if (cb * steps >= kInt31 / 2 || rows * (cb * steps / 4 + 2) >= kInt31 ||
      cg * rg >= kInt31) {
    return false;
  }
  g->batch = batch;
  g->channels = channels;
  g->row = channels * steps;
  g->steps = static_cast<int>(steps);
  g->rg = static_cast<int>(rg);
  g->cb = static_cast<int>(cb);
  g->cg = static_cast<int>(cg);
  g->by_steps = make_div(static_cast<uint32_t>(steps));
  return true;
}

// The reducing kernels' tiling: at most as many channels a tile as keep
// the run within a slot a thread (256 W - W elements), or one channel
inline Geo reducing(Geo g, int w) {
  const int64_t fit = (static_cast<int64_t>(kThreads) * w - w) / g.steps;
  if (g.cb > fit) {
    g.cb = fit < 1 ? 1 : static_cast<int>(fit);
    g.cg = static_cast<int>((g.channels + g.cb - 1) / g.cb);
  }
  return g;
}

unsigned tiles(const Geo& g) { return static_cast<unsigned>(g.cg * g.rg); }

struct Shape {
  int64_t batch, channels, steps, rg;
};

// Launch a reducing kernel on [B, C, T], its instantiation for 16-byte
// slots where a row's elements are a multiple of them (so that every row's
// run has the same alignment), else for single elements
template <typename X, auto Wide, auto Narrow, typename... Args>
int launch_reducing(const Shape& sh, cudaStream_t s, Args... args) {
  constexpr int kVec = Elem<X>::kVec;
  const bool wide = sh.channels * sh.steps % kVec == 0;
  Geo g;
  if (!geometry(sh.batch, sh.channels, sh.steps, sh.rg,
                wide ? wave<Wide>() : wave<Narrow>(), &g)) {
    return kBad;
  }
  g = reducing(g, wide ? kVec : 1);
  if (wide) {
    Wide<<<tiles(g), kThreads, 0, s>>>(args..., g);
  } else {
    Narrow<<<tiles(g), kThreads, 0, s>>>(args..., g);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename X>
int fw_stats(const Shape& sh, const void* x, void* part, cudaStream_t s) {
  return launch_reducing<X, bn_fw_stats_kernel<X, Elem<X>::kVec>,
                         bn_fw_stats_kernel<X, 1>>(
      sh, s, static_cast<const X*>(x), static_cast<float*>(part));
}

template <typename X>
int fw_apply(const Shape& sh, const void* x, const void* part,
             const void* gamma, const void* beta, void* y, void* mean,
             void* var, void* invstd, float eps, cudaStream_t s) {
  Geo g;
  if (!geometry(sh.batch, sh.channels, sh.steps, sh.rg,
                wave<bn_fw_apply_kernel<X>>(), &g)) {
    return kBad;
  }
  bn_fw_apply_kernel<X><<<tiles(g), kThreads, 0, s>>>(
      static_cast<const X*>(x), static_cast<const float*>(part),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<X*>(y), static_cast<float*>(mean), static_cast<float*>(var),
      static_cast<float*>(invstd), g, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename X>
int bw_reduce(const Shape& sh, const void* x, const void* dy,
              const void* mean, void* part, cudaStream_t s) {
  return launch_reducing<X, bn_bw_reduce_kernel<X, Elem<X>::kVec>,
                         bn_bw_reduce_kernel<X, 1>>(
      sh, s, static_cast<const X*>(x), static_cast<const X*>(dy),
      static_cast<const float*>(mean), static_cast<float*>(part));
}

template <typename X>
int bw_dx(const Shape& sh, const void* x, const void* dy, const void* part,
          const void* mean, const void* invstd, const void* gamma, void* dx,
          void* dgamma, void* dbeta, cudaStream_t s) {
  Geo g;
  if (!geometry(sh.batch, sh.channels, sh.steps, sh.rg,
                wave<bn_bw_dx_kernel<X>>(), &g)) {
    return kBad;
  }
  bn_bw_dx_kernel<X><<<tiles(g), kThreads, 0, s>>>(
      static_cast<const X*>(x), static_cast<const X*>(dy),
      static_cast<const float*>(part), static_cast<const float*>(mean),
      static_cast<const float*>(invstd), static_cast<const float*>(gamma),
      static_cast<X*>(dx), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C interface. dtype: 0 float32, 1 bfloat16, 2 float16 (x, dy, y and
// dx); every other tensor is float32: gamma, beta, mean, var, invstd,
// dgamma, dbeta [C], the partial sums [rg, 2, C]. The wrapper
// (ops/kernels/batchnorm.py) checks devices, dtypes, shapes, contiguity and
// 16-byte alignment and allocates every output and the partial sums. Each
// entry returns cudaGetLastError() after its launch (0 when it was taken),
// or cudaErrorInvalidValue for a shape or dtype it does not take.

#define BN_BY_DTYPE(dtype, FN, ...)                     \
  switch (dtype) {                                      \
    case 0: return FN<float>(__VA_ARGS__);              \
    case 1: return FN<bf16>(__VA_ARGS__);               \
    case 2: return FN<__half>(__VA_ARGS__);             \
    default: return kBad;                               \
  }

extern "C" int bn_fw_stats(int dtype, const void* x, void* part, int64_t batch,
                           int64_t channels, int64_t steps, int64_t rg,
                           void* stream) {
  const Shape sh{batch, channels, steps, rg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  BN_BY_DTYPE(dtype, fw_stats, sh, x, part, s)
}

extern "C" int bn_fw_apply(int dtype, const void* x, const void* part,
                           const void* gamma, const void* beta, void* y,
                           void* mean, void* var, void* invstd, int64_t batch,
                           int64_t channels, int64_t steps, int64_t rg,
                           double eps, void* stream) {
  const Shape sh{batch, channels, steps, rg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float e = static_cast<float>(eps);
  BN_BY_DTYPE(dtype, fw_apply, sh, x, part, gamma, beta, y, mean, var, invstd,
              e, s)
}

extern "C" int bn_bw_reduce(int dtype, const void* x, const void* dy,
                            const void* mean, void* part, int64_t batch,
                            int64_t channels, int64_t steps, int64_t rg,
                            void* stream) {
  const Shape sh{batch, channels, steps, rg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  BN_BY_DTYPE(dtype, bw_reduce, sh, x, dy, mean, part, s)
}

extern "C" int bn_bw_dx(int dtype, const void* x, const void* dy,
                        const void* part, const void* mean, const void* invstd,
                        const void* gamma, void* dx, void* dgamma, void* dbeta,
                        int64_t batch, int64_t channels, int64_t steps,
                        int64_t rg, void* stream) {
  const Shape sh{batch, channels, steps, rg};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  BN_BY_DTYPE(dtype, bw_dx, sh, x, dy, part, mean, invstd, gamma, dx, dgamma,
              dbeta, s)
}

extern "C" const char* bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
