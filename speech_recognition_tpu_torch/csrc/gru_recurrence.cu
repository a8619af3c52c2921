// The Keras-v1 GRU's recurrence for Hopper (sm_90a): every time step of
// both directions of a BiGRU in one launch for the forward pass, and one for
// the backward (BPTT).
//
// Replaces no TPU kernel: the JAX package runs this recurrence as a
// lax.scan that XLA compiles into one loop. The port ran it as a Python
// loop over time that launched ~20 ATen kernels a step and direction
// forward and ~60 backward, the two directions one after the other
// (models/layers.py GRU, the CPU path still).
//
// One direction, processing step s (time tau = s, or T - 1 - s reversed),
// the state h_prev from the previous step (0 at the first), m0..m2 the
// recurrent dropout masks (ones without dropout), xz, xr, xh the input
// projections of step tau:
//
//   yz = 0.2 (xz + (h_prev m0) W_z^T) + 0.5     z = clip(yz, 0, 1)
//   yr = 0.2 (xr + (h_prev m1) W_r^T) + 0.5     r = clip(yr, 0, 1)
//   q  = r (h_prev m2)
//   hh = tanh(xh + q W_h^T)
//   h  = z h_prev + (1 - z) hh
//
// Bound: the loop was bound by the chain of 50 dependent steps, each two
// dependent small products and their gates launched one by one (~20 ms at
// B = 384, U = 192). In one kernel the chain is ~0.02 ms a pass (two
// 12-deep mma.sync chains a step) and the products 8.5 GFLOP a pass (~9 us
// at 989 TFLOP/s); the floor is then the bytes the two kernels move (the
// projections read, the forward's f32 saves written and read back, the
// gradient written: 457 MB with f32 projections, 0.137 ms at 3.35 TB/s).
// The design keeps the recurrence on chip:
//
// 1. Batch rows are independent through time, so a block takes 16 rows (one
//    m16 tile) of one direction (blockIdx.y) and loops over all T steps,
//    with no sync between blocks. 8 warps; warp w owns the state's columns
//    [24 w, 24 w + 24) at U = 192 (16 at U = 128) for all three gates, so z,
//    r, hh and h of an element meet in one lane's registers.
// 2. The recurrent weights stay on chip for the whole sequence. bf16:
//    W_zr (2U x U, 147,456 B at U = 192) in shared memory, packed in the
//    mma.sync B-fragment order (a warp reads 512 contiguous bytes per
//    fragment pair: no bank conflict, no ldmatrix); W_h (U x U) in the
//    registers of the warps whose columns it feeds (72 a thread at U =
//    192). Both of W in shared memory (221,184 B) would leave no room for
//    the three A tiles and the masks. f32: W is read from L2 (it does not
//    fit on chip in f32), by FFMA on the CUDA cores, never TF32.
// 3. The state h lives in f32 registers. A step's products read it from
//    shared memory as an A tile in the operand type (the masked states
//    h m0, h m1 and then r h m2), written by the owning lanes: bf16
//    mma.sync m16n8k16 with f32 accumulation, or FFMA in f32. Two
//    __syncthreads a step order the tiles; the gates are fused into the
//    products' epilogues.
// 4. The backward walks the same tiles and directions from the last step.
//    It is the forward's structure on the transposed weights (the wrapper
//    passes [W_z^T; W_r^T] and W_h^T): dq = da_h W_h (registers), then
//    da_z W_z and da_r W_r (shared memory). It reads the forward's saves
//    (yz, yr, hh in f32, and h by time), writes the input projection's
//    gradient, and leaves the weights' gradients to one large product per
//    direction after the loop (the wrapper's torch.bmm over the A operands
//    the forward saved).
//
// The hard_sigmoid's gradient is 0.2 where 0 <= yz <= 1, both ends
// inclusive (torch.clamp's rule). Sums and products of the epilogues are
// rounded one at a time (no FMA contraction), in the loop's order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 16;                 // batch rows a block: one m16 tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

template <typename S, int U>
struct Cfg {
  static constexpr bool kBf16 = sizeof(S) == 2;
  static constexpr int NTW = U / (8 * kWarps);   // n8 tiles a warp, a gate
  static constexpr int KT = U / 16;              // k16 slices of a product
  // row strides (elements) that keep the A tiles' ldmatrix / float4 reads
  // and the masks' float2 reads free of bank conflicts
  static constexpr int LDA = U + (kBf16 ? 8 : 4);
  static constexpr int LDM = U + 8;
  // dynamic shared memory: [packed W_zr, bf16 only] [3 A tiles] [3 masks]
  static constexpr size_t kPacked = kBf16 ? size_t(2) * U * U * 2 : 0;
  static constexpr size_t kTiles = size_t(3) * kRows * LDA * sizeof(S);
  static constexpr size_t kMasks = size_t(3) * kRows * LDM * sizeof(float);
  static constexpr size_t kSmem = kPacked + kTiles + kMasks;
  static_assert(U % (8 * kWarps) == 0, "units must be a multiple of 64");
  static_assert(kSmem <= 232448, "shared memory");
};

template <typename S>
__device__ __forceinline__ S from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// two neighbouring elements (p aligned to their size), as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// 0.2 a + 0.5, rounded once per operation (as torch's 0.2 * a + 0.5)
__device__ __forceinline__ float hard_pre(float x, float acc) {
  return __fadd_rn(__fmul_rn(0.2f, __fadd_rn(x, acc)), 0.5f);
}

// the hard_sigmoid's gradient: 0.2 where 0 <= y <= 1
__device__ __forceinline__ float hard_grad(float dy, float y) {
  return (y >= 0.0f && y <= 1.0f) ? __fmul_rn(dy, 0.2f) : 0.0f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NTW>
__device__ __forceinline__ void zero(float (&acc)[NTW][4]) {
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
}

// ---- the products ------------------------------------------------------------
//
// A warp's accumulators follow mma.sync m16n8k16: acc[j][e] is (row g + 8 (e /
// 2), column c0 + 8 j + 2 t + e % 2) of the [16, U] result, g = lane / 4,
// t = lane % 4, c0 = 8 NTW warp. Each product is A [16, U] (a tile in shared
// memory, row stride LDA) times W^T, W [n, k] row-major: a gate's columns
// are W's rows. `zr` takes the z gate's columns (W rows [0, U)) from tile
// tz and the r gate's (rows [U, 2U)) from tile tr; `h` takes W_h's.

template <typename S, int U>
struct Weights;

template <int U>
struct Weights<bf16, U> {
  using C = Cfg<bf16, U>;
  static constexpr int NTW = C::NTW, KT = C::KT, KP = KT / 2;
  const uint4* zr;                 // packed W_zr in shared memory
  uint32_t h[KT][NTW][2];          // this warp's B fragments of W_h

  // Pack W_zr [2U, U] into shared memory: entry ((nt KP + kp) 32 + lane)
  // holds the lane's B fragments of k slices 2 kp and 2 kp + 1 of n8 tile
  // nt; load this warp's fragments of W_h [U, U] into registers.
  __device__ __forceinline__ void load(const bf16* wzr, const bf16* wh,
                                       uint4* packed, int warp, int lane) {
    constexpr int entries = (2 * U / 8) * KP * 32;
#pragma unroll 4
    for (int i = threadIdx.x; i < entries; i += kThreads) {
      const int l = i & 31, kp = (i >> 5) % KP, nt = (i >> 5) / KP;
      const uint32_t* row = reinterpret_cast<const uint32_t*>(
          wzr + static_cast<size_t>(nt * 8 + (l >> 2)) * U + kp * 32 +
          2 * (l & 3));
      packed[i] = make_uint4(row[0], row[4], row[8], row[12]);
    }
    zr = packed;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const uint32_t* row = reinterpret_cast<const uint32_t*>(
            wh + static_cast<size_t>((warp * NTW + j) * 8 + g) * U + kt * 16 +
            2 * t);
        h[kt][j][0] = row[0];
        h[kt][j][1] = row[4];
      }
  }

  __device__ __forceinline__ void zr_product(float (&az)[NTW][4],
                                             float (&ar)[NTW][4],
                                             const bf16* tz, const bf16* tr,
                                             bool two, int warp,
                                             int lane) const {
    zero(az);
    zero(ar);
    const int off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * C::LDA +
                    8 * (lane >> 4);
    const uint4* bz = zr + (warp * NTW) * KP * 32 + lane;
    const uint4* br = zr + (U / 8 + warp * NTW) * KP * 32 + lane;
#pragma unroll
    for (int kp = 0; kp < KP; ++kp) {
      uint32_t fz[2][4], fr[2][4];
      ldmatrix_x4(fz[0], tz + off + 32 * kp);
      ldmatrix_x4(fz[1], tz + off + 32 * kp + 16);
      if (two) {
        ldmatrix_x4(fr[0], tr + off + 32 * kp);
        ldmatrix_x4(fr[1], tr + off + 32 * kp + 16);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fr[0][i] = fz[0][i];
          fr[1][i] = fz[1][i];
        }
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const uint4 wz = bz[(j * KP + kp) * 32];
        mma_bf16(az[j], fz[0], wz.x, wz.y);
        mma_bf16(az[j], fz[1], wz.z, wz.w);
        const uint4 wr = br[(j * KP + kp) * 32];
        mma_bf16(ar[j], fr[0], wr.x, wr.y);
        mma_bf16(ar[j], fr[1], wr.z, wr.w);
      }
    }
  }

  __device__ __forceinline__ void h_product(float (&ah)[NTW][4],
                                            const bf16* th, int warp,
                                            int lane) const {
    (void)warp;
    zero(ah);
    const int off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * C::LDA +
                    8 * (lane >> 4);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t f[4];
      ldmatrix_x4(f, th + off + 16 * kt);
#pragma unroll
      for (int j = 0; j < NTW; ++j) mma_bf16(ah[j], f, h[kt][j][0], h[kt][j][1]);
    }
  }
};

// f32: FFMA on the CUDA cores, W read from L2 four k at a time; the sum
// runs over k in ascending order.
template <int U, int NTW>
__device__ __forceinline__ void ffma_product(float (&acc)[NTW][4],
                                             const float* tile, const float* w,
                                             int lane) {
  constexpr int LDA = Cfg<float, U>::LDA;
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = tile + g * LDA;
  const float* a1 = a0 + 8 * LDA;
  zero(acc);
#pragma unroll 2
  for (int k = 0; k < U; k += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + k);
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            w + static_cast<size_t>(8 * j + 2 * t + e) * U + k));
        float& c0 = acc[j][e];
        float& c1 = acc[j][2 + e];
        c0 = fmaf(x0.x, v.x, c0);
        c0 = fmaf(x0.y, v.y, c0);
        c0 = fmaf(x0.z, v.z, c0);
        c0 = fmaf(x0.w, v.w, c0);
        c1 = fmaf(x1.x, v.x, c1);
        c1 = fmaf(x1.y, v.y, c1);
        c1 = fmaf(x1.z, v.z, c1);
        c1 = fmaf(x1.w, v.w, c1);
      }
  }
}

template <int U>
struct Weights<float, U> {
  using C = Cfg<float, U>;
  static constexpr int NTW = C::NTW;
  const float* wzr;
  const float* wh;

  __device__ __forceinline__ void load(const float* wzr_, const float* wh_,
                                       uint4* packed, int warp, int lane) {
    (void)packed;
    (void)lane;
    wzr = wzr_ + static_cast<size_t>(warp * NTW * 8) * U;
    wh = wh_ + static_cast<size_t>(warp * NTW * 8) * U;
  }

  __device__ __forceinline__ void zr_product(float (&az)[NTW][4],
                                             float (&ar)[NTW][4],
                                             const float* tz, const float* tr,
                                             bool two, int warp,
                                             int lane) const {
    (void)warp;
    ffma_product<U, NTW>(az, tz, wzr, lane);
    ffma_product<U, NTW>(ar, two ? tr : tz, wzr + static_cast<size_t>(U) * U,
                         lane);
  }

  __device__ __forceinline__ void h_product(float (&ah)[NTW][4],
                                            const float* th, int warp,
                                            int lane) const {
    (void)warp;
    ffma_product<U, NTW>(ah, th, wh, lane);
  }
};

// ---- arguments ----------------------------------------------------------------

struct FwdArgs {
  const void* xw[2];   // a direction's input projections [B, T, 3U] (z, r, h)
  const void* wzr;     // [D, 2U, U]
  const void* wh;      // [D, U, U]
  const float* rm;     // [D, 3, B, U] recurrent masks, or null
  void* last;          // [B, D U]: the last state of each direction
  float* hseq;         // [D, B, T, U]: h by time, or null
  float* yz;           // [D, B, T, U] each: the saves for the backward,
  float* yr;           //   all or none
  float* hh;
  void* ops;           // [D, 3, B, T, U]: the A operands of the products
  int64_t batch, steps;
  int dirs, reverse;   // bit d of reverse: direction d runs from the end
};

struct BwdArgs {
  const void* wzr_t;   // [D, 2U, U]: [W_z^T; W_r^T]
  const void* wh_t;    // [D, U, U]: W_h^T
  const float* rm;     // [D, 3, B, U] or null
  const float* hseq;   // the forward's saves, [D, B, T, U] each
  const float* yz;
  const float* yr;
  const float* hh;
  const void* dlast;   // [B, D U] or null
  const float* dhseq;  // [D, B, T, U] or null
  void* dxw;           // [D, B, T, 3U]: the input projections' gradient
  int64_t batch, steps;
  int dirs, reverse;
};

// The lane's two rows of the block's tile (g and g + 8): whether each is in
// the batch, its batch index (0 for a row outside, whose loads and stores
// are skipped), and its time bases: t[h] = (d B + b) T for the [D, B, T, *]
// arrays and o[h] = (3 d B + b) T for the [D, 3, B, T, U] ones.
struct Rows {
  int64_t b[2], t[2], o[2];
  bool ok[2];
  __device__ __forceinline__ Rows(int64_t b0, int g, int d, int64_t batch,
                                  int64_t steps) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ok[h] = b0 + g + 8 * h < batch;
      b[h] = ok[h] ? b0 + g + 8 * h : 0;
      t[h] = (d * batch + b[h]) * steps;
      o[h] = (3 * d * batch + b[h]) * steps;
    }
  }
};

// Into L2, the block's rows (b0 on, ``rows`` of them) of an array at one
// time step: ``p`` the first row's, rows ``stride`` bytes apart, ``bytes``
// each; 128-byte lines spread over the block's threads.
__device__ __forceinline__ void prefetch_rows(const void* p, int64_t stride,
                                              int rows, int bytes) {
  const int lines = (bytes + 127) / 128 + 1;
  for (int i = threadIdx.x; i < rows * lines; i += kThreads) {
    const int r = i / lines, l = i % lines;
    const char* q = static_cast<const char*>(p) + r * stride +
                    min(l * 128, bytes - 1);
    asm volatile("prefetch.global.L2 [%0];" ::"l"(q));
  }
}

// Shared memory of both kernels: the weights (bf16), the three A tiles, the
// masks (each lane reads its own elements of them).
template <typename S, int U>
struct Smem {
  using C = Cfg<S, U>;
  uint4* packed;
  S* tile[3];
  float* mask;         // [3][kRows][LDM]

  __device__ __forceinline__ explicit Smem(unsigned char* base) {
    packed = reinterpret_cast<uint4*>(base);
    S* tiles = reinterpret_cast<S*>(base + C::kPacked);
    for (int i = 0; i < 3; ++i) tile[i] = tiles + i * kRows * C::LDA;
    mask = reinterpret_cast<float*>(base + C::kPacked + C::kTiles);
  }

  // masks of direction d for the block's rows (0 outside the batch), and
  // every tile zeroed
  __device__ __forceinline__ void init(const float* rm, int d, int64_t b0,
                                       int64_t batch) {
    if (rm != nullptr) {
#pragma unroll 4
      for (int i = threadIdx.x; i < 3 * kRows * U; i += kThreads) {
        const int gate = i / (kRows * U), r = (i / U) % kRows, k = i % U;
        const int64_t b = b0 + r;
        mask[(gate * kRows + r) * C::LDM + k] =
            b < batch ? rm[((static_cast<int64_t>(d) * 3 + gate) * batch + b) *
                               U + k]
                      : 0.0f;
      }
    }
    for (int i = threadIdx.x; i < 3 * kRows * C::LDA; i += kThreads)
      tile[0][i] = from_f<S>(0.0f);
  }

  __device__ __forceinline__ float2 m(int gate, int row, int col) const {
    return *reinterpret_cast<const float2*>(
        mask + (gate * kRows + row) * C::LDM + col);
  }
};

// ---- forward ------------------------------------------------------------------

template <typename S, typename X, int U>
__global__ void __launch_bounds__(kThreads, 1)
gru_forward_kernel(const FwdArgs a) {
  using C = Cfg<S, U>;
  constexpr int NTW = C::NTW, LDA = C::LDA;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<S, U> sm(smem_raw);

  const int d = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, c0 = warp * NTW * 8;
  const int64_t B = a.batch, T = a.steps, b0 = int64_t(blockIdx.x) * kRows;
  const int nrows = B - b0 < kRows ? static_cast<int>(B - b0) : kRows;
  const bool rev = (a.reverse >> d) & 1, masked = a.rm != nullptr;
  const bool save = a.yz != nullptr;
  const X* xw = static_cast<const X*>(a.xw[d]);
  X* last = static_cast<X*>(a.last);
  S* ops = static_cast<S*>(a.ops);
  const int64_t gate_stride = B * T * U;        // ops' gates
  const Rows rows(b0, g, d, B, T);

  Weights<S, U> w;
  w.load(static_cast<const S*>(a.wzr) + static_cast<size_t>(d) * 2 * U * U,
         static_cast<const S*>(a.wh) + static_cast<size_t>(d) * U * U,
         sm.packed, warp, lane);
  sm.init(a.rm, d, b0, B);
  __syncthreads();

  // the first step's A operands are the zero state
  if (save) {
    const int64_t tau0 = rev ? T - 1 : 0;
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!rows.ok[h]) continue;
        S* p = ops + (rows.o[h] + tau0) * U + c0 + 8 * j + 2 * t;
        store2(p, 0.0f, 0.0f);
        store2(p + gate_stride, 0.0f, 0.0f);
      }
  }

  float hs[NTW][4];
  zero(hs);
  for (int64_t s = 0; s < T; ++s) {
    const int64_t tau = rev ? T - 1 - s : s;
    const int64_t next = rev ? tau - 1 : tau + 1;
    if (s + 1 < T)
      prefetch_rows(xw + (b0 * T + next) * 3 * U,
                    T * 3 * U * int64_t(sizeof(X)), nrows,
                    3 * U * int(sizeof(X)));
    // this step's input projections, used after the products
    float xz[NTW][4], xr[NTW][4], xh[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 vz = make_float2(0.0f, 0.0f), vr = vz, vh = vz;
        if (rows.ok[h]) {
          const X* p = xw + (rows.b[h] * T + tau) * 3 * U + c0 + 8 * j + 2 * t;
          vz = load2(p);
          vr = load2(p + U);
          vh = load2(p + 2 * U);
        }
        xz[j][2 * h] = vz.x; xz[j][2 * h + 1] = vz.y;
        xr[j][2 * h] = vr.x; xr[j][2 * h + 1] = vr.y;
        xh[j][2 * h] = vh.x; xh[j][2 * h + 1] = vh.y;
      }

    float az[NTW][4], ar[NTW][4];
    w.zr_product(az, ar, sm.tile[0], sm.tile[1], masked, warp, lane);
    // the gates; the candidate's A tile r (h m2)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = g + 8 * h, col = c0 + 8 * j + 2 * t;
        const float2 m2 = masked ? sm.m(2, row, col) : make_float2(1.0f, 1.0f);
        float q[2], yzv[2], yrv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * h + e;
          yzv[e] = hard_pre(xz[j][i], az[j][i]);
          yrv[e] = hard_pre(xr[j][i], ar[j][i]);
          az[j][i] = clip01(yzv[e]);                       // z from here on
          const float hm2 = masked ? __fmul_rn(hs[j][i], e ? m2.y : m2.x)
                                   : hs[j][i];
          q[e] = __fmul_rn(clip01(yrv[e]), hm2);
        }
        store2(sm.tile[2] + row * LDA + col, q[0], q[1]);
        if (save && rows.ok[h]) {
          const int64_t o = (rows.t[h] + tau) * U + col;
          store2(a.yz + o, yzv[0], yzv[1]);
          store2(a.yr + o, yrv[0], yrv[1]);
          store2(ops + (rows.o[h] + tau) * U + col + 2 * gate_stride, q[0],
                 q[1]);
        }
      }
    __syncthreads();

    float ah[NTW][4];
    w.h_product(ah, sm.tile[2], warp, lane);
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = g + 8 * h, col = c0 + 8 * j + 2 * t;
        float hhv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * h + e;
          const float z = az[j][i];
          hhv[e] = tanhf(__fadd_rn(xh[j][i], ah[j][i]));
          hs[j][i] = __fadd_rn(__fmul_rn(z, hs[j][i]),
                               __fmul_rn(__fsub_rn(1.0f, z), hhv[e]));
        }
        const float h0 = hs[j][2 * h], h1 = hs[j][2 * h + 1];
        if (rows.ok[h]) {
          const int64_t o = (rows.t[h] + tau) * U + col;
          if (save) store2(a.hh + o, hhv[0], hhv[1]);
          if (a.hseq != nullptr) store2(a.hseq + o, h0, h1);
          if (s == T - 1)
            store2(last + rows.b[h] * a.dirs * U + d * U + col, h0, h1);
        }
        if (s == T - 1) continue;
        // the next step's A tiles: h m0 and h m1 (h alone without masks)
        float2 m0 = make_float2(1.0f, 1.0f), m1 = m0;
        if (masked) {
          m0 = sm.m(0, row, col);
          m1 = sm.m(1, row, col);
        }
        const float z0 = masked ? __fmul_rn(h0, m0.x) : h0;
        const float z1 = masked ? __fmul_rn(h1, m0.y) : h1;
        const float r0 = masked ? __fmul_rn(h0, m1.x) : h0;
        const float r1 = masked ? __fmul_rn(h1, m1.y) : h1;
        store2(sm.tile[0] + row * LDA + col, z0, z1);
        if (masked) store2(sm.tile[1] + row * LDA + col, r0, r1);
        if (save && rows.ok[h]) {
          S* p = ops + (rows.o[h] + next) * U + col;
          store2(p, z0, z1);
          store2(p + gate_stride, r0, r1);
        }
      }
    __syncthreads();
  }
}

// ---- backward -----------------------------------------------------------------

template <typename S, typename X, int U>
__global__ void __launch_bounds__(kThreads, 1)
gru_backward_kernel(const BwdArgs a) {
  using C = Cfg<S, U>;
  constexpr int NTW = C::NTW, LDA = C::LDA;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<S, U> sm(smem_raw);

  const int d = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, c0 = warp * NTW * 8;
  const int64_t B = a.batch, T = a.steps, b0 = int64_t(blockIdx.x) * kRows;
  const int nrows = B - b0 < kRows ? static_cast<int>(B - b0) : kRows;
  const bool rev = (a.reverse >> d) & 1, masked = a.rm != nullptr;
  const X* dlast = static_cast<const X*>(a.dlast);
  X* dxw = static_cast<X*>(a.dxw);
  const Rows rows(b0, g, d, B, T);

  Weights<S, U> w;
  w.load(static_cast<const S*>(a.wzr_t) + static_cast<size_t>(d) * 2 * U * U,
         static_cast<const S*>(a.wh_t) + static_cast<size_t>(d) * U * U,
         sm.packed, warp, lane);
  sm.init(a.rm, d, b0, B);
  __syncthreads();

  // the gradient of the state after the current step
  float dh[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 v = make_float2(0.0f, 0.0f);
      if (dlast != nullptr && rows.ok[h])
        v = load2(dlast + rows.b[h] * a.dirs * U + d * U + c0 + 8 * j + 2 * t);
      dh[j][2 * h] = v.x;
      dh[j][2 * h + 1] = v.y;
    }

  // the block's first row of a [D, B, T, U] array at time tau
  const int64_t first = (d * B + b0) * T;
  const int64_t stride = T * U * int64_t(sizeof(float));
  for (int64_t s = T - 1; s >= 0; --s) {
    const int64_t tau = rev ? T - 1 - s : s;
    const int64_t prev = rev ? tau + 1 : tau - 1;      // h_prev's time
    if (s > 0) {                                       // the next step's
      const int64_t o = (first + prev) * U;
      prefetch_rows(a.yz + o, stride, nrows, U * 4);
      prefetch_rows(a.yr + o, stride, nrows, U * 4);
      prefetch_rows(a.hh + o, stride, nrows, U * 4);
      if (a.dhseq != nullptr) prefetch_rows(a.dhseq + o, stride, nrows, U * 4);
      if (s > 1)
        prefetch_rows(a.hseq + (first + (rev ? prev + 1 : prev - 1)) * U,
                      stride, nrows, U * 4);
    }
    float z[NTW][4], yr[NTW][4], hp[NTW][4], daz[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = g + 8 * h, col = c0 + 8 * j + 2 * t;
        float2 vz = make_float2(0.0f, 0.0f), vr = vz, vh = vz, vp = vz,
               vd = vz;
        if (rows.ok[h]) {
          const int64_t o = (rows.t[h] + tau) * U + col;
          vz = load2(a.yz + o);
          vr = load2(a.yr + o);
          vh = load2(a.hh + o);
          if (s > 0) vp = load2(a.hseq + (rows.t[h] + prev) * U + col);
          if (a.dhseq != nullptr) vd = load2(a.dhseq + o);
        }
        const float yzv[2] = {vz.x, vz.y}, hhv[2] = {vh.x, vh.y};
        float dah[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * h + e;
          if (a.dhseq != nullptr) dh[j][i] = __fadd_rn(dh[j][i], e ? vd.y : vd.x);
          hp[j][i] = e ? vp.y : vp.x;
          yr[j][i] = e ? vr.y : vr.x;
          z[j][i] = clip01(yzv[e]);
          const float dz = __fmul_rn(dh[j][i], __fsub_rn(hp[j][i], hhv[e]));
          const float dhh = __fmul_rn(dh[j][i], __fsub_rn(1.0f, z[j][i]));
          dah[e] = __fmul_rn(dhh, __fsub_rn(1.0f, __fmul_rn(hhv[e], hhv[e])));
          daz[j][i] = hard_grad(dz, yzv[e]);
        }
        store2(sm.tile[2] + row * LDA + col, dah[0], dah[1]);
        if (rows.ok[h]) {
          X* p = dxw + (rows.t[h] + tau) * 3 * U + col;
          store2(p, daz[j][2 * h], daz[j][2 * h + 1]);
          store2(p + 2 * U, dah[0], dah[1]);
        }
      }
    __syncthreads();

    float dq[NTW][4];
    w.h_product(dq, sm.tile[2], warp, lane);
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = g + 8 * h, col = c0 + 8 * j + 2 * t;
        const float2 m2 = masked ? sm.m(2, row, col) : make_float2(1.0f, 1.0f);
        float dar[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * h + e;
          const float me = e ? m2.y : m2.x;
          const float hm2 = masked ? __fmul_rn(hp[j][i], me) : hp[j][i];
          dar[e] = hard_grad(__fmul_rn(dq[j][i], hm2), yr[j][i]);
          const float dqr = __fmul_rn(dq[j][i], clip01(yr[j][i]));
          // dh_prev so far: through z h_prev and through q
          dh[j][i] = __fadd_rn(__fmul_rn(dh[j][i], z[j][i]),
                               masked ? __fmul_rn(dqr, me) : dqr);
        }
        store2(sm.tile[0] + row * LDA + col, daz[j][2 * h], daz[j][2 * h + 1]);
        store2(sm.tile[1] + row * LDA + col, dar[0], dar[1]);
        if (rows.ok[h])
          store2(dxw + (rows.t[h] + tau) * 3 * U + U + col, dar[0], dar[1]);
      }
    __syncthreads();

    float gz[NTW][4], gr[NTW][4];
    w.zr_product(gz, gr, sm.tile[0], sm.tile[1], true, warp, lane);
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = g + 8 * h, col = c0 + 8 * j + 2 * t;
        float2 m0 = make_float2(1.0f, 1.0f), m1 = m0;
        if (masked) {
          m0 = sm.m(0, row, col);
          m1 = sm.m(1, row, col);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * h + e;
          const float a0 = masked ? __fmul_rn(gz[j][i], e ? m0.y : m0.x)
                                  : gz[j][i];
          const float a1 = masked ? __fmul_rn(gr[j][i], e ? m1.y : m1.x)
                                  : gr[j][i];
          dh[j][i] = __fadd_rn(__fadd_rn(dh[j][i], a0), a1);
        }
      }
    // the tiles are next written after the next step's first
    // __syncthreads (tile 2 before it: its readers are past this step's
    // second), so this step's readers are done with them
  }
}

// ---- launches -----------------------------------------------------------------

dim3 grid(int64_t batch, int dirs) {
  return dim3(static_cast<unsigned>((batch + kRows - 1) / kRows),
              static_cast<unsigned>(dirs));
}

// The shared memory attribute is set once per kernel and process (it is no
// stream operation, so a CUDA graph's capture may launch after it).
template <typename S, typename X, int U>
int forward_u(const FwdArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gru_forward_kernel<S, X, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg<S, U>::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  gru_forward_kernel<S, X, U>
      <<<grid(a.batch, a.dirs), kThreads, Cfg<S, U>::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename X, int U>
int backward_u(const BwdArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gru_backward_kernel<S, X, U>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg<S, U>::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  gru_backward_kernel<S, X, U>
      <<<grid(a.batch, a.dirs), kThreads, Cfg<S, U>::kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename X>
int forward_s(int64_t units, const FwdArgs& a, cudaStream_t stream) {
  switch (units) {
    case 128: return forward_u<S, X, 128>(a, stream);
    case 192: return forward_u<S, X, 192>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename S, typename X>
int backward_s(int64_t units, const BwdArgs& a, cudaStream_t stream) {
  switch (units) {
    case 128: return backward_u<S, X, 128>(a, stream);
    case 192: return backward_u<S, X, 192>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The C interface. op_bf16: the products' operands (the weights, the A
// tiles, `ops`) are bfloat16, else float32; io_bf16: the input projections,
// `last`, `dlast` and `dxw` are bfloat16, else float32 (bf16 operands take
// either, f32 operands f32 alone). The wrapper (ops/kernels/gru.py) checks
// shapes, types, contiguity and alignment; a null pointer is an absent
// optional tensor.

extern "C" int gru_forward(int op_bf16, int io_bf16, int64_t units, const void* xw0,
                           const void* xw1, const void* wzr, const void* wh,
                           const void* rm, void* last, void* hseq, void* yz,
                           void* yr, void* hh, void* ops, int64_t batch,
                           int64_t steps, int64_t dirs, int64_t reverse,
                           void* stream) {
  FwdArgs a;
  a.xw[0] = xw0;
  a.xw[1] = xw1;
  a.wzr = wzr;
  a.wh = wh;
  a.rm = static_cast<const float*>(rm);
  a.last = last;
  a.hseq = static_cast<float*>(hseq);
  a.yz = static_cast<float*>(yz);
  a.yr = static_cast<float*>(yr);
  a.hh = static_cast<float*>(hh);
  a.ops = ops;
  a.batch = batch;
  a.steps = steps;
  a.dirs = static_cast<int>(dirs);
  a.reverse = static_cast<int>(reverse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op_bf16) {
    return io_bf16 ? forward_s<bf16, bf16>(units, a, s)
                   : forward_s<bf16, float>(units, a, s);
  }
  return io_bf16 ? static_cast<int>(cudaErrorInvalidValue)
                 : forward_s<float, float>(units, a, s);
}

extern "C" int gru_backward(int op_bf16, int io_bf16, int64_t units, const void* wzr_t,
                            const void* wh_t, const void* rm, const void* hseq,
                            const void* yz, const void* yr, const void* hh,
                            const void* dlast, const void* dhseq, void* dxw,
                            int64_t batch, int64_t steps, int64_t dirs,
                            int64_t reverse, void* stream) {
  BwdArgs a;
  a.wzr_t = wzr_t;
  a.wh_t = wh_t;
  a.rm = static_cast<const float*>(rm);
  a.hseq = static_cast<const float*>(hseq);
  a.yz = static_cast<const float*>(yz);
  a.yr = static_cast<const float*>(yr);
  a.hh = static_cast<const float*>(hh);
  a.dlast = dlast;
  a.dhseq = static_cast<const float*>(dhseq);
  a.dxw = dxw;
  a.batch = batch;
  a.steps = steps;
  a.dirs = static_cast<int>(dirs);
  a.reverse = static_cast<int>(reverse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op_bf16) {
    return io_bf16 ? backward_s<bf16, bf16>(units, a, s)
                   : backward_s<bf16, float>(units, a, s);
  }
  return io_bf16 ? static_cast<int>(cudaErrorInvalidValue)
                 : backward_s<float, float>(units, a, s);
}

extern "C" const char* gru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
