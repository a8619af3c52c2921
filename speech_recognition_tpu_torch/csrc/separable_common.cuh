// Device code shared by the separable block's forward (separable_block.cu)
// and backward (separable_block_bwd.cu) kernels, for Hopper (sm_90a):
// conversions and rounding to the compute type, 16-byte loads and stores,
// bf16x2 / float2 channel pairs that round once per operation (the
// contract's rounding), cp.async copies, and the warp's tensor-core
// products (mma.sync m16n8k16 with ldmatrix, and their f32 FMA twin).
//
// Each source includes this header and is built on its own into a library
// with a plain C interface, so everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename S>
__device__ __forceinline__ S from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the compute type S, held as a float.
template <typename S>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<S>(v));
}

// 8 consecutive elements at p, 16-byte aligned, as floats.
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// v rounded to S (once, to nearest even) at p, 16-byte aligned.
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Two neighbouring channels for the CUDA-core arithmetic: bf16x2 in bf16,
// where each operation rounds once to bf16 (a product or a sum of two bf16
// values is exact in f32, so this is the f32 operation rounded to bf16, as
// the contract has it, in one instruction for both channels and without a
// conversion), or a float2 in f32.
template <typename S>
struct Pair;

template <>
struct Pair<bf16> {
  using T = __nv_bfloat162;
  static __device__ __forceinline__ T of(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ T join(bf16 lo, bf16 hi) {
    return __halves2bfloat162(lo, hi);
  }
  static __device__ __forceinline__ bf16 lo(T v) { return __low2bfloat16(v); }
  static __device__ __forceinline__ bf16 hi(T v) { return __high2bfloat16(v); }
  static __device__ __forceinline__ float2 f(T v) {
    return __bfloat1622float2(v);
  }
  static __device__ __forceinline__ T mul(T a, T b) { return __hmul2_rn(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return __hadd2_rn(a, b); }
  static __device__ __forceinline__ T zero() {
    return join(__ushort_as_bfloat16(0), __ushort_as_bfloat16(0));
  }
  static __device__ __forceinline__ T six() {  // 6.0 = 0x40c0
    return join(__ushort_as_bfloat16(0x40c0), __ushort_as_bfloat16(0x40c0));
  }
  static __device__ __forceinline__ T relu6(T v) {
    return __hmin2(__hmax2(v, zero()), six());
  }
  // 1 where 0 < v < 6, else 0
  static __device__ __forceinline__ T inside(T v) {
    return __hmul2_rn(__hgt2(v, zero()), __hlt2(v, six()));
  }
};

template <>
struct Pair<float> {
  using T = float2;
  static __device__ __forceinline__ T of(float lo, float hi) {
    return make_float2(lo, hi);
  }
  static __device__ __forceinline__ T join(float lo, float hi) {
    return make_float2(lo, hi);
  }
  static __device__ __forceinline__ float lo(T v) { return v.x; }
  static __device__ __forceinline__ float hi(T v) { return v.y; }
  static __device__ __forceinline__ float2 f(T v) { return v; }
  static __device__ __forceinline__ T mul(T a, T b) {
    return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
  }
  static __device__ __forceinline__ T zero() { return make_float2(0.0f, 0.0f); }
  static __device__ __forceinline__ T relu6(T v) {
    return make_float2(fminf(fmaxf(v.x, 0.0f), 6.0f),
                       fminf(fmaxf(v.y, 0.0f), 6.0f));
  }
  static __device__ __forceinline__ T inside(T v) {
    return make_float2(v.x > 0.0f && v.x < 6.0f ? 1.0f : 0.0f,
                       v.y > 0.0f && v.y < 6.0f ? 1.0f : 0.0f);
  }
};

// The pair at p (channels c and c + 1; ok0, ok1: inside Cin): one access
// when `vec` (an even Cin, so p is aligned), else one per channel; a
// channel outside is 0 and not stored.
template <typename S>
__device__ __forceinline__ typename Pair<S>::T load_pair(const S* p, bool ok0,
                                                         bool ok1, bool vec) {
  using P = Pair<S>;
  if (vec && ok1) return *reinterpret_cast<const typename P::T*>(p);
  const S z = from_float<S>(0.0f);
  return P::join(ok0 ? p[0] : z, ok1 ? p[1] : z);
}

template <typename S>
__device__ __forceinline__ void store_pair(S* p, typename Pair<S>::T v,
                                           bool ok0, bool ok1, bool vec) {
  if (vec && ok1) {
    *reinterpret_cast<typename Pair<S>::T*>(p) = v;
    return;
  }
  if (ok0) p[0] = Pair<S>::lo(v);
  if (ok1) p[1] = Pair<S>::hi(v);
}

// 16 bytes from global to shared memory, asynchronously; zeros where !full.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(smem)), "l"(gmem), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- the warp's products ----------------------------------------------------
//
// A warp holds MT x NT tiles of m16n8, its accumulators in the layout of
// mma.sync m16n8k16: acc[i][j][e] is (row 16 i + g + 8 (e / 2), column
// 8 j + 2 u + e % 2) of the warp's tile, g = lane / 4, u = lane % 4. mma_step
// adds one 16-deep slice of A @ B. `a` points at A(the warp's first row, the
// slice's first k), stored [row][k] with rows `lda` elements apart or, kATrans,
// [k][row]; `b` at B(the slice's first k, the warp's first column), stored
// [column][k] or, kBTrans, [k][column]. mma_step_rows takes A by one pointer
// per row instead (rows gathered from anywhere in shared memory): the
// pointers of the rows that this lane addresses, see a_row.

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
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

// bf16: the A fragments af (see mma_step) times a 16-deep B slice.
template <int MT, int NT, bool kBTrans>
__device__ __forceinline__ void mma_times_b(float (&acc)[MT][NT][4],
                                            const uint32_t (&af)[MT][4],
                                            const bf16* b, int ldb, int lane) {
  static_assert(NT % 2 == 0, "B tiles load in pairs");
  const int l8 = lane & 7, hi8 = (lane >> 3) & 1, hi16 = lane >> 4;
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t bq[4];
    if (kBTrans)
      ldmatrix_x4_trans(bq, b + (l8 + 8 * hi8) * ldb + 8 * j + 8 * hi16);
    else
      ldmatrix_x4(bq, b + (8 * j + l8 + 8 * hi16) * ldb + 8 * hi8);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      mma_bf16(acc[i][j], af[i], bq[0], bq[1]);
      mma_bf16(acc[i][j + 1], af[i], bq[2], bq[3]);
    }
  }
}

// bf16: ldmatrix x4 gives the four 8 x 8 quarters of a 16 x 16 A slice (rows
// 0-7 / 8-15 by k 0-7 / 8-15, in that register order) and two n8 tiles of a
// B slice (k 0-7 and 8-15 of one, then of the next).
template <int MT, int NT, bool kATrans, bool kBTrans>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4],
                                         const bf16* a, int lda,
                                         const bf16* b, int ldb, int lane) {
  const int l8 = lane & 7, hi8 = (lane >> 3) & 1, hi16 = lane >> 4;
  uint32_t af[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (kATrans)
      ldmatrix_x4_trans(af[i], a + (l8 + 8 * hi16) * lda + 16 * i + 8 * hi8);
    else
      ldmatrix_x4(af[i], a + (16 * i + l8 + 8 * hi8) * lda + 8 * hi16);
  }
  mma_times_b<MT, NT, kBTrans>(acc, af, b, ldb, lane);
}

// f32: the same slice with CUDA-core FMAs, k in ascending order.
template <int MT, int NT, bool kATrans, bool kBTrans>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4],
                                         const float* a, int lda,
                                         const float* b, int ldb, int lane) {
  const int g = lane >> 2, u = lane & 3;
#pragma unroll 4
  for (int kk = 0; kk < 16; ++kk) {
    float av[MT][2], bv[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * i + g + 8 * h;
        av[i][h] = kATrans ? a[kk * lda + row] : a[row * lda + kk];
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * u + e;
        bv[j][e] = kBTrans ? b[kk * ldb + col] : b[col * ldb + kk];
      }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = fmaf(av[i][e >> 1], bv[j][e & 1], acc[i][j][e]);
  }
}

// The row of the warp's A tile whose address this lane gives to
// mma_step_rows for 16-row tile i and half h: bf16, the row of ldmatrix's
// lane (h unused, both halves are the same row); f32, row 16 i + g + 8 h of
// the accumulator layout.
template <typename S>
__device__ __forceinline__ int a_row(int i, int h, int lane);
template <>
__device__ __forceinline__ int a_row<bf16>(int i, int h, int lane) {
  (void)h;
  return 16 * i + (lane & 7) + 8 * ((lane >> 3) & 1);
}
template <>
__device__ __forceinline__ int a_row<float>(int i, int h, int lane) {
  return 16 * i + (lane >> 2) + 8 * h;
}

// mma_step with A given by rows: arow[i][h] points at A(a_row(i, h), the
// slice's first k), rows stored [row][k].
template <int MT, int NT, bool kBTrans>
__device__ __forceinline__ void mma_step_rows(float (&acc)[MT][NT][4],
                                              const bf16* const (&arow)[MT][2],
                                              const bf16* b, int ldb,
                                              int lane) {
  const int hi16 = lane >> 4;
  uint32_t af[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) ldmatrix_x4(af[i], arow[i][0] + 8 * hi16);
  mma_times_b<MT, NT, kBTrans>(acc, af, b, ldb, lane);
}

template <int MT, int NT, bool kBTrans>
__device__ __forceinline__ void mma_step_rows(float (&acc)[MT][NT][4],
                                              const float* const (&arow)[MT][2],
                                              const float* b, int ldb,
                                              int lane) {
  const int u = lane & 3;
#pragma unroll 4
  for (int kk = 0; kk < 16; ++kk) {
    float av[MT][2], bv[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) av[i][h] = arow[i][h][kk];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * u + e;
        bv[j][e] = kBTrans ? b[kk * ldb + col] : b[col * ldb + kk];
      }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = fmaf(av[i][e >> 1], bv[j][e & 1], acc[i][j][e]);
  }
}

}  // namespace
