// Fused decode+augment for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   speech_recognition_tpu/ops/pallas/augment_kernel.py::fused_decode_augment_flat
// on the flat [N, T] int16 clip bank. For each batch row b and sample i:
//
//   out[b, i] = bank[f[b], (i - shift[b]) mod T] * (fg_vol[b] / 32768)
//             + bg_flat[bg_pos[b] + i] * bg_vol[b]
//
// i.e. gather + int16 decode + circular np.roll + background mix in one
// pass. The TPU kernel needed a doubled chunk-stack bank and sublane/lane
// rotates to satisfy Mosaic's DMA rules; here a modular index into the flat
// row does the roll.
//
// Bound: device-memory bytes. At B = 384, T = 16000 the draws need 43.1 MB
// (chip_smoke.py's decode_augment_bound: the bank rows of rows with
// fg_vol != 0, the union of the background windows of rows with
// bg_vol != 0, the [B, T] f32 output), 0.0129 ms at 3.35 TB/s; 3 f32
// operations per sample are far below the compute bound. The design:
//
// 1. Per-row work once per block. A block writes one row's segment of
//    2,048 outputs (256 threads x 2 quads of 4; 8 blocks a row at
//    T = 16000). Its first thread reads the row's five scalars and forms
//    the row's plan in shared memory: the in-range check, the start of the
//    roll (-shift) mod T in 64 bits, fg_vol / 32768, and where the output
//    row's first 16-byte unit begins.
// 2. 16-byte accesses. Outputs go out as float4 stores, thread u of a warp
//    beside thread u + 1; the outputs before the row's first 16-byte unit
//    and after its last (only when 4 T is not a multiple of 16) are written
//    one at a time. A quad's four bank samples come from the 16-byte unit
//    that holds the first of them (and the next unit when they run into
//    it), shifted into place with __funnelshift_r; its four background
//    samples from one or two 16-byte units the same way. Alignment is taken
//    from the absolute address, so bank and bg_flat may be views at any
//    element offset. A load never touches a 16-byte unit that holds none
//    of the samples it needs, so no load leaves the allocation (the last
//    bank row, the largest background window). The roll splits each row
//    at its wrap point: a quad whose samples wrap (at most one a row)
//    reads them one at a time.
// 3. No read for a zero-volume term. A row with fg_vol == 0 reads no bank,
//    a row with bg_vol == 0 no background (the branch is uniform over the
//    block). The skipped term is taken as +0 where the plain version has
//    0 * x = +-0 (x finite), so every output equals the plain version's in
//    value; only the sign of an exact zero may differ.
//
// Offsets are 64-bit: file_id * T passes 2^31 at ~134k clips of 16000.
// The scale, multiply and add are rounded one at a time (no FMA
// contraction), in the JAX order, so the result equals the plain PyTorch
// version to the last bit.
//
// A row whose file id or background window lies outside its bank is
// written whole as NaN instead of being read out of bounds, whatever its
// volumes.

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kQuads = 2;                              // quads per thread
constexpr int64_t kSegment = 4 * kThreads * kQuads;    // outputs per block

// One row's plan, formed once per block.
struct Row {
  const int16_t* clip;   // the bank row
  const float* bg;       // the background window
  int64_t start;         // (-shift) mod T: out[i] = clip[(i + start) mod T]
  int64_t head;          // outputs before the row's first 16-byte unit
  float fg_scale;
  float bg_vol;
  bool ok, use_fg, use_bg;
};

// Four int16 samples from p (2-byte aligned), as floats.
__device__ __forceinline__ void load_bank4(const int16_t* p, float (&x)[4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int4* unit = reinterpret_cast<const int4*>(a & ~uintptr_t{15});
  const int m = static_cast<int>((a >> 1) & 7);        // first sample's slot
  const int4 lo = __ldg(unit);
  const int4 hi = m > 4 ? __ldg(unit + 1) : make_int4(0, 0, 0, 0);
  // slots m..m+3 of the 16 in lo:hi lie in words m/2 .. m/2 + 2
  uint32_t w0 = lo.x, w1 = lo.y, w2 = lo.z, w3 = lo.w;
  const uint32_t w4 = hi.x, w5 = hi.y;
  if (m & 4) {
    w0 = w2; w1 = w3; w2 = w4; w3 = w5;
  }
  if (m & 2) {
    w0 = w1; w1 = w2; w2 = w3;
  }
  const unsigned shift = (m & 1) * 16;
  const uint32_t r0 = __funnelshift_r(w0, w1, shift);
  const uint32_t r1 = __funnelshift_r(w1, w2, shift);
  x[0] = static_cast<float>(static_cast<int16_t>(r0 & 0xffff));
  x[1] = static_cast<float>(static_cast<int16_t>(r0 >> 16));
  x[2] = static_cast<float>(static_cast<int16_t>(r1 & 0xffff));
  x[3] = static_cast<float>(static_cast<int16_t>(r1 >> 16));
}

// Four floats from p (4-byte aligned).
__device__ __forceinline__ void load_bg4(const float* p, float (&x)[4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const float4* unit = reinterpret_cast<const float4*>(a & ~uintptr_t{15});
  const int q = static_cast<int>((a >> 2) & 3);        // first float's slot
  const float4 lo = __ldg(unit);
  const float4 hi = q ? __ldg(unit + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
  float w0 = lo.x, w1 = lo.y, w2 = lo.z, w3 = lo.w, w4 = hi.x;
  const float w5 = hi.y, w6 = hi.z;
  if (q & 2) {
    w0 = w2; w1 = w3; w2 = w4; w3 = w5; w4 = w6;
  }
  if (q & 1) {
    w0 = w1; w1 = w2; w2 = w3; w3 = w4;
  }
  x[0] = w0; x[1] = w1; x[2] = w2; x[3] = w3;
}

// out[i] of the row, read one sample at a time.
__device__ __forceinline__ float one_sample(const Row& r, int64_t t,
                                           int64_t i) {
  if (!r.ok) return NAN;
  float fg = 0.0f, bg = 0.0f;
  if (r.use_fg) {
    int64_t src = i + r.start;
    if (src >= t) src -= t;
    fg = __fmul_rn(static_cast<float>(r.clip[src]), r.fg_scale);
  }
  if (r.use_bg) bg = __fmul_rn(r.bg[i], r.bg_vol);
  return __fadd_rn(fg, bg);
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
decode_augment_kernel(const int16_t* __restrict__ bank, int64_t num_clips,
                      int64_t t, const float* __restrict__ bg_flat,
                      int64_t bg_len, const Idx* __restrict__ file_ids,
                      const Idx* __restrict__ shifts,
                      const float* __restrict__ fg_vol,
                      const Idx* __restrict__ bg_pos,
                      const float* __restrict__ bg_vol,
                      float* __restrict__ out) {
  __shared__ Row plan;
  const int64_t b = blockIdx.y;
  float* dst = out + b * t;
  if (threadIdx.x == 0) {
    const int64_t f = static_cast<int64_t>(file_ids[b]);
    const int64_t p = static_cast<int64_t>(bg_pos[b]);
    Row r;
    r.ok = f >= 0 && f < num_clips && p >= 0 && p <= bg_len - t;
    // np.roll: out[i] = clip[(i - s) mod T] = clip[(i + start) mod T]
    r.start = (-static_cast<int64_t>(shifts[b])) % t;
    if (r.start < 0) r.start += t;
    r.clip = bank + (r.ok ? f * t : 0);
    r.bg = bg_flat + (r.ok ? p : 0);
    r.fg_scale = __fdiv_rn(fg_vol[b], 32768.0f);
    r.bg_vol = bg_vol[b];
    r.use_fg = fg_vol[b] != 0.0f;
    r.use_bg = r.bg_vol != 0.0f;
    const int64_t lead = (reinterpret_cast<uintptr_t>(dst) >> 2) & 3;
    r.head = lead ? (4 - lead < t ? 4 - lead : t) : 0;
    plan = r;
  }
  __syncthreads();
  const Row r = plan;
  const int64_t quads = (t - r.head) / 4;

  // the row's head and tail, one output at a time (first block only)
  if (blockIdx.x == 0) {
    const int64_t tail = t - r.head - 4 * quads;
    for (int64_t k = threadIdx.x; k < r.head + tail; k += kThreads) {
      const int64_t i = k < r.head ? k : 4 * quads + k;
      dst[i] = one_sample(r, t, i);
    }
  }

  // this block's quads: load both first, then combine and store
  const int64_t q0 = blockIdx.x * (kSegment / 4) + threadIdx.x;
  float fg[kQuads][4], bg[kQuads][4];
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const int64_t q = q0 + k * kThreads;
    const int64_t j = r.head + 4 * q;
#pragma unroll
    for (int e = 0; e < 4; ++e) fg[k][e] = bg[k][e] = 0.0f;
    if (q >= quads || !r.ok) continue;
    if (r.use_fg) {
      int64_t src = j + r.start;
      if (src >= t) src -= t;
      if (src + 4 <= t) {
        load_bank4(r.clip + src, fg[k]);
      } else {                          // the wrap point lies in this quad
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t s = src + e < t ? src + e : src + e - t;
          fg[k][e] = static_cast<float>(r.clip[s]);
        }
      }
    }
    if (r.use_bg) load_bg4(r.bg + j, bg[k]);
  }
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const int64_t q = q0 + k * kThreads;
    if (q >= quads) continue;
    float4 v;
    if (!r.ok) {
      v = make_float4(NAN, NAN, NAN, NAN);
    } else {
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = r.use_fg ? __fmul_rn(fg[k][e], r.fg_scale) : 0.0f;
        const float c = r.use_bg ? __fmul_rn(bg[k][e], r.bg_vol) : 0.0f;
        y[e] = __fadd_rn(a, c);
      }
      v = make_float4(y[0], y[1], y[2], y[3]);
    }
    *reinterpret_cast<float4*>(dst + r.head + 4 * q) = v;
  }
}

template <typename Idx>
int launch(const void* bank, int64_t num_clips, int64_t t, const void* bg_flat,
           int64_t bg_len, const void* file_ids, const void* shifts,
           const void* fg_vol, const void* bg_pos, const void* bg_vol,
           void* out, int64_t batch, void* stream) {
  if (batch == 0 || t == 0) return 0;
  const dim3 grid(static_cast<unsigned>((t + kSegment - 1) / kSegment),
                  static_cast<unsigned>(batch));
  decode_augment_kernel<Idx><<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(bank), num_clips, t,
      static_cast<const float*>(bg_flat), bg_len,
      static_cast<const Idx*>(file_ids), static_cast<const Idx*>(shifts),
      static_cast<const float*>(fg_vol), static_cast<const Idx*>(bg_pos),
      static_cast<const float*>(bg_vol), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes: every pointer and the stream as void*,
// sizes as int64. They return cudaGetLastError() after the launch (0 when
// the launch was accepted). The index vectors are int32 or int64.
extern "C" int decode_augment_i32(const void* bank, int64_t num_clips,
                                  int64_t t, const void* bg_flat,
                                  int64_t bg_len, const void* file_ids,
                                  const void* shifts, const void* fg_vol,
                                  const void* bg_pos, const void* bg_vol,
                                  void* out, int64_t batch, void* stream) {
  return launch<int32_t>(bank, num_clips, t, bg_flat, bg_len, file_ids,
                         shifts, fg_vol, bg_pos, bg_vol, out, batch, stream);
}

extern "C" int decode_augment_i64(const void* bank, int64_t num_clips,
                                  int64_t t, const void* bg_flat,
                                  int64_t bg_len, const void* file_ids,
                                  const void* shifts, const void* fg_vol,
                                  const void* bg_pos, const void* bg_vol,
                                  void* out, int64_t batch, void* stream) {
  return launch<int64_t>(bank, num_clips, t, bg_flat, bg_len, file_ids,
                         shifts, fg_vol, bg_pos, bg_vol, out, batch, stream);
}

extern "C" const char* decode_augment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
