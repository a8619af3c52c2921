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
// Bound: device-memory bandwidth. Each output sample reads 2 bytes of bank
// and 4 bytes of background and writes 4 bytes, with no reuse: 61 MB per
// call at B = 384, T = 16000. The design keeps every access coalesced:
// thread i of a row handles sample i, so a warp reads 32 consecutive bank
// samples (contiguous except where the roll wraps), 32 consecutive
// background samples and writes 32 consecutive outputs. Each block loads
// its row's five scalars itself. Vector loads and splitting the row at the
// wrap point are left for later.
//
// Offsets are 64-bit: file_id * T passes 2^31 at ~134k clips of 16000.
// The scale, multiply and add are rounded one at a time (no FMA
// contraction), in the JAX order, so the result equals the plain PyTorch
// version to the last bit.
//
// A row whose file id or background window lies outside its bank is
// written as NaN instead of being read out of bounds.

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename Idx>
__global__ void decode_augment_kernel(const int16_t* __restrict__ bank,
                                      int64_t num_clips, int64_t t,
                                      const float* __restrict__ bg_flat,
                                      int64_t bg_len,
                                      const Idx* __restrict__ file_ids,
                                      const Idx* __restrict__ shifts,
                                      const float* __restrict__ fg_vol,
                                      const Idx* __restrict__ bg_pos,
                                      const float* __restrict__ bg_vol,
                                      float* __restrict__ out) {
  const int64_t b = blockIdx.y;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= t) return;
  const int64_t f = static_cast<int64_t>(file_ids[b]);
  const int64_t p = static_cast<int64_t>(bg_pos[b]);
  float* dst = out + b * t + i;
  if (f < 0 || f >= num_clips || p < 0 || p + t > bg_len) {
    *dst = NAN;
    return;
  }
  // np.roll: out[i] = clip[(i - s) mod T] = clip[(i + start) mod T] with
  // start = (-s) mod T taken non-negative.
  int64_t start = (-static_cast<int64_t>(shifts[b])) % t;
  if (start < 0) start += t;
  int64_t src = i + start;
  if (src >= t) src -= t;
  const float fg_scale = __fdiv_rn(fg_vol[b], 32768.0f);
  const float fg = __fmul_rn(static_cast<float>(bank[f * t + src]), fg_scale);
  const float bg = __fmul_rn(bg_flat[p + i], bg_vol[b]);
  *dst = __fadd_rn(fg, bg);
}

template <typename Idx>
int launch(const void* bank, int64_t num_clips, int64_t t, const void* bg_flat,
           int64_t bg_len, const void* file_ids, const void* shifts,
           const void* fg_vol, const void* bg_pos, const void* bg_vol,
           void* out, int64_t batch, void* stream) {
  if (batch == 0 || t == 0) return 0;
  const dim3 grid(static_cast<unsigned>((t + kThreads - 1) / kThreads),
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
