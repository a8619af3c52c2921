// Multithreaded batch WAV decoder, host C++ (no device code).
//
// Decodes many 16-bit PCM WAV files in parallel into one packed int16
// buffer [n, desired_samples], ready for one host-to-device copy. The
// semantics are TF decode_wav's, as data/wav.py's numpy parser has them:
// channel 0 of complete frames only, zero-padded or cropped to
// desired_samples (the 1/32768 scale is applied on the device).
//
// Built with the host compiler by ops/kernels/build.py at first use and
// loaded with ctypes by data/wav.py::decode_batch_int16.
//
// ABI: wavio_decode_batch(paths, n, desired_samples, out, lengths,
//                         num_threads) -> 0.
// lengths[i] receives file i's frame count before the pad or crop, or -1
// when the file cannot be read or is not 16-bit PCM RIFF/WAVE; that row
// is zeroed, and the caller decodes the file again to name the fault.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

uint32_t tag(const char* s) {
  return static_cast<uint32_t>(static_cast<uint8_t>(s[0])) |
         (static_cast<uint32_t>(static_cast<uint8_t>(s[1])) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(s[2])) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(s[3])) << 24);
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  bool ok = std::fseek(f, 0, SEEK_END) == 0;
  long size = ok ? std::ftell(f) : -1;
  ok = size >= 0 && std::fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    buf->resize(static_cast<size_t>(size));
    ok = std::fread(buf->data(), 1, buf->size(), f) == buf->size();
  }
  std::fclose(f);
  return ok;
}

// Decode one file into out[0, desired). Returns its frame count, or -1.
int32_t decode_one(const char* path, int desired, int16_t* out) {
  std::memset(out, 0, static_cast<size_t>(desired) * sizeof(int16_t));
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf) || buf.size() < 12 ||
      std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0)
    return -1;

  bool have_fmt = false;
  uint16_t format = 0, channels = 0, bits = 0;
  const uint8_t* data = nullptr;
  size_t data_bytes = 0;
  const size_t n = buf.size();
  size_t pos = 12;
  // Walk the chunks until both fmt and data are found; chunks are
  // word-aligned (a pad byte follows an odd size).
  while (pos + 8 <= n && !(have_fmt && data)) {
    uint32_t id, size;
    std::memcpy(&id, buf.data() + pos, 4);
    std::memcpy(&size, buf.data() + pos + 4, 4);
    const size_t body = pos + 8;
    if (id == tag("fmt ")) {
      if (size < 16 || body + 16 > n) return -1;  // malformed fmt chunk
      std::memcpy(&format, buf.data() + body, 2);
      std::memcpy(&channels, buf.data() + body + 2, 2);
      std::memcpy(&bits, buf.data() + body + 14, 2);
      have_fmt = true;
    } else if (id == tag("data")) {
      // a data chunk that claims more than the file holds is clamped
      data = buf.data() + body;
      data_bytes = size < n - body ? size : n - body;
    }
    pos = body + static_cast<size_t>(size) + (size & 1u);
  }
  if (!have_fmt || !data || format != 1 || bits != 16) return -1;
  if (channels == 0) channels = 1;
  const size_t frames = data_bytes / 2 / channels;
  const size_t copy = frames < static_cast<size_t>(desired)
                          ? frames : static_cast<size_t>(desired);
  if (channels == 1) {
    std::memcpy(out, data, copy * sizeof(int16_t));
  } else {
    const size_t stride = static_cast<size_t>(channels) * sizeof(int16_t);
    for (size_t i = 0; i < copy; ++i)
      std::memcpy(out + i, data + i * stride, sizeof(int16_t));
  }
  return frames > INT32_MAX ? INT32_MAX : static_cast<int32_t>(frames);
}

}  // namespace

extern "C" int wavio_decode_batch(const char** paths, int n,
                                  int desired_samples, int16_t* out,
                                  int32_t* lengths, int num_threads) {
  if (n <= 0) return 0;
  if (num_threads <= 0) num_threads = 4;
  if (num_threads > n) num_threads = n;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1))
      lengths[i] = decode_one(
          paths[i], desired_samples,
          out + static_cast<size_t>(i) * static_cast<size_t>(desired_samples));
  };
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(num_threads));
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return 0;
}
