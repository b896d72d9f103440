// Native WAV (RIFF) reader/writer for the phase-vocoder framework.
//
// Counterpart of the reference's host-side C++ WAV handling
// (reference component C2, SURVEY.md SS2.1: RIFF parse, PCM16<->float
// convert). Exposed through a plain C ABI consumed via ctypes from
// phase_vocoder/io/native.py — no pybind11 dependency.
//
// Supported payloads: PCM16 (format 1), PCM32 (format 1), IEEE float32
// (format 3), plus WAVE_FORMAT_EXTENSIBLE wrapping either. Multi-channel
// data is returned interleaved; the Python layer downmixes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Riff {
  const uint8_t* p;
  size_t n;
  size_t off = 0;

  bool read(void* dst, size_t len) {
    if (off + len > n) return false;
    std::memcpy(dst, p + off, len);
    off += len;
    return true;
  }
  bool skip(size_t len) {
    if (off + len > n) return false;
    off += len;
    return true;
  }
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) { return (uint16_t)p[0] | ((uint16_t)p[1] << 8); }

}  // namespace

extern "C" {

// Returns 0 on success. On success *out holds malloc'd interleaved float32
// samples (|*n_frames| * |*channels| values) scaled to [-1, 1); free with
// pvwav_free.
int pvwav_read(const char* path, float** out, int64_t* n_frames, int* channels,
               int* sample_rate) {
  *out = nullptr;
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 44) {
    std::fclose(f);
    return -2;
  }
  std::vector<uint8_t> buf((size_t)fsize);
  size_t got = std::fread(buf.data(), 1, (size_t)fsize, f);
  std::fclose(f);
  if (got != (size_t)fsize) return -3;

  if (std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0)
    return -4;

  uint16_t fmt = 0, nch = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;

  size_t off = 12;
  while (off + 8 <= buf.size()) {
    const uint8_t* hdr = buf.data() + off;
    uint32_t chunk_len = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    if (off + 8 + chunk_len > buf.size())
      chunk_len = (uint32_t)(buf.size() - off - 8);  // tolerate truncated tail
    if (std::memcmp(hdr, "fmt ", 4) == 0 && chunk_len >= 16) {
      fmt = rd_u16(body);
      nch = rd_u16(body + 2);
      sr = rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (fmt == 0xFFFE && chunk_len >= 40)  // WAVE_FORMAT_EXTENSIBLE
        fmt = rd_u16(body + 24);             // sub-format GUID leading u16
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      data = body;
      data_len = chunk_len;
    }
    off += 8 + chunk_len + (chunk_len & 1);  // chunks are word-aligned
  }
  if (!data || nch == 0 || sr == 0) return -5;

  int64_t frames;
  float* dst;
  if (fmt == 1 && bits == 16) {
    frames = (int64_t)(data_len / (2 * nch));
    dst = (float*)std::malloc(sizeof(float) * (size_t)frames * nch);
    if (!dst) return -6;
    const float scale = 1.0f / 32768.0f;
    for (int64_t i = 0; i < frames * nch; ++i)
      dst[i] = (int16_t)rd_u16(data + 2 * i) * scale;
  } else if (fmt == 1 && bits == 32) {
    frames = (int64_t)(data_len / (4 * nch));
    dst = (float*)std::malloc(sizeof(float) * (size_t)frames * nch);
    if (!dst) return -6;
    const double scale = 1.0 / 2147483648.0;
    for (int64_t i = 0; i < frames * nch; ++i)
      dst[i] = (float)((int32_t)rd_u32(data + 4 * i) * scale);
  } else if (fmt == 3 && bits == 32) {
    frames = (int64_t)(data_len / (4 * nch));
    dst = (float*)std::malloc(sizeof(float) * (size_t)frames * nch);
    if (!dst) return -6;
    std::memcpy(dst, data, sizeof(float) * (size_t)frames * nch);
  } else {
    return -7;  // unsupported format
  }

  *out = dst;
  *n_frames = frames;
  *channels = (int)nch;
  *sample_rate = (int)sr;
  return 0;
}

void pvwav_free(float* p) { std::free(p); }

// Write mono (or interleaved) float samples as PCM16. Returns 0 on success.
int pvwav_write(const char* path, const float* samples, int64_t n_frames,
                int channels, int sample_rate) {
  if (channels <= 0 || n_frames < 0) return -1;
  const int64_t n = n_frames * channels;
  const uint32_t data_len = (uint32_t)(n * 2);
  const uint32_t byte_rate = (uint32_t)sample_rate * channels * 2;

  std::vector<int16_t> pcm((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    float v = samples[i];
    if (v > 32767.0f / 32768.0f) v = 32767.0f / 32768.0f;
    if (v < -1.0f) v = -1.0f;
    float scaled = v * 32768.0f;
    // Round half away from zero, matching numpy round-then-cast semantics
    // closely enough for the PCM16 quantization bound (2^-15) tests.
    pcm[(size_t)i] = (int16_t)(scaled >= 0.0f ? (int32_t)(scaled + 0.5f)
                                              : (int32_t)(scaled - 0.5f));
  }

  uint8_t hdr[44];
  std::memcpy(hdr, "RIFF", 4);
  uint32_t riff_len = 36 + data_len;
  std::memcpy(hdr + 4, &riff_len, 4);
  std::memcpy(hdr + 8, "WAVEfmt ", 8);
  uint32_t fmt_len = 16;
  std::memcpy(hdr + 16, &fmt_len, 4);
  uint16_t fmt = 1, nch = (uint16_t)channels, bits = 16,
           block = (uint16_t)(channels * 2);
  std::memcpy(hdr + 20, &fmt, 2);
  std::memcpy(hdr + 22, &nch, 2);
  uint32_t sr32 = (uint32_t)sample_rate;
  std::memcpy(hdr + 24, &sr32, 4);
  std::memcpy(hdr + 28, &byte_rate, 4);
  std::memcpy(hdr + 32, &block, 2);
  std::memcpy(hdr + 34, &bits, 2);
  std::memcpy(hdr + 36, "data", 4);
  std::memcpy(hdr + 40, &data_len, 4);

  FILE* f = std::fopen(path, "wb");
  if (!f) return -2;
  bool ok = std::fwrite(hdr, 1, 44, f) == 44 &&
            std::fwrite(pcm.data(), 2, (size_t)n, f) == (size_t)n;
  std::fclose(f);
  return ok ? 0 : -3;
}

}  // extern "C"
