// stylish_io: native batched WAV loader for the host data pipeline.
//
// The port's copy of stylish_tts_tpu/native/stylish_io.cpp (same code, so
// both packages load the same samples).
//
// Replaces the reference's soundfile/librosa C dependencies
// (reference: dataloader.py:159-175) with a first-party threaded
// loader: RIFF parse -> PCM decode -> downmix -> polyphase-free linear
// resample -> center-pad into a caller-provided (n, target_len) f32
// buffer.  One call loads a whole batch in parallel.
//
// Build: native/__init__.py runs g++ -O3 -shared -fPIC on the first call.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavData {
  std::vector<float> samples;  // mono
  uint32_t sample_rate = 0;
  bool ok = false;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

WavData read_wav(const char* path) {
  WavData out;
  FILE* f = fopen(path, "rb");
  if (!f) return out;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size < 44) { fclose(f); return out; }
  std::vector<uint8_t> buf((size_t)size);
  if (fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    return out;
  }
  fclose(f);
  if (memcmp(buf.data(), "RIFF", 4) || memcmp(buf.data() + 8, "WAVE", 4))
    return out;

  uint16_t channels = 1, bits = 16, fmt = 1;
  uint32_t rate = 0;
  const uint8_t* data = nullptr;
  uint32_t data_size = 0;
  size_t pos = 12;
  while (pos + 8 <= (size_t)size) {
    const uint8_t* hdr = buf.data() + pos;
    uint32_t chunk = rd_u32(hdr + 4);
    if (!memcmp(hdr, "fmt ", 4) && pos + 8 + 16 <= (size_t)size) {
      const uint8_t* p = hdr + 8;
      fmt = rd_u16(p);
      channels = rd_u16(p + 2);
      rate = rd_u32(p + 4);
      bits = rd_u16(p + 14);
    } else if (!memcmp(hdr, "data", 4)) {
      data = hdr + 8;
      data_size = chunk;
      if (pos + 8 + data_size > (size_t)size)
        data_size = (uint32_t)(size - pos - 8);
      break;
    }
    pos += 8 + chunk + (chunk & 1);
  }
  if (!data || !rate || !channels) return out;

  size_t frame_bytes = (size_t)channels * (bits / 8);
  size_t frames = frame_bytes ? data_size / frame_bytes : 0;
  out.samples.resize(frames);
  // take channel 0 (parity with the reference's downmix, dataloader.py:160);
  // bulk-copy the raw chunk once, then a vectorizable strided convert.
  if (bits == 16 && (fmt == 1 || fmt == 0xFFFE)) {
    std::vector<int16_t> raw(frames * channels);
    memcpy(raw.data(), data, frames * frame_bytes);
    const int16_t* src = raw.data();
    float* dst = out.samples.data();
    const float scale = 1.0f / 32768.0f;
    for (size_t i = 0; i < frames; i++) dst[i] = src[i * channels] * scale;
  } else if (bits == 32 && fmt == 3) {  // float32
    std::vector<float> raw(frames * channels);
    memcpy(raw.data(), data, frames * frame_bytes);
    for (size_t i = 0; i < frames; i++)
      out.samples[i] = raw[i * channels];
  } else if (bits == 32 && fmt == 1) {  // int32
    std::vector<int32_t> raw(frames * channels);
    memcpy(raw.data(), data, frames * frame_bytes);
    const float scale = 1.0f / 2147483648.0f;
    for (size_t i = 0; i < frames; i++)
      out.samples[i] = raw[i * channels] * scale;
  } else {
    return out;
  }
  out.sample_rate = rate;
  out.ok = true;
  return out;
}

std::vector<float> resample_linear(const std::vector<float>& x, uint32_t sr_in,
                                   uint32_t sr_out) {
  if (sr_in == sr_out || x.empty()) return x;
  size_t n_out = (size_t)((uint64_t)x.size() * sr_out / sr_in);
  std::vector<float> y(n_out);
  double ratio = (double)sr_in / sr_out;
  for (size_t i = 0; i < n_out; i++) {
    double t = i * ratio;
    size_t i0 = (size_t)t;
    size_t i1 = i0 + 1 < x.size() ? i0 + 1 : x.size() - 1;
    double frac = t - (double)i0;
    y[i] = (float)((1.0 - frac) * x[i0] + frac * x[i1]);
  }
  return y;
}

void load_one(const char* path, int32_t target_sr, int64_t target_len,
              float* out, int32_t* status) {
  WavData wav = read_wav(path);
  if (!wav.ok) {
    *status = -1;
    memset(out, 0, sizeof(float) * (size_t)target_len);
    return;
  }
  std::vector<float> audio =
      resample_linear(wav.samples, wav.sample_rate, (uint32_t)target_sr);
  int64_t n = (int64_t)audio.size();
  memset(out, 0, sizeof(float) * (size_t)target_len);
  if (n >= target_len) {
    // centered crop
    int64_t off = (n - target_len) / 2;
    memcpy(out, audio.data() + off, sizeof(float) * (size_t)target_len);
  } else {
    // center-pad (reference dataloader.py:166-175)
    int64_t pad_start = (target_len - n) / 2;
    memcpy(out + pad_start, audio.data(), sizeof(float) * (size_t)n);
  }
  *status = (int32_t)n;
}

}  // namespace

extern "C" {

// Load a batch of WAVs in parallel into out (n, target_len) float32.
// statuses[i]: resampled length on success, -1 on failure.
void stylish_load_wav_batch(const char** paths, int32_t n, int32_t target_sr,
                            int64_t target_len, float* out,
                            int32_t* statuses, int32_t n_threads) {
  if (n_threads <= 0) n_threads = (int32_t)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::vector<std::thread> pool;
  std::atomic<int32_t> counter(0);
  for (int t = 0; t < n_threads; t++) {
    pool.emplace_back([&]() {
      while (true) {
        int32_t i = counter.fetch_add(1);
        if (i >= n) break;
        load_one(paths[i], target_sr, target_len, out + (size_t)i * target_len,
                 statuses + i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

// Single-file resampled frame count (header-only scan).
int64_t stylish_wav_frames(const char* path, int32_t target_sr) {
  WavData wav = read_wav(path);
  if (!wav.ok) return -1;
  if (wav.sample_rate == (uint32_t)target_sr) return (int64_t)wav.samples.size();
  return (int64_t)((uint64_t)wav.samples.size() * target_sr / wav.sample_rate);
}
}
