// Native host runtime of the PyTorch/CUDA port (copy of the JAX package's
// uasr_native.cpp, which the port may not import).
//
//   * batch_edit_distance: O(N*M) Levenshtein with a rolling row,
//     parallel over the batch with std::thread.
//   * read_wav_pcm16 / batch_read_wavs: PCM16 WAV decode straight into a
//     caller-provided float32 batch matrix (zero-padded), parallel over
//     files: the decode and pad stage of the streaming loader
//     (uasr_torch/data/loader.py) with no Python in the loop.
//
// Plain C ABI, loaded with ctypes by uasr_torch/native/__init__.py.
// Built with the host compiler at first use by uasr_torch/_build.py
// (load_host), never at import.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ----------------------------------------------------------- edit distance

static int32_t levenshtein_one(const int32_t* ref, int32_t n,
                               const int32_t* hyp, int32_t m) {
  std::vector<int32_t> row(n + 1);
  for (int32_t j = 0; j <= n; ++j) row[j] = j;
  for (int32_t i = 1; i <= m; ++i) {
    int32_t diag = row[0];  // dp[i-1][j-1]
    row[0] = i;
    for (int32_t j = 1; j <= n; ++j) {
      int32_t up = row[j];  // dp[i-1][j]
      int32_t cost = (ref[j - 1] == hyp[i - 1]) ? 0 : 1;
      row[j] = std::min({up + 1, row[j - 1] + 1, diag + cost});
      diag = up;
    }
  }
  return row[n];
}

// refs [B, N], hyps [B, M] (row-major), lengths per row; out [B].
void batch_edit_distance(const int32_t* refs, const int32_t* ref_lens,
                         const int32_t* hyps, const int32_t* hyp_lens,
                         int32_t B, int32_t N, int32_t M, int32_t* out,
                         int32_t num_threads) {
  if (num_threads <= 0)
    num_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
  num_threads = std::max(1, std::min(num_threads, B));
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int32_t b = next.fetch_add(1);
      if (b >= B) return;
      out[b] = levenshtein_one(refs + static_cast<int64_t>(b) * N, ref_lens[b],
                               hyps + static_cast<int64_t>(b) * M, hyp_lens[b]);
    }
  };
  std::vector<std::thread> threads;
  for (int32_t t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// ------------------------------------------------------------- wav decode

// Minimal RIFF/WAVE PCM16 reader. Returns sample count written (mono-mixed,
// normalized to [-1, 1]), or -1 on error. Truncates to max_samples.
int64_t read_wav_pcm16(const char* path, float* out, int64_t max_samples,
                       int32_t* sample_rate_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  auto fail = [&]() -> int64_t { std::fclose(f); return -1; };

  char riff[4], wave[4];
  uint32_t riff_size;
  if (std::fread(riff, 1, 4, f) != 4 || std::memcmp(riff, "RIFF", 4)) return fail();
  if (std::fread(&riff_size, 4, 1, f) != 1) return fail();
  if (std::fread(wave, 1, 4, f) != 4 || std::memcmp(wave, "WAVE", 4)) return fail();

  uint16_t audio_format = 0, channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  int64_t written = -1;

  char chunk_id[4];
  uint32_t chunk_size;
  while (std::fread(chunk_id, 1, 4, f) == 4 &&
         std::fread(&chunk_size, 4, 1, f) == 1) {
    if (!std::memcmp(chunk_id, "fmt ", 4)) {
      uint8_t buf[16];
      if (chunk_size < 16 || std::fread(buf, 1, 16, f) != 16) return fail();
      std::memcpy(&audio_format, buf + 0, 2);
      std::memcpy(&channels, buf + 2, 2);
      std::memcpy(&sample_rate, buf + 4, 4);
      std::memcpy(&bits, buf + 14, 2);
      if (chunk_size > 16) std::fseek(f, chunk_size - 16, SEEK_CUR);
    } else if (!std::memcmp(chunk_id, "data", 4)) {
      if (audio_format != 1 || bits != 16 || channels == 0) return fail();
      int64_t n_frames = chunk_size / (2 * channels);
      int64_t keep = std::min<int64_t>(n_frames, max_samples);
      std::vector<int16_t> raw(static_cast<size_t>(keep) * channels);
      if (std::fread(raw.data(), 2, raw.size(), f) != raw.size()) return fail();
      const float scale = 1.0f / 32768.0f;
      if (channels == 1) {
        for (int64_t i = 0; i < keep; ++i) out[i] = raw[i] * scale;
      } else {
        for (int64_t i = 0; i < keep; ++i) {
          int32_t acc = 0;
          for (int c = 0; c < channels; ++c) acc += raw[i * channels + c];
          out[i] = (acc / static_cast<float>(channels)) * scale;
        }
      }
      written = keep;
      break;
    } else {
      std::fseek(f, (chunk_size + 1) & ~1u, SEEK_CUR);  // chunks are padded
    }
  }
  std::fclose(f);
  if (written >= 0 && sample_rate_out) *sample_rate_out = (int32_t)sample_rate;
  return written;
}

// Decode B wavs in parallel into a zero-padded [B, max_samples] float32
// matrix. paths: B null-terminated strings concatenated (offsets given).
// out_lengths[b] = samples written, or -1 on per-file error.
void batch_read_wavs(const char* paths_blob, const int64_t* path_offsets,
                     int32_t B, float* out, int64_t max_samples,
                     int64_t* out_lengths, int32_t* out_rates,
                     int32_t num_threads) {
  if (num_threads <= 0)
    num_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
  num_threads = std::max(1, std::min(num_threads, B));
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int32_t b = next.fetch_add(1);
      if (b >= B) return;
      float* row = out + static_cast<int64_t>(b) * max_samples;
      std::memset(row, 0, sizeof(float) * max_samples);
      int32_t sr = 0;
      out_lengths[b] =
          read_wav_pcm16(paths_blob + path_offsets[b], row, max_samples, &sr);
      out_rates[b] = sr;
    }
  };
  std::vector<std::thread> threads;
  for (int32_t t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
