// Native host-side IO for the port's data pipeline: the WAV reader, the
// polyphase resampler, the batch_by_size packer and the monotonic DTW.
//
// The port's own copy of the JAX package's native/avsr_io.cpp (the same
// functions, the same arithmetic), exposed over a C ABI and loaded from
// Python with ctypes by mocov2_whisper_flamingo_torch/datamodule/native.py,
// which builds it with
//   g++ -O3 -fPIC -shared -std=c++17 -o libavsr_io.so avsr_io.cpp
//
// All functions return negative values on error.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

struct WavInfo {
  int sample_rate = 0;
  int channels = 0;
  int bits = 0;
  int format = 0;  // 1 = PCM, 3 = IEEE float
  long data_offset = 0;
  long data_bytes = 0;
};

// Minimal RIFF/WAVE parser: walks chunks to find fmt + data.
bool parse_wav(FILE* f, WavInfo* info) {
  unsigned char hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return false;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0) return false;
  unsigned char chunk[8];
  while (fread(chunk, 1, 8, f) == 8) {
    uint32_t size = chunk[4] | chunk[5] << 8 | chunk[6] << 16 | (uint32_t)chunk[7] << 24;
    if (memcmp(chunk, "fmt ", 4) == 0) {
      std::vector<unsigned char> fmt(size);
      if (fread(fmt.data(), 1, size, f) != size) return false;
      info->format = fmt[0] | fmt[1] << 8;
      info->channels = fmt[2] | fmt[3] << 8;
      info->sample_rate = fmt[4] | fmt[5] << 8 | fmt[6] << 16 | (uint32_t)fmt[7] << 24;
      info->bits = fmt[14] | fmt[15] << 8;
      if (info->format == 0xFFFE && size >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        info->format = fmt[24] | fmt[25] << 8;
      }
    } else if (memcmp(chunk, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = size;
      return info->sample_rate > 0 && info->channels > 0;
    } else {
      fseek(f, (size + 1) & ~1u, SEEK_CUR);  // chunks are word-aligned
    }
  }
  return false;
}

double bessel_i0(double x) {
  // Series expansion; converges fast for the beta values we use.
  double sum = 1.0, term = 1.0;
  for (int k = 1; k < 64; ++k) {
    term *= (x / (2.0 * k)) * (x / (2.0 * k));
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

}  // namespace

extern "C" {

// Probe a wav file. Returns 0 on success.
int avsr_wav_info(const char* path, int* sample_rate, int* channels, long* frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  bool ok = parse_wav(f, &info);
  fclose(f);
  if (!ok) return -2;
  *sample_rate = info.sample_rate;
  *channels = info.channels;
  long bytes_per_frame = (long)info.channels * (info.bits / 8);
  *frames = bytes_per_frame > 0 ? info.data_bytes / bytes_per_frame : 0;
  return 0;
}

// Read + downmix to mono float32 in [-1, 1] (torchaudio normalize=True
// semantics). Returns frames written, or negative on error.
long avsr_wav_read_mono_f32(const char* path, float* out, long max_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_wav(f, &info)) { fclose(f); return -2; }
  long bytes_per_sample = info.bits / 8;
  long bytes_per_frame = info.channels * bytes_per_sample;
  long frames = info.data_bytes / bytes_per_frame;
  if (frames > max_frames) frames = max_frames;
  fseek(f, info.data_offset, SEEK_SET);

  std::vector<unsigned char> buf(frames * bytes_per_frame);
  long got = (long)fread(buf.data(), 1, buf.size(), f);
  fclose(f);
  frames = got / bytes_per_frame;

  const double inv_ch = 1.0 / info.channels;
  for (long i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < info.channels; ++c) {
      const unsigned char* p = buf.data() + (i * info.channels + c) * bytes_per_sample;
      double v = 0.0;
      if (info.format == 3 && info.bits == 32) {
        float fv;
        memcpy(&fv, p, 4);
        v = fv;
      } else if (info.bits == 16) {
        int16_t s = (int16_t)(p[0] | p[1] << 8);
        v = s / 32768.0;
      } else if (info.bits == 24) {
        int32_t s = p[0] | p[1] << 8 | p[2] << 16;
        if (s & 0x800000) s |= ~0xFFFFFF;
        v = s / 8388608.0;
      } else if (info.bits == 32 && info.format == 1) {
        int32_t s;
        memcpy(&s, p, 4);
        v = s / 2147483648.0;
      } else if (info.bits == 8) {
        v = ((int)p[0] - 128) / 128.0;
      }
      acc += v;
    }
    out[i] = (float)(acc * inv_ch);
  }
  return frames;
}

// Polyphase windowed-sinc resampler (Kaiser window), matching the quality
// class of torchaudio's Resample (reference: av_dataset.py:82-83).
// Returns output frames written, negative on error.
long avsr_resample_f32(const float* in, long n_in, int sr_in, int sr_out,
                       float* out, long max_out) {
  if (sr_in <= 0 || sr_out <= 0 || n_in < 0) return -1;
  if (sr_in == sr_out) {
    long n = n_in > max_out ? max_out : n_in;
    memcpy(out, in, n * sizeof(float));
    return n;
  }
  // Reduce the ratio.
  long g = 1;
  {
    long a = sr_in, b = sr_out;
    while (b) { long t = a % b; a = b; b = t; }
    g = a;
  }
  const long up = sr_out / g, down = sr_in / g;
  const double cutoff = 0.99 * 0.5 * (sr_in < sr_out ? 1.0 : (double)sr_out / sr_in);
  const int zeros = 24;                      // sinc half-width (in input samples)
  const double beta = 14.769656459379492;    // Kaiser beta for ~140 dB
  const long taps_per_phase = 2 * zeros + 1;

  // Precompute polyphase filter bank: phase p, tap k.
  std::vector<double> filt((size_t)up * taps_per_phase);
  const double i0_beta = bessel_i0(beta);
  for (long p = 0; p < up; ++p) {
    for (long k = 0; k < taps_per_phase; ++k) {
      // time of tap relative to output sample, in input-sample units
      double t = (k - zeros) - (double)p / up;
      double x = 2.0 * cutoff * t;
      double sinc = (x == 0.0) ? 1.0 : sin(kPi * x) / (kPi * x);
      double w_arg = t / zeros;
      double window = 0.0;
      if (w_arg > -1.0 && w_arg < 1.0)
        window = bessel_i0(beta * sqrt(1.0 - w_arg * w_arg)) / i0_beta;
      filt[(size_t)p * taps_per_phase + k] = 2.0 * cutoff * sinc * window;
    }
  }

  long n_out = (n_in * up + down - 1) / down;
  if (n_out > max_out) n_out = max_out;
  for (long j = 0; j < n_out; ++j) {
    // output sample j corresponds to input position j*down/up
    long num = j * down;
    long i_center = num / up;
    long phase = num % up;
    const double* h = &filt[(size_t)phase * taps_per_phase];
    double acc = 0.0;
    for (long k = 0; k < taps_per_phase; ++k) {
      long idx = i_center + k - zeros;
      if (idx < 0 || idx >= n_in) continue;
      acc += h[k] * in[idx];
    }
    out[j] = (float)acc;
  }
  return n_out;
}

// fairseq-style batch_by_size: greedy packing of (pre-ordered) indices so
// that len(batch) * max(size in batch) <= max_tokens, with each index alone
// always forming a valid batch. Mirrors the semantics the reference's
// bucketing sampler relies on (reference: data_module.py:37,57-61).
//
// out_flat receives all indices in order; out_offsets receives batch start
// offsets (out_offsets[0] = 0, ..., out_offsets[n_batches] = n).
// Returns number of batches, negative on error.
long avsr_batch_by_size(const int64_t* indices, const int64_t* sizes, long n,
                        long max_tokens, int64_t* out_flat, int64_t* out_offsets) {
  if (n < 0 || max_tokens <= 0) return -1;
  long n_batches = 0;
  long batch_start = 0;
  long batch_max = 0;
  out_offsets[0] = 0;
  for (long i = 0; i < n; ++i) {
    out_flat[i] = indices[i];
    long sz = sizes[indices[i]];
    long new_max = sz > batch_max ? sz : batch_max;
    long batch_len = i - batch_start + 1;
    if (batch_len > 1 && batch_len * new_max > max_tokens) {
      // flush previous batch, start new one at i
      out_offsets[++n_batches] = i;
      batch_start = i;
      batch_max = sz;
    } else {
      batch_max = new_max;
    }
  }
  if (n > 0) out_offsets[++n_batches] = n;
  return n_batches;
}

// Monotonic DTW over an [n, m] cost matrix (decode/timestamps.py): moves
// are (i-1,j-1), (i-1,j), (i,j-1); backtrace prefers the diagonal; the
// path runs (0,0)..(n-1,m-1). The alignment DP is inherently sequential
// (each cell depends on its left neighbor), so it belongs here, not on the
// MXU; at Whisper scale (448 x 1500) this runs ~100x faster than the
// pure-Python loop. Writes the forward-ordered path into out_text/out_time
// (capacity >= n + m); returns path length, negative on error.
long avsr_dtw(const double* cost, long n, long m,
              int64_t* out_text, int64_t* out_time) {
  if (n <= 0 || m <= 0) return -1;
  const double inf = std::numeric_limits<double>::infinity();
  std::vector<double> acc((size_t)(n + 1) * (m + 1), inf);
  std::vector<signed char> trace((size_t)(n + 1) * (m + 1), 0);
  acc[0] = 0.0;
  for (long i = 1; i <= n; ++i) {
    const double* row_prev = &acc[(size_t)(i - 1) * (m + 1)];
    double* row = &acc[(size_t)i * (m + 1)];
    signed char* tr = &trace[(size_t)i * (m + 1)];
    const double* c = &cost[(size_t)(i - 1) * m];
    for (long j = 1; j <= m; ++j) {
      double best = row_prev[j - 1];  // diagonal
      signed char t = 0;
      if (row_prev[j] < best) { best = row_prev[j]; t = 1; }  // up
      if (row[j - 1] < best) { best = row[j - 1]; t = 2; }    // left
      row[j] = c[j - 1] + best;
      tr[j] = t;
    }
  }
  long i = n, j = m, len = 0;
  while (i > 0 || j > 0) {
    out_text[len] = i - 1;
    out_time[len] = j - 1;
    ++len;
    signed char t = trace[(size_t)i * (m + 1) + j];
    if (i > 0 && j > 0 && t == 0) { --i; --j; }
    else if (i > 0 && (j == 0 || t == 1)) { --i; }
    else { --j; }
  }
  // reverse in place to forward order
  for (long a = 0, b = len - 1; a < b; ++a, --b) {
    int64_t tt = out_text[a]; out_text[a] = out_text[b]; out_text[b] = tt;
    int64_t tm = out_time[a]; out_time[a] = out_time[b]; out_time[b] = tm;
  }
  return len;
}

}  // extern "C"
