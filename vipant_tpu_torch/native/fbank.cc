// vipant_tpu native audio frontend: WAV decode + Kaldi-compatible log-mel
// fbank on the host. This is the C++ replacement for the torchaudio C++
// kernels the reference data pipeline leaned on
// (/root/reference/cvap/data/audio/transform.py:16-35): RIFF/WAVE parsing,
// snip-edges framing, DC removal, pre-emphasis, windowing, a radix-2
// iterative FFT, triangular mel filters on the 1127*ln(1+f/700) scale, and
// a log floor at FLT_EPSILON. Numerics match vipant_tpu/ops/fbank_np.py
// (the golden); see tests/test_native.py.
//
// C ABI, thread-safe (no mutable globals): built as libvipant_audio.so and
// bound via ctypes from vipant_tpu/native/__init__.py.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// ---------------------------------------------------------------------------
// iterative radix-2 complex FFT (size = power of two), float with
// double-precision precomputed twiddles and a bit-reversal table.
// ---------------------------------------------------------------------------
struct FftPlan {
  int n;
  std::vector<int> rev;
  std::vector<float> tw_r, tw_i;  // per stage, concatenated half-len twiddles

  explicit FftPlan(int n_) : n(n_), rev(n_) {
    for (int i = 1, j = 0; i < n; ++i) {
      int bit = n >> 1;
      for (; j & bit; bit >>= 1) j ^= bit;
      j ^= bit;
      rev[i] = j;
    }
    for (int len = 2; len <= n; len <<= 1) {
      const double ang = -2.0 * kPi / len;
      for (int k = 0; k < len / 2; ++k) {
        tw_r.push_back(static_cast<float>(std::cos(ang * k)));
        tw_i.push_back(static_cast<float>(std::sin(ang * k)));
      }
    }
  }
};

void fft_inplace(const FftPlan& plan, std::vector<float>& re,
                 std::vector<float>& im) {
  const int n = plan.n;
  for (int i = 1; i < n; ++i) {
    const int j = plan.rev[i];
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  size_t tw = 0;
  for (int len = 2; len <= n; len <<= 1) {
    const float* wr = &plan.tw_r[tw];
    const float* wi = &plan.tw_i[tw];
    for (int i = 0; i < n; i += len) {
      for (int k = 0; k < len / 2; ++k) {
        const int a = i + k, b = i + k + len / 2;
        const float vr = re[b] * wr[k] - im[b] * wi[k];
        const float vi = re[b] * wi[k] + im[b] * wr[k];
        const float ur = re[a], ui = im[a];
        re[a] = ur + vr;
        im[a] = ui + vi;
        re[b] = ur - vr;
        im[b] = ui - vi;
      }
    }
    tw += len / 2;
  }
}

// ---------------------------------------------------------------------------
// mel filterbank (Kaldi semantics; matches vipant_tpu/ops/mel.py)
// ---------------------------------------------------------------------------
double mel_scale(double f) { return 1127.0 * std::log1p(f / 700.0); }

// Sparse triangular filters: per bin, the contiguous nonzero fft-bin range.
struct MelBanks {
  std::vector<float> weights;  // concatenated per-bin weights
  std::vector<int> start;      // first fft bin per mel bin
  std::vector<int> offset;     // offset into weights per mel bin
  std::vector<int> length;     // range length per mel bin
};

MelBanks mel_banks(int num_bins, int padded, double sr, double low_freq,
                   double high_freq) {
  const int nfft = padded / 2;
  const double nyquist = 0.5 * sr;
  if (high_freq <= 0.0) high_freq += nyquist;
  const double bin_width = sr / padded;
  const double mel_low = mel_scale(low_freq);
  const double mel_high = mel_scale(high_freq);
  const double delta = (mel_high - mel_low) / (num_bins + 1);

  MelBanks out;
  out.start.resize(num_bins);
  out.offset.resize(num_bins);
  out.length.resize(num_bins);
  for (int b = 0; b < num_bins; ++b) {
    const double left = mel_low + b * delta;
    const double center = left + delta;
    const double right = center + delta;
    int first = -1, last = -1;
    std::vector<float> w;
    for (int k = 0; k < nfft; ++k) {
      const double mel = mel_scale(bin_width * k);
      const double up = (mel - left) / (center - left);
      const double down = (right - mel) / (right - center);
      const double v = std::min(up, down);
      if (v > 0.0) {
        if (first < 0) first = k;
        last = k;
      }
    }
    out.start[b] = first < 0 ? 0 : first;
    out.offset[b] = static_cast<int>(out.weights.size());
    if (first >= 0) {
      for (int k = first; k <= last; ++k) {
        const double mel = mel_scale(bin_width * k);
        const double up = (mel - left) / (center - left);
        const double down = (right - mel) / (right - center);
        out.weights.push_back(static_cast<float>(std::min(up, down)));
      }
      out.length[b] = last - first + 1;
    } else {
      out.length[b] = 0;
    }
  }
  return out;
}

std::vector<double> feature_window(int size, int window_type) {
  std::vector<double> w(size);
  const double a = 2.0 * kPi / (size - 1);
  for (int i = 0; i < size; ++i) {
    switch (window_type) {
      case 0:  // hanning
        w[i] = 0.5 - 0.5 * std::cos(a * i);
        break;
      case 1:  // hamming
        w[i] = 0.54 - 0.46 * std::cos(a * i);
        break;
      case 2:  // povey
        w[i] = std::pow(0.5 - 0.5 * std::cos(a * i), 0.85);
        break;
      case 3:  // rectangular
        w[i] = 1.0;
        break;
      default:
        w[i] = 0.5 - 0.5 * std::cos(a * i);
    }
  }
  return w;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// WAV decode (PCM 8/16/24/32 + IEEE float 32/64)
// ---------------------------------------------------------------------------

// Returns 0 on success. Fills *n_samples (per channel), *sample_rate,
// *channels without reading payload.
int vt_wav_info(const char* path, int64_t* n_samples, int* sample_rate,
                int* channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  unsigned char hdr[12];
  if (std::fread(hdr, 1, 12, f) != 12 || std::memcmp(hdr, "RIFF", 4) != 0 ||
      std::memcmp(hdr + 8, "WAVE", 4) != 0) {
    std::fclose(f);
    return -2;
  }
  int fmt_code = 0, ch = 0, sr = 0, bits = 0;
  int64_t data_size = -1;
  unsigned char chdr[8];
  while (std::fread(chdr, 1, 8, f) == 8) {
    const uint32_t size = chdr[4] | (chdr[5] << 8) | (chdr[6] << 16) |
                          (static_cast<uint32_t>(chdr[7]) << 24);
    if (std::memcmp(chdr, "fmt ", 4) == 0) {
      unsigned char body[26];
      const size_t want = size >= 26 ? 26 : 16;
      if (std::fread(body, 1, want, f) != want) break;
      fmt_code = body[0] | (body[1] << 8);
      ch = body[2] | (body[3] << 8);
      sr = body[4] | (body[5] << 8) | (body[6] << 16) | (body[7] << 24);
      bits = body[14] | (body[15] << 8);
      if (fmt_code == 0xFFFE && want == 26) {  // EXTENSIBLE: SubFormat GUID
        fmt_code = body[24] | (body[25] << 8);
      }
      std::fseek(f, static_cast<long>(size - want + (size & 1)), SEEK_CUR);
    } else if (std::memcmp(chdr, "data", 4) == 0) {
      data_size = size;
      break;
    } else {
      std::fseek(f, static_cast<long>(size + (size & 1)), SEEK_CUR);
    }
  }
  std::fclose(f);
  if (data_size < 0 || ch <= 0 || bits <= 0) return -3;
  (void)fmt_code;
  *n_samples = data_size / (ch * (bits / 8));
  *sample_rate = sr;
  *channels = ch;
  return 0;
}

// out: [channels * n_samples] interleaved-deinterleaved as [ch][sample].
int vt_wav_read(const char* path, float* out, int64_t max_per_channel) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  unsigned char hdr[12];
  if (std::fread(hdr, 1, 12, f) != 12) {
    std::fclose(f);
    return -2;
  }
  int fmt_code = 0, ch = 0, bits = 0;
  unsigned char chdr[8];
  while (std::fread(chdr, 1, 8, f) == 8) {
    const uint32_t size = chdr[4] | (chdr[5] << 8) | (chdr[6] << 16) |
                          (static_cast<uint32_t>(chdr[7]) << 24);
    if (std::memcmp(chdr, "fmt ", 4) == 0) {
      unsigned char body[26];
      const size_t want = size >= 26 ? 26 : 16;
      if (std::fread(body, 1, want, f) != want) break;
      fmt_code = body[0] | (body[1] << 8);
      ch = body[2] | (body[3] << 8);
      bits = body[14] | (body[15] << 8);
      if (fmt_code == 0xFFFE && want == 26) {  // EXTENSIBLE: SubFormat GUID
        fmt_code = body[24] | (body[25] << 8);
      }
      std::fseek(f, static_cast<long>(size - want + (size & 1)), SEEK_CUR);
    } else if (std::memcmp(chdr, "data", 4) == 0) {
      if (ch <= 0) break;
      const int bytes = bits / 8;
      const int64_t frames =
          std::min<int64_t>(size / (ch * bytes), max_per_channel);
      std::vector<unsigned char> buf(static_cast<size_t>(frames) * ch * bytes);
      if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) break;
      for (int64_t i = 0; i < frames; ++i) {
        for (int c = 0; c < ch; ++c) {
          const unsigned char* p = &buf[(i * ch + c) * bytes];
          float v = 0.0f;
          if (fmt_code == 3) {  // IEEE float
            if (bits == 32) {
              float tmp;
              std::memcpy(&tmp, p, 4);
              v = tmp;
            } else {
              double tmp;
              std::memcpy(&tmp, p, 8);
              v = static_cast<float>(tmp);
            }
          } else if (bits == 16) {
            int16_t s = p[0] | (p[1] << 8);
            v = s / 32768.0f;
          } else if (bits == 8) {
            v = (p[0] - 128) / 128.0f;
          } else if (bits == 24) {
            int32_t s = p[0] | (p[1] << 8) | (p[2] << 16);
            s = (s ^ 0x800000) - 0x800000;
            v = s / 8388608.0f;
          } else if (bits == 32) {
            int32_t s;
            std::memcpy(&s, p, 4);
            v = s / 2147483648.0f;
          }
          out[c * frames + i] = v;
        }
      }
      std::fclose(f);
      return static_cast<int>(frames);
    } else {
      std::fseek(f, static_cast<long>(size + (size & 1)), SEEK_CUR);
    }
  }
  std::fclose(f);
  return -3;
}

// ---------------------------------------------------------------------------
// fbank
// ---------------------------------------------------------------------------

// wav: [n] float; out: [max_frames * num_bins]; returns frame count (or <0).
int vt_fbank(const float* wav, int64_t n, int sample_rate, int num_bins,
             double frame_length_ms, double frame_shift_ms, int window_type,
             double preemph, int remove_dc, double low_freq, double high_freq,
             float* out, int64_t max_frames) {
  const int size = static_cast<int>(sample_rate * frame_length_ms * 0.001);
  const int shift = static_cast<int>(sample_rate * frame_shift_ms * 0.001);
  if (n < size) return 0;
  const int64_t m = std::min<int64_t>(1 + (n - size) / shift, max_frames);
  const int padded = next_pow2(size);
  const int nfft = padded / 2;

  const std::vector<double> window = feature_window(size, window_type);
  const MelBanks banks =
      mel_banks(num_bins, padded, sample_rate, low_freq, high_freq);
  const FftPlan plan(padded);

  std::vector<float> re(padded), im(padded);
  std::vector<float> power(nfft + 1);
  std::vector<float> frame(size);
  for (int64_t t = 0; t < m; ++t) {
    const float* src = wav + t * shift;
    // frame in float32 (working precision of the golden)
    for (int i = 0; i < size; ++i) frame[i] = src[i];
    if (remove_dc) {
      float mean = 0.0f;
      for (int i = 0; i < size; ++i) mean += frame[i];
      mean /= size;
      for (int i = 0; i < size; ++i) frame[i] -= mean;
    }
    if (preemph != 0.0) {
      for (int i = size - 1; i > 0; --i)
        frame[i] = frame[i] - static_cast<float>(preemph) * frame[i - 1];
      frame[0] = frame[0] - static_cast<float>(preemph) * frame[0];
    }
    for (int i = 0; i < size; ++i) {
      re[i] = static_cast<float>(frame[i] * window[i]);
      im[i] = 0.0f;
    }
    for (int i = size; i < padded; ++i) {
      re[i] = 0.0f;
      im[i] = 0.0f;
    }
    fft_inplace(plan, re, im);
    for (int k = 0; k <= nfft; ++k) {
      power[k] = re[k] * re[k] + im[k] * im[k];
    }
    float* dst = out + t * num_bins;
    for (int b = 0; b < num_bins; ++b) {
      float acc = 0.0f;
      // data()+offset, not &weights[offset]: an empty triangle's offset is
      // one-past-the-end, and operator[] there is UB under debug STL
      const float* w = banks.weights.data() + banks.offset[b];
      const float* p = &power[banks.start[b]];
      const int len = banks.length[b];
      for (int k = 0; k < len; ++k) acc += p[k] * w[k];
      dst[b] = std::log(std::max(acc, FLT_EPSILON));
    }
  }
  return static_cast<int>(m);
}

}  // extern "C"
