// avd_native — C++ host runtime of avd_tpu_torch, the PyTorch/CUDA port.
//
// The port's own copy of avd_tpu/native/src/avd_native.cc: everything
// below this header is that file byte for byte.  The GPU owns the flow
// math; this library owns the hot host-side byte work that would
// otherwise run as per-frame numpy:
//
//   * batched BGR→grayscale with OpenCV's exact fixed-point arithmetic
//     (threaded across frames — feeds device prep, which ships gray
//     only; see avd_tpu_torch/ops/video_features.py)
//   * the fused host-prep sweeps (Laplacian variance, 32×32 area bins,
//     320×320 bilinear; avd_tpu_torch/ops/host_prep.py)
//   * RIFF/WAV parsing (s16/u8/s32/f32 → float32 mono)
//   * windowed-sinc rational resampling to the 16 kHz analysis rate
//     (role of the reference's `ffmpeg -ac 1 -ar 16000`, audio.py:10)
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
// Build: avd_tpu_torch/native/_build.py (g++ at first use).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__SSSE3__)
#include <immintrin.h>
#define AVD_HAVE_SSSE3 1
#endif

// AVX-512VBMI gray path: compiled via target attribute (works without
// -march flags on gcc ≥ 6), dispatched at runtime with
// __builtin_cpu_supports. x86-64 gcc/clang only.
#if defined(__x86_64__) && defined(__GNUC__)
#include <immintrin.h>
#define AVD_HAVE_AVX512_TARGET 1
#endif

extern "C" {

// ---------------------------------------------------------------------------
// BGR -> gray, cv2 fixed-point semantics: (R*9798 + G*19235 + B*3735 +
// 16384) >> 15  (verified bit-exact against cv2 5.0).
// ---------------------------------------------------------------------------
static void gray_span_scalar(const uint8_t* bgr, uint8_t* gray,
                             int64_t begin, int64_t end) {
  for (int64_t i = begin; i < end; ++i) {
    const uint8_t* p = bgr + i * 3;
    const uint32_t acc = 3735u * p[0] + 19235u * p[1] + 9798u * p[2] + 16384u;
    gray[i] = static_cast<uint8_t>(acc >> 15);
  }
}

#ifdef AVD_HAVE_SSSE3
// 16 pixels per iteration: deinterleave 48 BGR bytes with pshufb, then
// fixed-point weighted sum via pmaddwd pairs:
//   (B,G) · (3735, 19235)  +  (R,1) · (9798, 16384)   >> 15
// Exactly matches the scalar/cv2 arithmetic.
static void gray_span_simd(const uint8_t* bgr, uint8_t* gray, int64_t begin,
                           int64_t end) {
  int64_t i = begin;
  const __m128i mB0 = _mm_setr_epi8(0, 3, 6, 9, 12, 15, -1, -1, -1, -1, -1,
                                    -1, -1, -1, -1, -1);
  const __m128i mB1 = _mm_setr_epi8(-1, -1, -1, -1, -1, -1, 2, 5, 8, 11, 14,
                                    -1, -1, -1, -1, -1);
  const __m128i mB2 = _mm_setr_epi8(-1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
                                    -1, 1, 4, 7, 10, 13);
  const __m128i mG0 = _mm_setr_epi8(1, 4, 7, 10, 13, -1, -1, -1, -1, -1, -1,
                                    -1, -1, -1, -1, -1);
  const __m128i mG1 = _mm_setr_epi8(-1, -1, -1, -1, -1, 0, 3, 6, 9, 12, 15,
                                    -1, -1, -1, -1, -1);
  const __m128i mG2 = _mm_setr_epi8(-1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
                                    -1, 2, 5, 8, 11, 14);
  const __m128i mR0 = _mm_setr_epi8(2, 5, 8, 11, 14, -1, -1, -1, -1, -1, -1,
                                    -1, -1, -1, -1, -1);
  const __m128i mR1 = _mm_setr_epi8(-1, -1, -1, -1, -1, 1, 4, 7, 10, 13, -1,
                                    -1, -1, -1, -1, -1);
  const __m128i mR2 = _mm_setr_epi8(-1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
                                    0, 3, 6, 9, 12, 15);
  const __m128i zero = _mm_setzero_si128();
  const __m128i coefBG = _mm_set1_epi32((19235 << 16) | 3735);
  const __m128i coefR1 = _mm_set1_epi32((16384 << 16) | 9798);
  const __m128i one16 = _mm_set1_epi16(1);

  for (; i + 16 <= end; i += 16) {
    const uint8_t* p = bgr + i * 3;
    const __m128i s0 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p));
    const __m128i s1 =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + 16));
    const __m128i s2 =
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(p + 32));

    const __m128i B = _mm_or_si128(
        _mm_or_si128(_mm_shuffle_epi8(s0, mB0), _mm_shuffle_epi8(s1, mB1)),
        _mm_shuffle_epi8(s2, mB2));
    const __m128i G = _mm_or_si128(
        _mm_or_si128(_mm_shuffle_epi8(s0, mG0), _mm_shuffle_epi8(s1, mG1)),
        _mm_shuffle_epi8(s2, mG2));
    const __m128i R = _mm_or_si128(
        _mm_or_si128(_mm_shuffle_epi8(s0, mR0), _mm_shuffle_epi8(s1, mR1)),
        _mm_shuffle_epi8(s2, mR2));

    // widen to 16-bit
    const __m128i Blo = _mm_unpacklo_epi8(B, zero);
    const __m128i Bhi = _mm_unpackhi_epi8(B, zero);
    const __m128i Glo = _mm_unpacklo_epi8(G, zero);
    const __m128i Ghi = _mm_unpackhi_epi8(G, zero);
    const __m128i Rlo = _mm_unpacklo_epi8(R, zero);
    const __m128i Rhi = _mm_unpackhi_epi8(R, zero);

    // interleave (B,G) and (R,1) into 16-bit pairs, madd with coeff pairs
    const __m128i bg0 = _mm_unpacklo_epi16(Blo, Glo);
    const __m128i bg1 = _mm_unpackhi_epi16(Blo, Glo);
    const __m128i bg2 = _mm_unpacklo_epi16(Bhi, Ghi);
    const __m128i bg3 = _mm_unpackhi_epi16(Bhi, Ghi);
    const __m128i r0 = _mm_unpacklo_epi16(Rlo, one16);
    const __m128i r1 = _mm_unpackhi_epi16(Rlo, one16);
    const __m128i r2 = _mm_unpacklo_epi16(Rhi, one16);
    const __m128i r3 = _mm_unpackhi_epi16(Rhi, one16);

    __m128i a0 = _mm_add_epi32(_mm_madd_epi16(bg0, coefBG),
                               _mm_madd_epi16(r0, coefR1));
    __m128i a1 = _mm_add_epi32(_mm_madd_epi16(bg1, coefBG),
                               _mm_madd_epi16(r1, coefR1));
    __m128i a2 = _mm_add_epi32(_mm_madd_epi16(bg2, coefBG),
                               _mm_madd_epi16(r2, coefR1));
    __m128i a3 = _mm_add_epi32(_mm_madd_epi16(bg3, coefBG),
                               _mm_madd_epi16(r3, coefR1));
    a0 = _mm_srli_epi32(a0, 15);
    a1 = _mm_srli_epi32(a1, 15);
    a2 = _mm_srli_epi32(a2, 15);
    a3 = _mm_srli_epi32(a3, 15);

    const __m128i p16lo = _mm_packs_epi32(a0, a1);
    const __m128i p16hi = _mm_packs_epi32(a2, a3);
    const __m128i out = _mm_packus_epi16(p16lo, p16hi);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(gray + i), out);
  }
  gray_span_scalar(bgr, gray, i, end);
}
#endif

#ifdef AVD_HAVE_AVX512_TARGET
// 64 pixels per iteration. The three 64-byte loads cover 64 BGR triplets;
// vpermi2b picks channel bytes out of s0‖s1 (indices 0..127) and a masked
// vpermb overwrites the lanes whose source byte lives in s2 (global index
// ≥ 128 → s2 index = idx & 63). Arithmetic is the same fixed-point
// (B,G)·(3735,19235) + (R,1)·(9798,16384) >> 15 pipeline as the SSSE3
// path — bit-exact vs cv2/scalar. unpack/madd/pack all act per 128-bit
// lane, and each lane holds 16 consecutive pixels, so byte order is
// preserved end to end.
__attribute__((target("avx512f,avx512bw,avx512vbmi")))
static void gray_span_avx512(const uint8_t* bgr, uint8_t* gray,
                             int64_t begin, int64_t end) {
  int64_t i = begin;
  alignas(64) uint8_t idxB[64], idxG[64], idxR[64];
  for (int j = 0; j < 64; ++j) {
    idxB[j] = static_cast<uint8_t>(3 * j + 0);
    idxG[j] = static_cast<uint8_t>(3 * j + 1);
    idxR[j] = static_cast<uint8_t>(3 * j + 2);
  }
  const __m512i iB = _mm512_load_si512(idxB);
  const __m512i iG = _mm512_load_si512(idxG);
  const __m512i iR = _mm512_load_si512(idxR);
  // lanes whose global byte index lands in s2 (3j+c >= 128)
  const __mmask64 mB = ~((__mmask64(1) << 43) - 1);  // j >= 43
  const __mmask64 mG = ~((__mmask64(1) << 43) - 1);  // j >= 43
  const __mmask64 mR = ~((__mmask64(1) << 42) - 1);  // j >= 42
  const __m512i zero = _mm512_setzero_si512();
  const __m512i coefBG = _mm512_set1_epi32((19235 << 16) | 3735);
  const __m512i coefR1 = _mm512_set1_epi32((16384 << 16) | 9798);
  const __m512i one16 = _mm512_set1_epi16(1);

  for (; i + 64 <= end; i += 64) {
    const uint8_t* p = bgr + i * 3;
    const __m512i s0 = _mm512_loadu_si512(p);
    const __m512i s1 = _mm512_loadu_si512(p + 64);
    const __m512i s2 = _mm512_loadu_si512(p + 128);

    __m512i B = _mm512_permutex2var_epi8(s0, iB, s1);
    B = _mm512_mask_permutexvar_epi8(B, mB, iB, s2);
    __m512i G = _mm512_permutex2var_epi8(s0, iG, s1);
    G = _mm512_mask_permutexvar_epi8(G, mG, iG, s2);
    __m512i R = _mm512_permutex2var_epi8(s0, iR, s1);
    R = _mm512_mask_permutexvar_epi8(R, mR, iR, s2);

    const __m512i Blo = _mm512_unpacklo_epi8(B, zero);
    const __m512i Bhi = _mm512_unpackhi_epi8(B, zero);
    const __m512i Glo = _mm512_unpacklo_epi8(G, zero);
    const __m512i Ghi = _mm512_unpackhi_epi8(G, zero);
    const __m512i Rlo = _mm512_unpacklo_epi8(R, zero);
    const __m512i Rhi = _mm512_unpackhi_epi8(R, zero);

    const __m512i bg0 = _mm512_unpacklo_epi16(Blo, Glo);
    const __m512i bg1 = _mm512_unpackhi_epi16(Blo, Glo);
    const __m512i bg2 = _mm512_unpacklo_epi16(Bhi, Ghi);
    const __m512i bg3 = _mm512_unpackhi_epi16(Bhi, Ghi);
    const __m512i r0 = _mm512_unpacklo_epi16(Rlo, one16);
    const __m512i r1 = _mm512_unpackhi_epi16(Rlo, one16);
    const __m512i r2 = _mm512_unpacklo_epi16(Rhi, one16);
    const __m512i r3 = _mm512_unpackhi_epi16(Rhi, one16);

    __m512i a0 = _mm512_add_epi32(_mm512_madd_epi16(bg0, coefBG),
                                  _mm512_madd_epi16(r0, coefR1));
    __m512i a1 = _mm512_add_epi32(_mm512_madd_epi16(bg1, coefBG),
                                  _mm512_madd_epi16(r1, coefR1));
    __m512i a2 = _mm512_add_epi32(_mm512_madd_epi16(bg2, coefBG),
                                  _mm512_madd_epi16(r2, coefR1));
    __m512i a3 = _mm512_add_epi32(_mm512_madd_epi16(bg3, coefBG),
                                  _mm512_madd_epi16(r3, coefR1));
    a0 = _mm512_srli_epi32(a0, 15);
    a1 = _mm512_srli_epi32(a1, 15);
    a2 = _mm512_srli_epi32(a2, 15);
    a3 = _mm512_srli_epi32(a3, 15);

    const __m512i p16lo = _mm512_packs_epi32(a0, a1);
    const __m512i p16hi = _mm512_packs_epi32(a2, a3);
    const __m512i out = _mm512_packus_epi16(p16lo, p16hi);
    _mm512_storeu_si512(gray + i, out);
  }
#ifdef AVD_HAVE_SSSE3
  gray_span_simd(bgr, gray, i, end);
#else
  gray_span_scalar(bgr, gray, i, end);
#endif
}

static bool cpu_has_avx512vbmi() {
  static const bool ok = __builtin_cpu_supports("avx512f") &&
                         __builtin_cpu_supports("avx512bw") &&
                         __builtin_cpu_supports("avx512vbmi");
  return ok;
}
#endif  // AVD_HAVE_AVX512_TARGET

static void gray_span(const uint8_t* bgr, uint8_t* gray, int64_t begin,
                      int64_t end) {
#ifdef AVD_HAVE_AVX512_TARGET
  if (cpu_has_avx512vbmi()) {
    gray_span_avx512(bgr, gray, begin, end);
    return;
  }
#endif
#ifdef AVD_HAVE_SSSE3
  gray_span_simd(bgr, gray, begin, end);
#else
  gray_span_scalar(bgr, gray, begin, end);
#endif
}

void avd_bgr_to_gray_u8(const uint8_t* bgr, uint8_t* gray, int64_t n_pixels,
                        int n_threads) {
  if (n_threads <= 1 || n_pixels < (1 << 16)) {
    gray_span(bgr, gray, 0, n_pixels);
    return;
  }
  const int nt = std::min<int64_t>(n_threads, 64);
  std::vector<std::thread> workers;
  workers.reserve(nt);
  const int64_t step = (n_pixels + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    const int64_t b = t * step;
    const int64_t e = std::min<int64_t>(b + step, n_pixels);
    if (b >= e) break;
    workers.emplace_back(gray_span, bgr, gray, b, e);
  }
  for (auto& w : workers) w.join();
}

// ---------------------------------------------------------------------------
// WAV parsing.
// ---------------------------------------------------------------------------
struct WavInfo {
  int32_t sample_rate;
  int32_t channels;
  int32_t bits;
  int32_t format;     // 1 = PCM, 3 = IEEE float
  int64_t n_frames;
  int64_t data_offset;
};

static uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

// Returns 0 on success, negative error code otherwise.
int avd_wav_info(const uint8_t* data, int64_t len, WavInfo* out) {
  if (len < 44 || std::memcmp(data, "RIFF", 4) != 0 ||
      std::memcmp(data + 8, "WAVE", 4) != 0)
    return -1;
  int64_t pos = 12;
  bool have_fmt = false;
  std::memset(out, 0, sizeof(WavInfo));
  while (pos + 8 <= len) {
    const uint32_t chunk_len = rd_u32(data + pos + 4);
    if (std::memcmp(data + pos, "fmt ", 4) == 0 && pos + 8 + 16 <= len) {
      const uint8_t* f = data + pos + 8;
      out->format = rd_u16(f);
      // WAVE_FORMAT_EXTENSIBLE: the sub-format u16 lives at fmt+24; bound
      // it against the actual buffer, not the header-declared chunk_len
      // (a truncated upload can declare 40 while the file ends earlier).
      if (out->format == 0xFFFE && chunk_len >= 40 && pos + 8 + 26 <= len)
        out->format = rd_u16(f + 24);
      out->channels = rd_u16(f + 2);
      out->sample_rate = static_cast<int32_t>(rd_u32(f + 4));
      out->bits = rd_u16(f + 14);
      have_fmt = true;
    } else if (std::memcmp(data + pos, "data", 4) == 0) {
      out->data_offset = pos + 8;
      const int64_t avail = std::min<int64_t>(chunk_len, len - out->data_offset);
      if (have_fmt && out->channels > 0 && out->bits >= 8)
        out->n_frames = avail / (out->channels * (out->bits / 8));
      return have_fmt ? 0 : -2;
    }
    pos += 8 + chunk_len + (chunk_len & 1);
  }
  return -3;
}

// Decode to float32, downmixing channels by averaging (role of
// `ffmpeg -ac 1`).  `out` must hold n_frames floats.  Returns 0 or error.
int avd_wav_decode_mono(const uint8_t* data, int64_t len, float* out) {
  WavInfo info;
  const int rc = avd_wav_info(data, len, &info);
  if (rc != 0) return rc;
  const uint8_t* s = data + info.data_offset;
  const int ch = info.channels;
  const double inv_ch = 1.0 / ch;
  for (int64_t i = 0; i < info.n_frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < ch; ++c) {
      const int64_t idx = (i * ch + c);
      switch (info.bits) {
        case 8:
          acc += (static_cast<int>(s[idx]) - 128) / 128.0;
          break;
        case 16: {
          int16_t v;
          std::memcpy(&v, s + idx * 2, 2);
          acc += v / 32768.0;
          break;
        }
        case 32: {
          if (info.format == 3) {
            float v;
            std::memcpy(&v, s + idx * 4, 4);
            acc += v;
          } else {
            int32_t v;
            std::memcpy(&v, s + idx * 4, 4);
            acc += v / 2147483648.0;
          }
          break;
        }
        case 24: {
          const uint8_t* b = s + idx * 3;
          int32_t v = (b[0] << 8) | (b[1] << 16) |
                      (static_cast<int32_t>(static_cast<int8_t>(b[2])) << 24);
          acc += v / 2147483648.0;
          break;
        }
        default:
          return -4;
      }
    }
    out[i] = static_cast<float>(acc * inv_ch);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Rational resampler: windowed-sinc polyphase, Hann window, 16 taps per
// phase per side.  out must hold ceil(n_in * up / down) floats.
// ---------------------------------------------------------------------------
void avd_resample(const float* in, int64_t n_in, int32_t up, int32_t down,
                  float* out, int64_t n_out) {
  if (up == down) {
    std::memcpy(out, in, sizeof(float) * std::min(n_in, n_out));
    return;
  }
  const double cutoff = 0.5 * std::min(1.0, static_cast<double>(up) / down);
  const int half_taps = 16;
  for (int64_t j = 0; j < n_out; ++j) {
    // output sample j sits at input position j * down / up
    const double pos = static_cast<double>(j) * down / up;
    const int64_t center = static_cast<int64_t>(std::floor(pos));
    double acc = 0.0, wsum = 0.0;
    for (int64_t k = center - half_taps + 1; k <= center + half_taps; ++k) {
      const double x = pos - static_cast<double>(k);
      const double sinc_arg = 2.0 * cutoff * x;
      double sinc = 1.0;
      if (std::abs(sinc_arg) > 1e-9)
        sinc = std::sin(M_PI * sinc_arg) / (M_PI * sinc_arg);
      const double win =
          0.5 + 0.5 * std::cos(M_PI * x / (half_taps + 1));
      const double w = 2.0 * cutoff * sinc * win;
      wsum += w;
      const int64_t idx = std::clamp<int64_t>(k, 0, n_in - 1);
      acc += w * (n_in > 0 ? in[idx] : 0.0);
    }
    // dividing by the per-phase tap sum keeps DC gain exactly 1
    out[j] = static_cast<float>(acc / (wsum == 0.0 ? 1.0 : wsum));
  }
}

// ---------------------------------------------------------------------------
// Fused BGR→gray + Laplacian variance, single pass over the frame.
//
// The serving hosts pair a TPU with very few CPU cores, so every byte pass
// counts: this reads the 3-channel frame once, writes gray once, and
// accumulates the Laplacian's sum/sum² in exact integer arithmetic
// (lap ∈ [-1020, 2040] ⇒ Σlap² ≤ 2M·4.2M < 2^63, so the variance is exact
// — matching cv2.Laplacian(CV_64F).var() bit-for-bit up to the final f64
// division).  Inner loops are int32-only and written for gcc -O3 -mavx2
// autovectorization (stride-3 load groups + widening multiplies).
// ---------------------------------------------------------------------------
static inline void gray_row(const uint8_t* __restrict bgr,
                            uint8_t* __restrict gray, int64_t w) {
  for (int64_t x = 0; x < w; ++x) {
    const int32_t acc = 3735 * bgr[3 * x] + 19235 * bgr[3 * x + 1] +
                        9798 * bgr[3 * x + 2] + 16384;
    gray[x] = static_cast<uint8_t>(acc >> 15);
  }
}

// Laplacian contributions of one row given its neighbor rows; returns the
// row's Σlap and Σlap² via out-params.  Accumulation is blocked int32 (a
// 128-px block keeps Σlap² ≤ 128·4.2e6 < 2^31) so the inner loop stays
// vectorizable; widening to int64 happens once per block — the totals are
// exact.
static inline void lap_row(const uint8_t* __restrict up,
                           const uint8_t* __restrict row,
                           const uint8_t* __restrict dn, int64_t w,
                           int64_t* sum, int64_t* sumsq) {
  int64_t s = 0, s2 = 0;
  // int16 arithmetic: lap ∈ [-1020, 1020] fits int16, lap² fits int32 —
  // lets AVX2 process 16 pixels per op (vpmaddwd for the squares).
  // Block bound: 1024 · 1020² < 2^31 keeps the int32 accumulators exact.
  constexpr int64_t kBlock = 1024;
  int16_t lap16[kBlock];
  int64_t x = 1;
  const int64_t interior_end = w - 1;
  while (x < interior_end) {
    const int64_t end = std::min(x + kBlock, interior_end);
    const int64_t len = end - x;
    for (int64_t i = 0; i < len; ++i) {
      const int64_t p = x + i;
      lap16[i] = static_cast<int16_t>(
          static_cast<int16_t>(up[p]) + dn[p] + row[p - 1] + row[p + 1] -
          4 * static_cast<int16_t>(row[p]));
    }
    int32_t bs = 0;
    int32_t bs2 = 0;  // ≤ 128 · 1020² < 2^31
    for (int64_t i = 0; i < len; ++i) {
      bs += lap16[i];
      bs2 += static_cast<int32_t>(lap16[i]) * lap16[i];
    }
    s += bs;
    s2 += bs2;
    x = end;
  }
  // reflect-101 edges
  {
    const int32_t lap = static_cast<int32_t>(up[0]) + dn[0] + row[1] +
                        row[1] - 4 * row[0];
    s += lap;
    s2 += static_cast<int64_t>(lap) * lap;
  }
  {
    const int32_t lap = static_cast<int32_t>(up[w - 1]) + dn[w - 1] +
                        row[w - 2] + row[w - 2] - 4 * row[w - 1];
    s += lap;
    s2 += static_cast<int64_t>(lap) * lap;
  }
  *sum += s;
  *sumsq += s2;
}

#ifdef AVD_HAVE_AVX512_TARGET
// AVX-512 lap_row: 64 interior pixels per chunk.  Σlap rides
// madd(lap, 1) and Σlap² rides madd(lap, lap); both accumulate in i32
// lanes (per-row bounds: |Σ madd-lane| ≤ (w/32)·2040 and ≤ (w/32)·2·1020²
// — exact for w ≤ 32k) and widen to i64 once per row.  Identical totals
// to the scalar/blocked path — integer arithmetic throughout.
__attribute__((target("avx512f,avx512bw")))
static void lap_row_avx512(const uint8_t* __restrict up,
                           const uint8_t* __restrict row,
                           const uint8_t* __restrict dn, int64_t w,
                           int64_t* sum, int64_t* sumsq) {
  const __m512i zero = _mm512_setzero_si512();
  const __m512i four = _mm512_set1_epi16(4);
  const __m512i one16 = _mm512_set1_epi16(1);
  __m512i acc_s = zero, acc_s2 = zero;
  const int64_t interior_end = w - 1;
  int64_t x = 1;
  while (x < interior_end) {
    const int64_t len = std::min<int64_t>(64, interior_end - x);
    const __mmask64 m =
        (len == 64) ? ~__mmask64(0) : ((__mmask64(1) << len) - 1);
    const __m512i u = _mm512_maskz_loadu_epi8(m, up + x);
    const __m512i d = _mm512_maskz_loadu_epi8(m, dn + x);
    const __m512i c = _mm512_maskz_loadu_epi8(m, row + x);
    const __m512i l = _mm512_maskz_loadu_epi8(m, row + x - 1);
    const __m512i r = _mm512_maskz_loadu_epi8(m, row + x + 1);
    // masked-off lanes are zero in every operand → lap contribution 0
    const __m512i ulo = _mm512_unpacklo_epi8(u, zero);
    const __m512i uhi = _mm512_unpackhi_epi8(u, zero);
    const __m512i dlo = _mm512_unpacklo_epi8(d, zero);
    const __m512i dhi = _mm512_unpackhi_epi8(d, zero);
    const __m512i clo = _mm512_unpacklo_epi8(c, zero);
    const __m512i chi = _mm512_unpackhi_epi8(c, zero);
    const __m512i llo = _mm512_unpacklo_epi8(l, zero);
    const __m512i lhi = _mm512_unpackhi_epi8(l, zero);
    const __m512i rlo = _mm512_unpacklo_epi8(r, zero);
    const __m512i rhi = _mm512_unpackhi_epi8(r, zero);
    const __m512i lap_lo = _mm512_sub_epi16(
        _mm512_add_epi16(_mm512_add_epi16(ulo, dlo),
                         _mm512_add_epi16(llo, rlo)),
        _mm512_mullo_epi16(four, clo));
    const __m512i lap_hi = _mm512_sub_epi16(
        _mm512_add_epi16(_mm512_add_epi16(uhi, dhi),
                         _mm512_add_epi16(lhi, rhi)),
        _mm512_mullo_epi16(four, chi));
    acc_s = _mm512_add_epi32(acc_s, _mm512_madd_epi16(lap_lo, one16));
    acc_s = _mm512_add_epi32(acc_s, _mm512_madd_epi16(lap_hi, one16));
    acc_s2 = _mm512_add_epi32(acc_s2, _mm512_madd_epi16(lap_lo, lap_lo));
    acc_s2 = _mm512_add_epi32(acc_s2, _mm512_madd_epi16(lap_hi, lap_hi));
    x += len;
  }
  // widen i32 lanes to i64 before reducing (Σlap² can exceed i32 summed)
  const __m512i s2a =
      _mm512_cvtepi32_epi64(_mm512_castsi512_si256(acc_s2));
  const __m512i s2b =
      _mm512_cvtepi32_epi64(_mm512_extracti64x4_epi64(acc_s2, 1));
  const __m512i sa = _mm512_cvtepi32_epi64(_mm512_castsi512_si256(acc_s));
  const __m512i sb =
      _mm512_cvtepi32_epi64(_mm512_extracti64x4_epi64(acc_s, 1));
  int64_t s = _mm512_reduce_add_epi64(sa) + _mm512_reduce_add_epi64(sb);
  int64_t s2 = _mm512_reduce_add_epi64(s2a) + _mm512_reduce_add_epi64(s2b);
  // reflect-101 edges (same as scalar path)
  {
    const int32_t lap = static_cast<int32_t>(up[0]) + dn[0] + row[1] +
                        row[1] - 4 * row[0];
    s += lap;
    s2 += static_cast<int64_t>(lap) * lap;
  }
  {
    const int32_t lap = static_cast<int32_t>(up[w - 1]) + dn[w - 1] +
                        row[w - 2] + row[w - 2] - 4 * row[w - 1];
    s += lap;
    s2 += static_cast<int64_t>(lap) * lap;
  }
  *sum += s;
  *sumsq += s2;
}

// Contiguous byte run-sum via SAD against zero (8-byte group sums in the
// epi64 lanes); exact integer result, any length.
__attribute__((target("avx512f,avx512bw")))
static inline int32_t byte_run_sum_avx512(const uint8_t* p, int64_t len) {
  const __m512i zero = _mm512_setzero_si512();
  __m512i acc = zero;
  int64_t i = 0;
  for (; i + 64 <= len; i += 64) {
    const __m512i v = _mm512_loadu_si512(p + i);
    acc = _mm512_add_epi64(acc, _mm512_sad_epu8(v, zero));
  }
  if (i < len) {
    const __mmask64 m = (__mmask64(1) << (len - i)) - 1;
    const __m512i v = _mm512_maskz_loadu_epi8(m, p + i);
    acc = _mm512_add_epi64(acc, _mm512_sad_epu8(v, zero));
  }
  return static_cast<int32_t>(_mm512_reduce_add_epi64(acc));
}

static bool cpu_has_avx512bw() {
  static const bool ok = __builtin_cpu_supports("avx512f") &&
                         __builtin_cpu_supports("avx512bw");
  return ok;
}
#endif  // AVD_HAVE_AVX512_TARGET

static inline void lap_row_dispatch(const uint8_t* up, const uint8_t* row,
                                    const uint8_t* dn, int64_t w,
                                    int64_t* sum, int64_t* sumsq) {
#ifdef AVD_HAVE_AVX512_TARGET
  if (w >= 66 && w <= 32000 && cpu_has_avx512bw()) {
    lap_row_avx512(up, row, dn, w, sum, sumsq);
    return;
  }
#endif
  lap_row(up, row, dn, w, sum, sumsq);
}

// ---------------------------------------------------------------------------
// Laplacian texture variance per frame: cv2.Laplacian(gray, CV_64F).var()
// semantics — ksize=1 stencil [[0,1,0],[1,-4,1],[0,1,0]], REFLECT_101
// borders, population variance in float64.  Threaded across frames.
// ---------------------------------------------------------------------------
static double lap_var_one(const uint8_t* g, int64_t h, int64_t w) {
  double sum = 0.0, sumsq = 0.0;
  const int64_t n = h * w;
  for (int64_t y = 0; y < h; ++y) {
    // reflect-101; size-1 axes degrade to index 0 like cv2's
    // borderInterpolate (len==1 special case) instead of reading OOB.
    const int64_t yu = (y == 0) ? std::min<int64_t>(1, h - 1) : y - 1;
    const int64_t yd = (y == h - 1) ? std::max<int64_t>(h - 2, 0) : y + 1;
    const uint8_t* rc = g + y * w;
    const uint8_t* ru = g + yu * w;
    const uint8_t* rd = g + yd * w;
    for (int64_t x = 0; x < w; ++x) {
      const int64_t xl = (x == 0) ? std::min<int64_t>(1, w - 1) : x - 1;
      const int64_t xr = (x == w - 1) ? std::max<int64_t>(w - 2, 0) : x + 1;
      const double lap = static_cast<double>(ru[x]) + rd[x] + rc[xl] +
                         rc[xr] - 4.0 * rc[x];
      sum += lap;
      sumsq += lap * lap;
    }
  }
  const double mean = sum / n;
  return sumsq / n - mean * mean;
}

// ---------------------------------------------------------------------------
// Fused per-frame prep: Laplacian variance + 32×32 area-average in one
// sweep over the gray rows (the area bins ride along while the rows are
// cache-hot).  Area semantics match cv2 INTER_AREA's fractional-overlap
// weighting; output rounded half-to-even like cv2's saturate_cast.
// ---------------------------------------------------------------------------
// ---------------------------------------------------------------------------
// Shared 32×32 INTER_AREA machinery.  The span weights and the final
// rounding replicate cv2 exactly (integer ratios use the fixed-point
// round-half-away path, fractional ratios float accumulation + cvRound
// half-to-even); the three per-frame sweeps below fold rows through this
// ONE copy of the logic so a parity-sensitive edit cannot silently
// diverge them (lap_area32_frame / prep320_frame / prep320_bgr_frame).
// ---------------------------------------------------------------------------
struct Area32 {
  static constexpr int kOut = 32;
  int64_t px0[kOut], px1[kOut];
  double w0[kOut], w1[kOut];
  double sy = 0.0, sx = 0.0;
  double band_rows[kOut][kOut];
  bool use_sad = false;

  void init(int64_t h, int64_t w) {
    sy = static_cast<double>(h) / kOut;
    sx = static_cast<double>(w) / kOut;
    // Per-output-column spans: [px0]·w0 + full[px0+1, px1) + [px1]·w1 so
    // the row fold is 32 vectorizable integer run-sums, not a per-pixel
    // double-precision scatter.
    for (int ox = 0; ox < kOut; ++ox) {
      const double lo = ox * sx;
      const double hi = (ox + 1) * sx;
      int64_t p0 = static_cast<int64_t>(std::floor(lo));
      int64_t p1 = static_cast<int64_t>(std::ceil(hi)) - 1;
      if (p1 >= w) p1 = w - 1;
      if (p1 == p0) {
        px0[ox] = p0; px1[ox] = p1; w0[ox] = hi - lo; w1[ox] = 0.0;
      } else {
      px0[ox] = p0; px1[ox] = p1;
        w0[ox] = (p0 + 1) - lo;
        w1[ox] = hi - p1;
      }
    }
    std::memset(band_rows, 0, sizeof(band_rows));
#ifdef AVD_HAVE_AVX512_TARGET
    use_sad = cpu_has_avx512bw();
#endif
  }

  void add_row(const uint8_t* row, int64_t y) {
    double col_acc[kOut];
    for (int ox = 0; ox < kOut; ++ox) {
      const int64_t p0 = px0[ox], p1 = px1[ox];
      if (p1 == p0) {
        col_acc[ox] = row[p0] * w0[ox];
        continue;
      }
      int32_t run = 0;
      if (use_sad) {
#ifdef AVD_HAVE_AVX512_TARGET
        if (p1 > p0 + 1) run = byte_run_sum_avx512(row + p0 + 1, p1 - p0 - 1);
#endif
      } else {
        for (int64_t x = p0 + 1; x < p1; ++x) run += row[x];
      }
      col_acc[ox] = run + row[p0] * w0[ox] + row[p1] * w1[ox];
    }
    // distribute the row into the (possibly two) output rows it overlaps
    int oy = static_cast<int>(y / sy);
    if (oy >= kOut) oy = kOut - 1;
    const double rsplit = static_cast<double>(oy + 1) * sy;
    if (static_cast<double>(y + 1) <= rsplit || oy == kOut - 1) {
      for (int c = 0; c < kOut; ++c) band_rows[oy][c] += col_acc[c];
    } else {
      const double top = rsplit - y;
      for (int c = 0; c < kOut; ++c) {
        band_rows[oy][c] += col_acc[c] * top;
        if (oy + 1 < kOut) band_rows[oy + 1][c] += col_acc[c] * (1.0 - top);
      }
    }
  }

  void finalize(int64_t h, int64_t w, uint8_t* area32) const {
    const double inv_area = 1.0 / (sy * sx);
    const bool integer_ratio = (h % kOut == 0) && (w % kOut == 0);
    for (int oy = 0; oy < kOut; ++oy)
      for (int ox = 0; ox < kOut; ++ox) {
        const double v = band_rows[oy][ox] * inv_area;
        double r = integer_ratio ? std::floor(v + 0.5) : std::nearbyint(v);
        if (r < 0) r = 0;
        if (r > 255) r = 255;
        area32[oy * kOut + ox] = static_cast<uint8_t>(r);
      }
  }
};

static void lap_area32_frame(const uint8_t* __restrict gray, int64_t h,
                             int64_t w, double* lap_var,
                             uint8_t* __restrict area32) {
  Area32 area;
  area.init(h, w);

  int64_t sum = 0, sumsq = 0;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = gray + y * w;
    // --- laplacian part ---
    const uint8_t* up = gray + (y == 0 ? 1 : y - 1) * w;
    const uint8_t* dn = gray + (y == h - 1 ? h - 2 : y + 1) * w;
    lap_row_dispatch(up, row, dn, w, &sum, &sumsq);
    area.add_row(row, y);
  }
  area.finalize(h, w, area32);

  const double n = static_cast<double>(h) * w;
  const double mean = sum / n;
  *lap_var = sumsq / n - mean * mean;
}

// ---------------------------------------------------------------------------
// Fully fused per-frame prep: Laplacian variance + 32×32 INTER_AREA +
// 320×320 INTER_LINEAR in ONE sweep over the gray rows.  The bilinear
// path replicates cv2's u8 fixed-point pipeline exactly (coefficients
// float-computed then rounded to 1/2048; horizontal pass in int32;
// vertical cast (((b0·(S0>>4))>>16) + ((b1·(S1>>4))>>16) + 2) >> 2) —
// verified bit-exact vs cv2 for all downscale ratios.  Downscale only
// (h, w > 320): each output row consumes two consecutive source rows, so
// a 2-row ring of horizontally-resampled rows suffices and most source
// rows skip the resample entirely.
// ---------------------------------------------------------------------------
static void lin320_coeffs(int64_t src, int32_t* sx, int32_t* a0,
                          int32_t* a1) {
  constexpr int kOut = 320;
  const double scale = static_cast<double>(src) / kOut;
  for (int i = 0; i < kOut; ++i) {
    float fx = static_cast<float>((i + 0.5) * scale - 0.5);
    int x = static_cast<int>(std::floor(fx));
    fx -= x;
    if (x < 0) { x = 0; fx = 0.f; }
    if (x >= src - 1) { x = static_cast<int>(src) - 2; fx = 1.f; }
    sx[i] = x;
    a1[i] = static_cast<int32_t>(std::lrintf(fx * 2048.f));
    a0[i] = 2048 - a1[i];
  }
}

static void prep320_frame(const uint8_t* __restrict gray, int64_t h,
                          int64_t w, double* lap_var,
                          uint8_t* __restrict area32,
                          uint8_t* __restrict lin320,
                          const int32_t* cx, const int32_t* ax0,
                          const int32_t* ax1, const int32_t* cy,
                          const int32_t* by0, const int32_t* by1,
                          const uint8_t* row_needed) {
  constexpr int kLin = 320;
  Area32 area;
  area.init(h, w);

  int32_t hring[2][kLin];   // horizontally resampled rows (ring)
  int64_t hring_idx[2] = {-1, -1};
  int oy_lin = 0;           // next 320-output row to emit

  int64_t sum = 0, sumsq = 0;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = gray + y * w;
    const uint8_t* up = gray + (y == 0 ? 1 : y - 1) * w;
    const uint8_t* dn = gray + (y == h - 1 ? h - 2 : y + 1) * w;
    lap_row_dispatch(up, row, dn, w, &sum, &sumsq);
    area.add_row(row, y);

    // --- 320×320 bilinear: resample this row if any output needs it ---
    if (row_needed[y]) {
      const int slot = static_cast<int>(y & 1);
      int32_t* hr = hring[slot];
      for (int ox = 0; ox < kLin; ++ox)
        hr[ox] = ax0[ox] * row[cx[ox]] + ax1[ox] * row[cx[ox] + 1];
      hring_idx[slot] = y;
      while (oy_lin < kLin && cy[oy_lin] + 1 == y) {
        const int32_t* s0 = hring[(y - 1) & 1];
        const int32_t* s1 = hr;
        // cy and cy+1 are consecutive and both marked needed, so the
        // other ring slot still holds row cy.
        (void)hring_idx;
        uint8_t* out = lin320 + oy_lin * kLin;
        const int32_t b0 = by0[oy_lin], b1 = by1[oy_lin];
        for (int ox = 0; ox < kLin; ++ox) {
          int32_t v = ((b0 * (s0[ox] >> 4)) >> 16) +
                      ((b1 * (s1[ox] >> 4)) >> 16);
          v = (v + 2) >> 2;
          out[ox] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
        ++oy_lin;
      }
    }
  }

  area.finalize(h, w, area32);

  const double n = static_cast<double>(h) * w;
  const double mean = sum / n;
  *lap_var = sumsq / n - mean * mean;
}

// Same fused prep, but straight from BGR: grayscale rows are produced
// into a 3-row ring (the Laplacian lags one row behind), so the full-res
// gray plane is never materialized — per 1080p frame that skips ~4 MB of
// write+read traffic vs gray-then-prep.
static void prep320_bgr_frame(const uint8_t* __restrict bgr, int64_t h,
                              int64_t w, double* lap_var,
                              uint8_t* __restrict area32,
                              uint8_t* __restrict lin320,
                              const int32_t* cx, const int32_t* ax0,
                              const int32_t* ax1, const int32_t* cy,
                              const int32_t* by0, const int32_t* by1,
                              const uint8_t* row_needed,
                              uint8_t* ring /* [3*w] */) {
  constexpr int kLin = 320;
  Area32 area;
  area.init(h, w);

  int32_t hring[2][kLin];
  int oy_lin = 0;
  int64_t sum = 0, sumsq = 0;

  for (int64_t y = 0; y < h; ++y) {
    uint8_t* row = ring + (y % 3) * w;
    gray_span(bgr + y * w * 3, row, 0, w);
    area.add_row(row, y);

    // --- bilinear 320 on the fresh gray row ---
    if (row_needed[y]) {
      const int slot = static_cast<int>(y & 1);
      int32_t* hr = hring[slot];
      for (int ox = 0; ox < kLin; ++ox)
        hr[ox] = ax0[ox] * row[cx[ox]] + ax1[ox] * row[cx[ox] + 1];
      while (oy_lin < kLin && cy[oy_lin] + 1 == y) {
        const int32_t* s0 = hring[(y - 1) & 1];
        const int32_t* s1 = hr;
        uint8_t* out = lin320 + oy_lin * kLin;
        const int32_t b0 = by0[oy_lin], b1 = by1[oy_lin];
        for (int ox = 0; ox < kLin; ++ox) {
          int32_t v = ((b0 * (s0[ox] >> 4)) >> 16) +
                      ((b1 * (s1[ox] >> 4)) >> 16);
          v = (v + 2) >> 2;
          out[ox] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
        ++oy_lin;
      }
    }

    // --- laplacian lags one row (needs the y+1 gray row as `dn`) ---
    if (y == 1) {
      const uint8_t* r0 = ring + 0 * w;  // row 0
      const uint8_t* r1 = ring + 1 * w;  // row 1 (reflect-101 up + dn)
      lap_row_dispatch(r1, r0, r1, w, &sum, &sumsq);
    }
    if (y >= 2)
      lap_row_dispatch(ring + ((y - 2) % 3) * w, ring + ((y - 1) % 3) * w,
                       ring + (y % 3) * w, w, &sum, &sumsq);
    if (y == h - 1) {
      const uint8_t* prev = ring + ((h - 2) % 3) * w;
      lap_row_dispatch(prev, ring + ((h - 1) % 3) * w, prev, w, &sum,
                       &sumsq);
    }
  }

  area.finalize(h, w, area32);

  const double n = static_cast<double>(h) * w;
  const double mean = sum / n;
  *lap_var = sumsq / n - mean * mean;
}

void avd_prep320_bgr_batch(const uint8_t* bgr, int64_t n_frames, int64_t h,
                           int64_t w, double* lap_var, uint8_t* area32,
                           uint8_t* lin320, int n_threads) {
  constexpr int kLin = 320;
  int32_t cx[kLin], ax0[kLin], ax1[kLin];
  int32_t cy[kLin], by0[kLin], by1[kLin];
  lin320_coeffs(w, cx, ax0, ax1);
  lin320_coeffs(h, cy, by0, by1);
  std::vector<uint8_t> row_needed(h, 0);
  for (int i = 0; i < kLin; ++i) {
    row_needed[cy[i]] = 1;
    row_needed[cy[i] + 1] = 1;
  }
  const int nt = std::max(1, std::min<int>(n_threads, 64));
  auto work = [&](int t) {
    std::vector<uint8_t> ring(3 * w);
    for (int64_t i = t; i < n_frames; i += nt)
      prep320_bgr_frame(bgr + i * h * w * 3, h, w, lap_var + i,
                        area32 + i * 32 * 32, lin320 + i * kLin * kLin,
                        cx, ax0, ax1, cy, by0, by1, row_needed.data(),
                        ring.data());
  };
  if (nt == 1 || n_frames == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int t = 0; t < nt; ++t) workers.emplace_back(work, t);
  for (auto& wkr : workers) wkr.join();
}

// Downscale-only (h > 320 && w > 320); callers fall back to the cv2 path
// otherwise.
void avd_prep320_batch(const uint8_t* gray, int64_t n_frames, int64_t h,
                       int64_t w, double* lap_var, uint8_t* area32,
                       uint8_t* lin320, int n_threads) {
  constexpr int kLin = 320;
  int32_t cx[kLin], ax0[kLin], ax1[kLin];
  int32_t cy[kLin], by0[kLin], by1[kLin];
  lin320_coeffs(w, cx, ax0, ax1);
  lin320_coeffs(h, cy, by0, by1);
  std::vector<uint8_t> row_needed(h, 0);
  for (int i = 0; i < kLin; ++i) {
    row_needed[cy[i]] = 1;
    row_needed[cy[i] + 1] = 1;
  }
  const int nt = std::max(1, std::min<int>(n_threads, 64));
  auto work = [&](int t) {
    for (int64_t i = t; i < n_frames; i += nt)
      prep320_frame(gray + i * h * w, h, w, lap_var + i,
                    area32 + i * 32 * 32, lin320 + i * kLin * kLin,
                    cx, ax0, ax1, cy, by0, by1, row_needed.data());
  };
  if (nt == 1 || n_frames == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int t = 0; t < nt; ++t) workers.emplace_back(work, t);
  for (auto& wkr : workers) wkr.join();
}

void avd_lap_area32_batch(const uint8_t* gray, int64_t n_frames, int64_t h,
                          int64_t w, double* lap_var, uint8_t* area32,
                          int n_threads) {
  const int nt = std::max(1, std::min<int>(n_threads, 64));
  auto work = [&](int t) {
    for (int64_t i = t; i < n_frames; i += nt)
      lap_area32_frame(gray + i * h * w, h, w, lap_var + i,
                       area32 + i * 32 * 32);
  };
  if (nt == 1 || n_frames == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int t = 0; t < nt; ++t) workers.emplace_back(work, t);
  for (auto& wkr : workers) wkr.join();
}

void avd_laplacian_var(const uint8_t* gray, int64_t n_frames, int64_t h,
                       int64_t w, double* out, int n_threads) {
  const int nt = std::max(1, std::min<int>(n_threads, 64));
  std::vector<std::thread> workers;
  workers.reserve(nt);
  auto work = [&](int t) {
    for (int64_t i = t; i < n_frames; i += nt)
      out[i] = lap_var_one(gray + i * h * w, h, w);
  };
  if (nt == 1 || n_frames == 1) {
    work(0);
    return;
  }
  for (int t = 0; t < nt; ++t) workers.emplace_back(work, t);
  for (auto& wkr : workers) wkr.join();
}

}  // extern "C"
