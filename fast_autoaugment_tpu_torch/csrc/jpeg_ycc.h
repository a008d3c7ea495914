// libjpeg's chroma upsampling and YCbCr -> RGB conversion, for the nvJPEG
// build of the native loader (nvjpeg_loader.cpp): given the Y, Cb and Cr
// planes a JPEG decodes to, these make the RGB pixels libjpeg makes of them
// (libjpeg-turbo's jdsample.c h2v1_fancy_upsample and h2v2_fancy_upsample,
// the image's first and last rows standing in for the rows beyond them,
// plain replication for planes at most 2 samples wide; jdcolor.c
// ycc_rgb_convert's fixed-point tables).  tests/test_torch_native_loader.py
// holds them bitwise against libjpeg's own decode on the CPU.

#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace faa_jpeg {

// a chroma plane (cw x ch) replicated 2x horizontally (and vertically with
// `v2`): libjpeg's upsampling of a plane at most 2 samples wide
inline void upsample_box(const uint8_t* in, int cw, int ch, bool v2, uint8_t* out) {
  for (int y = 0; y < ch * (v2 ? 2 : 1); ++y) {
    const uint8_t* row = in + size_t(v2 ? y / 2 : y) * cw;
    for (int x = 0; x < 2 * cw; ++x) out[size_t(y) * 2 * cw + x] = row[x / 2];
  }
}

// a chroma plane (cw x ch) upsampled 2x horizontally: out is (2 cw) x ch
inline void upsample_h2v1(const uint8_t* in, int cw, int ch, uint8_t* out) {
  if (cw <= 2) return upsample_box(in, cw, ch, false, out);
  for (int y = 0; y < ch; ++y) {
    const uint8_t* row = in + size_t(y) * cw;
    uint8_t* o = out + size_t(y) * 2 * cw;
    for (int x = 0; x < cw; ++x) {
      const int v = row[x] * 3;
      const int left = row[x > 0 ? x - 1 : 0];
      const int right = row[x + 1 < cw ? x + 1 : cw - 1];
      o[2 * x] = uint8_t(x == 0 ? row[x] : (v + left + 1) >> 2);
      o[2 * x + 1] = uint8_t(x == cw - 1 ? row[x] : (v + right + 2) >> 2);
    }
  }
}

// a chroma plane (cw x ch) upsampled 2x both ways: out is (2 cw) x (2 ch)
inline void upsample_h2v2(const uint8_t* in, int cw, int ch, uint8_t* out) {
  if (cw <= 2) return upsample_box(in, cw, ch, true, out);
  std::vector<int> sums(cw);
  for (int y = 0; y < ch; ++y) {
    const uint8_t* row = in + size_t(y) * cw;
    for (int v = 0; v < 2; ++v) {
      // the nearer row weighs 3, the next nearest (above for the upper
      // output row, below for the lower) 1
      const int yn = v == 0 ? (y > 0 ? y - 1 : 0) : (y + 1 < ch ? y + 1 : ch - 1);
      const uint8_t* near = in + size_t(yn) * cw;
      for (int x = 0; x < cw; ++x) sums[x] = row[x] * 3 + near[x];
      uint8_t* o = out + (size_t(2 * y + v) * 2 * cw);
      for (int x = 0; x < cw; ++x) {
        const int t = sums[x];
        const int last = sums[x > 0 ? x - 1 : 0];
        const int next = sums[x + 1 < cw ? x + 1 : cw - 1];
        o[2 * x] = uint8_t(x == 0 ? (t * 4 + 8) >> 4 : (t * 3 + last + 8) >> 4);
        o[2 * x + 1] = uint8_t(x == cw - 1 ? (t * 4 + 7) >> 4 : (t * 3 + next + 7) >> 4);
      }
    }
  }
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
};

inline const YccTables& ycc_tables() {
  static const YccTables t = [] {
    YccTables out;
    constexpr int kScaleBits = 16;
    constexpr int32_t kHalf = int32_t(1) << (kScaleBits - 1);
    auto fix = [](double x) { return int32_t(x * (1 << kScaleBits) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int32_t x = i - 128;
      out.cr_r[i] = int((fix(1.40200) * x + kHalf) >> kScaleBits);
      out.cb_b[i] = int((fix(1.77200) * x + kHalf) >> kScaleBits);
      out.cr_g[i] = -fix(0.71414) * x;
      out.cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    return out;
  }();
  return t;
}

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// Y (w x h) and full-resolution Cb, Cr (each row `cstride` wide) -> RGB
inline void ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int w, int h,
                int cstride, uint8_t* rgb) {
  const YccTables& t = ycc_tables();
  for (int r = 0; r < h; ++r) {
    for (int x = 0; x < w; ++x) {
      const int yy = y[size_t(r) * w + x];
      const int b = cb[size_t(r) * cstride + x], c = cr[size_t(r) * cstride + x];
      uint8_t* px = rgb + (size_t(r) * w + x) * 3;
      px[0] = clamp255(yy + t.cr_r[c]);
      px[1] = clamp255(yy + int((t.cb_g[b] + t.cr_g[c]) >> 16));
      px[2] = clamp255(yy + t.cb_b[b]);
    }
  }
}

}  // namespace faa_jpeg
