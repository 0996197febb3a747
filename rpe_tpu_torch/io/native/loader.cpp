// Native batched PNG decoder + grayscale converter for the rpe_tpu_torch IO
// layer (the port's own copy of rpe_tpu/io/native/loader.cpp, unchanged
// below this header).
//
// The reference's image ingestion delegates to OpenCV's C++ imread/cvtColor
// (reference: src/utils/image_loader.py:23-28 -> cv2 C++). A decoder of the
// project's own removes the per-image Python overhead and decodes a whole
// frame batch with a thread pool into one contiguous (N, H, W) buffer.
//
// Scope: 8-bit PNGs, color types 0 (gray), 2 (RGB), 3 (palette), 4 (gray+
// alpha), 6 (RGBA); no interlacing (Adam7 rejected); baseline JPEGs.
// Grayscale conversion uses PIL/BT.601 integer rounding ((19595 R + 38470 G
// + 7471 B + 32768) >> 16) so outputs are bit-identical to PIL's.
//
// Build: g++ -O2 -shared -fPIC loader.cpp -lz -o <library>; the port builds
// it at first use into rpe_tpu_torch/csrc/build/ (io/native/__init__.py).
// Exposed via ctypes; no pybind11 dependency.

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  uint32_t u32() {
    if (off + 4 > n) { ok = false; return 0; }
    uint32_t v = (uint32_t(p[off]) << 24) | (uint32_t(p[off + 1]) << 16) |
                 (uint32_t(p[off + 2]) << 8) | uint32_t(p[off + 3]);
    off += 4;
    return v;
  }
};

struct PngImage {
  uint32_t w = 0, h = 0;
  int channels = 0;  // after palette expansion: 1, 2, 3 or 4
  std::vector<uint8_t> pixels;  // h * w * channels
};

int paeth(int a, int b, int c) {
  int pp = a + b - c;
  int pa = pp > a ? pp - a : a - pp;
  int pb = pp > b ? pp - b : b - pp;
  int pc = pp > c ? pp - c : c - pp;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode one PNG from memory. Returns 0 on success. When expected_w/h are
// nonzero, the IHDR dimensions are validated against them BEFORE any
// pixel-buffer allocation, so a corrupt file declaring huge dimensions
// cannot drive a multi-GB allocation (std::bad_alloc escaping a worker
// thread would std::terminate the process).
int decode_png(const uint8_t* buf, size_t len, PngImage* out,
               uint32_t expected_w = 0, uint32_t expected_h = 0) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (len < 8 || memcmp(buf, kSig, 8) != 0) return 1;
  Reader r{buf, len, 8};

  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = -1, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // 3 * entries

  while (r.ok && r.off + 8 <= r.n) {
    uint32_t clen = r.u32();
    if (r.off + 4 > r.n) return 2;
    char ctype[5] = {0};
    memcpy(ctype, r.p + r.off, 4);
    r.off += 4;
    if (r.off + clen + 4 > r.n) return 2;
    const uint8_t* data = r.p + r.off;

    if (!strcmp(ctype, "IHDR")) {
      if (clen < 13) return 3;
      w = (uint32_t(data[0]) << 24) | (data[1] << 16) | (data[2] << 8) | data[3];
      h = (uint32_t(data[4]) << 24) | (data[5] << 16) | (data[6] << 8) | data[7];
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
      if (bit_depth != 8 || interlace != 0) return 4;  // out of scope
      if (expected_w && w != expected_w) return 10;
      if (expected_h && h != expected_h) return 10;
      // Absolute sanity bound even without expectations (probe path):
      // 2^26 pixels ≈ 67 MP caps the allocation at ~256 MB RGBA.
      if (uint64_t(w) * h > (1ull << 26)) return 10;
    } else if (!strcmp(ctype, "PLTE")) {
      palette.assign(data, data + clen);
    } else if (!strcmp(ctype, "IDAT")) {
      idat.insert(idat.end(), data, data + clen);
    } else if (!strcmp(ctype, "IEND")) {
      break;
    }
    r.off += clen + 4;  // skip data + CRC
  }
  if (w == 0 || h == 0 || idat.empty()) return 5;

  int src_ch;
  switch (color_type) {
    case 0: src_ch = 1; break;
    case 2: src_ch = 3; break;
    case 3: src_ch = 1; break;  // palette indices
    case 4: src_ch = 2; break;
    case 6: src_ch = 4; break;
    default: return 6;
  }

  const size_t stride = size_t(w) * src_ch;
  std::vector<uint8_t> raw((stride + 1) * h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size()) {
    return 7;
  }

  // Unfilter scanlines in place into `img`.
  std::vector<uint8_t> img(stride * h);
  const int bpp = src_ch;
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* line = raw.data() + y * (stride + 1);
    uint8_t filter = line[0];
    const uint8_t* src = line + 1;
    uint8_t* dst = img.data() + y * stride;
    const uint8_t* up = y ? img.data() + (y - 1) * stride : nullptr;
    switch (filter) {
      case 0:
        memcpy(dst, src, stride);
        break;
      case 1:
        for (size_t x = 0; x < stride; ++x)
          dst[x] = src[x] + (x >= size_t(bpp) ? dst[x - bpp] : 0);
        break;
      case 2:
        for (size_t x = 0; x < stride; ++x)
          dst[x] = src[x] + (up ? up[x] : 0);
        break;
      case 3:
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
          int b = up ? up[x] : 0;
          dst[x] = src[x] + uint8_t((a + b) >> 1);
        }
        break;
      case 4:
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
          int b = up ? up[x] : 0;
          int c = (up && x >= size_t(bpp)) ? up[x - bpp] : 0;
          dst[x] = src[x] + uint8_t(paeth(a, b, c));
        }
        break;
      default:
        return 8;
    }
  }

  // Palette expansion.
  if (color_type == 3) {
    if (palette.empty()) return 9;
    out->channels = 3;
    out->pixels.resize(size_t(w) * h * 3);
    for (size_t i = 0; i < size_t(w) * h; ++i) {
      int idx = img[i];
      if (size_t(idx) * 3 + 2 >= palette.size()) return 9;
      out->pixels[i * 3 + 0] = palette[idx * 3 + 0];
      out->pixels[i * 3 + 1] = palette[idx * 3 + 1];
      out->pixels[i * 3 + 2] = palette[idx * 3 + 2];
    }
  } else {
    out->channels = src_ch;
    out->pixels = std::move(img);
  }
  out->w = w;
  out->h = h;
  return 0;
}

// ---------------------------------------------------------------------------
// Baseline JPEG decoder (SOF0/SOF1, 8-bit, grayscale or YCbCr with 1x1/2x1/
// 2x2 subsampling, optional restart markers). The phone/salah datasets ship
// JPEG streams under .png names (reference loads them via cv2.imread,
// src/utils/image_loader.py:23); decoding them natively keeps the threaded
// batch path. IDCT, chroma upsampling and color conversion replicate
// libjpeg's integer "islow" IDCT, triangular "fancy" upsampling and
// fixed-point YCbCr->RGB, so output matches PIL within <=1 LSB.
// Progressive (SOF2) and exotic sampling factors return an error and the
// Python layer falls back to PIL.
// ---------------------------------------------------------------------------

struct HuffTable {
  // Canonical-code decode: mincode/maxcode per length + value table.
  int32_t mincode[17] = {0};
  int32_t maxcode[17] = {0};
  int32_t valptr[17] = {0};
  uint8_t values[256] = {0};
  bool present = false;
};

struct JpegComponent {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int dc_pred = 0;
  int bw = 0, bh = 0;            // plane size in samples (blocks*8)
  std::vector<uint8_t> plane;    // bw * bh, post-IDCT samples
};

struct BitReader {
  const uint8_t* p;
  size_t n, off;
  uint32_t buf = 0;
  int bits = 0;
  bool bad = false;

  explicit BitReader(const uint8_t* data, size_t len, size_t start)
      : p(data), n(len), off(start) {}

  void reset() { buf = 0; bits = 0; }

  int fill() {
    while (bits <= 24) {
      if (off >= n) { buf |= 0xFF << (24 - bits); bits += 8; continue; }
      uint8_t b = p[off];
      if (b == 0xFF) {
        if (off + 1 < n && p[off + 1] == 0x00) {
          off += 2;
        } else {
          // marker: pad with 1s (decoder stops at EOB/scan end)
          buf |= 0xFF << (24 - bits);
          bits += 8;
          continue;
        }
      } else {
        ++off;
      }
      buf |= uint32_t(b) << (24 - bits);
      bits += 8;
    }
    return 0;
  }

  int get_bits(int nb) {
    if (nb == 0) return 0;
    if (bits < nb) fill();
    int v = int(buf >> (32 - nb));
    buf <<= nb;
    bits -= nb;
    return v;
  }

  // Skip to the next restart marker (RSTn) and consume it.
  bool sync_restart() {
    reset();
    while (off + 1 < n) {
      if (p[off] == 0xFF && p[off + 1] >= 0xD0 && p[off + 1] <= 0xD7) {
        off += 2;
        return true;
      }
      ++off;
    }
    return false;
  }
};

int huff_decode(BitReader& br, const HuffTable& t) {
  if (br.bits < 16) br.fill();
  int code = 0;
  for (int l = 1; l <= 16; ++l) {
    code = (code << 1) | br.get_bits(1);
    if (t.maxcode[l] >= 0 && code <= t.maxcode[l] && code >= t.mincode[l]) {
      return t.values[t.valptr[l] + code - t.mincode[l]];
    }
  }
  br.bad = true;
  return 0;
}

inline int extend_receive(BitReader& br, int s) {
  if (s == 0) return 0;
  int v = br.get_bits(s);
  if (v < (1 << (s - 1))) v -= (1 << s) - 1;
  return v;
}

const uint8_t kZigzag[64] = {
    0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
   35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
   58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// libjpeg jidctint.c constants (CONST_BITS = 13)
enum {
  kConstBits = 13,
  kPass1Bits = 2,
};
#define JFIX(x) int32_t(x)
inline int32_t descale(int32_t x, int s) {
  return (x + (int32_t(1) << (s - 1))) >> s;
}

void idct_islow(const int32_t coef[64], const uint16_t qt[64],
                uint8_t* out, int stride) {
  int32_t ws[64];
  // pass 1: columns
  for (int c = 0; c < 8; ++c) {
    bool all_zero = true;
    for (int r = 1; r < 8; ++r)
      if (coef[r * 8 + c]) { all_zero = false; break; }
    if (all_zero) {
      int32_t dc = (coef[c] * int32_t(qt[c])) << kPass1Bits;
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int32_t z2 = coef[2 * 8 + c] * int32_t(qt[2 * 8 + c]);
    int32_t z3 = coef[6 * 8 + c] * int32_t(qt[6 * 8 + c]);
    int32_t z1 = (z2 + z3) * JFIX(4433);            // 0.541196100
    int32_t tmp2 = z1 + z3 * JFIX(-15137);          // -1.847759065
    int32_t tmp3 = z1 + z2 * JFIX(6270);            // 0.765366865
    int32_t in0 = coef[c] * int32_t(qt[c]);
    int32_t in4 = coef[4 * 8 + c] * int32_t(qt[4 * 8 + c]);
    int32_t tmp0 = (in0 + in4) << kConstBits;
    int32_t tmp1 = (in0 - in4) << kConstBits;
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    int32_t t0 = coef[7 * 8 + c] * int32_t(qt[7 * 8 + c]);
    int32_t t1 = coef[5 * 8 + c] * int32_t(qt[5 * 8 + c]);
    int32_t t2 = coef[3 * 8 + c] * int32_t(qt[3 * 8 + c]);
    int32_t t3 = coef[1 * 8 + c] * int32_t(qt[1 * 8 + c]);
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    int32_t z4 = t1 + t3;
    int32_t z5 = (z3 + z4) * JFIX(9633);            // 1.175875602
    t0 *= JFIX(2446);                               // 0.298631336
    t1 *= JFIX(16819);                              // 2.053119869
    t2 *= JFIX(25172);                              // 3.072711026
    t3 *= JFIX(12299);                              // 1.501321110
    z1 *= JFIX(-7373);                              // -0.899976223
    z2 *= JFIX(-20995);                             // -2.562915447
    z3 *= JFIX(-16069);                             // -1.961570560
    z4 *= JFIX(-3196);                              // -0.390180644
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;

    ws[0 * 8 + c] = descale(tmp10 + t3, kConstBits - kPass1Bits);
    ws[7 * 8 + c] = descale(tmp10 - t3, kConstBits - kPass1Bits);
    ws[1 * 8 + c] = descale(tmp11 + t2, kConstBits - kPass1Bits);
    ws[6 * 8 + c] = descale(tmp11 - t2, kConstBits - kPass1Bits);
    ws[2 * 8 + c] = descale(tmp12 + t1, kConstBits - kPass1Bits);
    ws[5 * 8 + c] = descale(tmp12 - t1, kConstBits - kPass1Bits);
    ws[3 * 8 + c] = descale(tmp13 + t0, kConstBits - kPass1Bits);
    ws[4 * 8 + c] = descale(tmp13 - t0, kConstBits - kPass1Bits);
  }
  // pass 2: rows
  auto clamp8 = [](int32_t v) -> uint8_t {
    v += 128;
    return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
  };
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * JFIX(4433);
    int32_t tmp2 = z1 + z3 * JFIX(-15137);
    int32_t tmp3 = z1 + z2 * JFIX(6270);
    int32_t tmp0 = (w[0] + w[4]) << kConstBits;
    int32_t tmp1 = (w[0] - w[4]) << kConstBits;
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    int32_t t0 = w[7], t1 = w[5], t2 = w[3], t3 = w[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    int32_t z4 = t1 + t3;
    int32_t z5 = (z3 + z4) * JFIX(9633);
    t0 *= JFIX(2446);
    t1 *= JFIX(16819);
    t2 *= JFIX(25172);
    t3 *= JFIX(12299);
    z1 *= JFIX(-7373);
    z2 *= JFIX(-20995);
    z3 *= JFIX(-16069);
    z4 *= JFIX(-3196);
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    uint8_t* o = out + r * stride;
    const int fs = kConstBits + kPass1Bits + 3;
    o[0] = clamp8(descale(tmp10 + t3, fs));
    o[7] = clamp8(descale(tmp10 - t3, fs));
    o[1] = clamp8(descale(tmp11 + t2, fs));
    o[6] = clamp8(descale(tmp11 - t2, fs));
    o[2] = clamp8(descale(tmp12 + t1, fs));
    o[5] = clamp8(descale(tmp12 - t1, fs));
    o[3] = clamp8(descale(tmp13 + t0, fs));
    o[4] = clamp8(descale(tmp13 - t0, fs));
  }
}

// libjpeg h2v2 "fancy" (triangular) chroma upsample of one plane.
// src: (sh, sw) -> dst: (2*sh, 2*sw). Row pairs blend 3:1 vertically, then
// 3:1 horizontally with the libjpeg rounding offsets.
void upsample_h2v2(const std::vector<uint8_t>& src, int sw, int sh,
                   int src_stride, std::vector<uint8_t>& dst, int dw, int dh) {
  dst.assign(size_t(dw) * dh, 0);
  std::vector<int> colsum(sw);
  for (int oy = 0; oy < dh; ++oy) {
    int sy = oy >> 1;
    int near = sy, far_ = (oy & 1) ? sy + 1 : sy - 1;
    if (far_ < 0) far_ = 0;
    if (far_ >= sh) far_ = sh - 1;
    const uint8_t* r0 = src.data() + size_t(near) * src_stride;
    const uint8_t* r1 = src.data() + size_t(far_) * src_stride;
    for (int x = 0; x < sw; ++x) colsum[x] = r0[x] * 3 + r1[x];
    uint8_t* o = dst.data() + size_t(oy) * dw;
    if (sw == 1) {
      int v = uint8_t((colsum[0] * 4 + 8) >> 4);
      for (int x = 0; x < dw; ++x) o[x] = uint8_t(v);
      continue;
    }
    o[0] = uint8_t((colsum[0] * 4 + 8) >> 4);
    o[1] = uint8_t((colsum[0] * 3 + colsum[1] + 7) >> 4);
    int xo = 2;
    for (int x = 1; x < sw - 1; ++x) {
      o[xo++] = uint8_t((colsum[x] * 3 + colsum[x - 1] + 8) >> 4);
      o[xo++] = uint8_t((colsum[x] * 3 + colsum[x + 1] + 7) >> 4);
    }
    o[xo++] = uint8_t((colsum[sw - 1] * 3 + colsum[sw - 2] + 8) >> 4);
    if (xo < dw) o[xo] = uint8_t((colsum[sw - 1] * 4 + 7) >> 4);
  }
}

// libjpeg h2v1 fancy upsample (horizontal only).
void upsample_h2v1(const std::vector<uint8_t>& src, int sw, int sh,
                   int src_stride, std::vector<uint8_t>& dst, int dw, int dh) {
  dst.assign(size_t(dw) * dh, 0);
  for (int y = 0; y < dh; ++y) {
    const uint8_t* s = src.data() + size_t(y < sh ? y : sh - 1) * src_stride;
    uint8_t* o = dst.data() + size_t(y) * dw;
    if (sw == 1) {
      for (int x = 0; x < dw; ++x) o[x] = s[0];
      continue;
    }
    o[0] = s[0];
    o[1] = uint8_t((s[0] * 3 + s[1] + 2) >> 2);
    int xo = 2;
    for (int x = 1; x < sw - 1; ++x) {
      o[xo++] = uint8_t((s[x] * 3 + s[x - 1] + 1) >> 2);
      o[xo++] = uint8_t((s[x] * 3 + s[x + 1] + 2) >> 2);
    }
    o[xo++] = uint8_t((s[sw - 1] * 3 + s[sw - 2] + 1) >> 2);
    if (xo < dw) o[xo] = s[sw - 1];
  }
}

// Decode one baseline JPEG from memory into `out` (RGB or grayscale).
// Returns 0 on success; nonzero codes identify the unsupported feature so
// the Python layer can fall back to PIL.
int decode_jpeg(const uint8_t* buf, size_t len, PngImage* out,
                uint32_t expected_w = 0, uint32_t expected_h = 0) {
  if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return 20;
  uint16_t qt[4][64] = {};
  bool qt_present[4] = {};
  HuffTable hdc[4], hac[4];
  JpegComponent comp[3];
  int ncomp = 0, width = 0, height = 0, restart_interval = 0;
  size_t i = 2;
  size_t scan_start = 0;

  while (i + 4 <= len) {
    if (buf[i] != 0xFF) return 21;
    uint8_t m = buf[i + 1];
    if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) { i += 2; continue; }
    size_t ln = (size_t(buf[i + 2]) << 8) | buf[i + 3];
    if (i + 2 + ln > len || ln < 2) return 21;
    const uint8_t* d = buf + i + 4;
    size_t dl = ln - 2;

    if (m == 0xDB) {                                // DQT
      size_t off = 0;
      while (off < dl) {
        int prec = d[off] >> 4, id = d[off] & 15;
        if (id > 3) return 22;
        if (off + 1 + (prec ? 128u : 64u) > dl) return 22;
        ++off;
        for (int k = 0; k < 64; ++k) {
          if (prec) {
            qt[id][kZigzag[k]] = uint16_t((d[off] << 8) | d[off + 1]);
            off += 2;
          } else {
            qt[id][kZigzag[k]] = d[off++];
          }
        }
        qt_present[id] = true;
      }
    } else if (m == 0xC4) {                         // DHT
      size_t off = 0;
      while (off + 17 <= dl) {
        int cls = d[off] >> 4, id = d[off] & 15;
        if (id > 3) return 23;
        HuffTable& t = cls ? hac[id] : hdc[id];
        int total = 0, code = 0, k = 0;
        for (int l = 1; l <= 16; ++l) total += d[off + l];
        if (off + 17 + total > dl || total > 256) return 23;
        for (int l = 1; l <= 16; ++l) {
          int cnt = d[off + l];
          t.valptr[l] = k;
          t.mincode[l] = code;
          for (int c = 0; c < cnt; ++c, ++k) t.values[k] = d[off + 17 + k];
          code += cnt;
          t.maxcode[l] = cnt ? code - 1 : -1;
          code <<= 1;
        }
        t.present = true;
        off += 17 + total;
      }
    } else if (m == 0xC0 || m == 0xC1) {            // SOF0/1 baseline
      if (dl < 6) return 24;
      if (d[0] != 8) return 24;
      height = (d[1] << 8) | d[2];
      width = (d[3] << 8) | d[4];
      ncomp = d[5];
      if (ncomp != 1 && ncomp != 3) return 24;
      if (dl < 6 + 3u * ncomp) return 24;
      if (expected_w && uint32_t(width) != expected_w) return 10;
      if (expected_h && uint32_t(height) != expected_h) return 10;
      if (uint64_t(width) * height > (1ull << 26)) return 10;
      for (int c = 0; c < ncomp; ++c) {
        comp[c].id = d[6 + 3 * c];
        comp[c].h = d[7 + 3 * c] >> 4;
        comp[c].v = d[7 + 3 * c] & 15;
        comp[c].tq = d[8 + 3 * c];
        if (comp[c].h < 1 || comp[c].h > 2 || comp[c].v < 1 || comp[c].v > 2)
          return 25;
      }
    } else if (m == 0xC2) {
      return 26;                                    // progressive: PIL path
    } else if (m == 0xDD) {                         // DRI
      if (dl < 2) return 21;
      restart_interval = (d[0] << 8) | d[1];
    } else if (m == 0xDA) {                         // SOS
      if (dl < 1) return 27;
      int ns = d[0];
      if (ns != ncomp) return 27;
      if (dl < 1 + 2u * ns) return 27;
      for (int s = 0; s < ns; ++s) {
        int cid = d[1 + 2 * s];
        for (int c = 0; c < ncomp; ++c)
          if (comp[c].id == cid) {
            comp[c].td = d[2 + 2 * s] >> 4;
            comp[c].ta = d[2 + 2 * s] & 15;
          }
      }
      scan_start = i + 2 + ln;
      break;
    }
    i += 2 + ln;
  }
  if (!width || !height || !scan_start) return 28;

  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; ++c) {
    hmax = comp[c].h > hmax ? comp[c].h : hmax;
    vmax = comp[c].v > vmax ? comp[c].v : vmax;
  }
  int mcux = (width + 8 * hmax - 1) / (8 * hmax);
  int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
  for (int c = 0; c < ncomp; ++c) {
    comp[c].bw = mcux * comp[c].h * 8;
    comp[c].bh = mcuy * comp[c].v * 8;
    comp[c].plane.assign(size_t(comp[c].bw) * comp[c].bh, 0);
    if (!qt_present[comp[c].tq] || !hdc[comp[c].td].present ||
        !hac[comp[c].ta].present)
      return 29;
  }

  BitReader br(buf, len, scan_start);
  int32_t coef[64];
  int mcu_count = 0;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      if (restart_interval && mcu_count && mcu_count % restart_interval == 0) {
        if (!br.sync_restart()) return 30;
        for (int c = 0; c < ncomp; ++c) comp[c].dc_pred = 0;
      }
      ++mcu_count;
      for (int c = 0; c < ncomp; ++c) {
        JpegComponent& cc = comp[c];
        for (int by = 0; by < cc.v; ++by) {
          for (int bx = 0; bx < cc.h; ++bx) {
            memset(coef, 0, sizeof(coef));
            int s = huff_decode(br, hdc[cc.td]);
            cc.dc_pred += extend_receive(br, s);
            coef[0] = cc.dc_pred;
            for (int k = 1; k < 64;) {
              int rs = huff_decode(br, hac[cc.ta]);
              int r = rs >> 4, sz = rs & 15;
              if (sz == 0) {
                if (r != 15) break;                 // EOB
                k += 16;
              } else {
                k += r;
                if (k > 63) { br.bad = true; break; }
                coef[kZigzag[k]] = extend_receive(br, sz);
                ++k;
              }
            }
            if (br.bad) return 31;
            int px = (mx * cc.h + bx) * 8;
            int py = (my * cc.v + by) * 8;
            idct_islow(coef, qt[cc.tq],
                       cc.plane.data() + size_t(py) * cc.bw + px, cc.bw);
          }
        }
      }
    }
  }

  // Upsample chroma to full resolution, then color-convert.
  if (ncomp == 1) {
    out->channels = 1;
    out->pixels.resize(size_t(width) * height);
    for (int y = 0; y < height; ++y)
      memcpy(out->pixels.data() + size_t(y) * width,
             comp[0].plane.data() + size_t(y) * comp[0].bw, width);
    out->w = width;
    out->h = height;
    return 0;
  }

  std::vector<uint8_t> up[3];
  for (int c = 0; c < 3; ++c) {
    JpegComponent& cc = comp[c];
    int sx = hmax / cc.h, sy = vmax / cc.v;
    // source extent actually covered by the image in this plane
    int sw = (width * cc.h + hmax - 1) / hmax;
    int sh = (height * cc.v + vmax - 1) / vmax;
    if (sx == 1 && sy == 1) {
      up[c].assign(size_t(width) * height, 0);
      for (int y = 0; y < height; ++y)
        memcpy(up[c].data() + size_t(y) * width,
               cc.plane.data() + size_t(y < sh ? y : sh - 1) * cc.bw, width);
    } else if (sx == 2 && sy == 2) {
      upsample_h2v2(cc.plane, sw, sh, cc.bw, up[c], width, height);
    } else if (sx == 2 && sy == 1) {
      upsample_h2v1(cc.plane, sw, sh, cc.bw, up[c], width, height);
    } else {
      return 25;
    }
  }

  // libjpeg fixed-point YCbCr -> RGB (jdcolor.c, SCALEBITS = 16)
  static int32_t crr[256], cbb[256], crg[256], cbg[256];
  static bool tabs_init = false;
  if (!tabs_init) {
    for (int v = 0; v < 256; ++v) {
      int x = v - 128;
      crr[v] = (int32_t(1.40200 * 65536 + 0.5) * x + 32768) >> 16;
      cbb[v] = (int32_t(1.77200 * 65536 + 0.5) * x + 32768) >> 16;
      crg[v] = -int32_t(0.71414 * 65536 + 0.5) * x;
      cbg[v] = -int32_t(0.34414 * 65536 + 0.5) * x + 32768;
    }
    tabs_init = true;
  }
  out->channels = 3;
  out->pixels.resize(size_t(width) * height * 3);
  auto clamp = [](int v) -> uint8_t {
    return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
  };
  for (size_t p = 0; p < size_t(width) * height; ++p) {
    int y = up[0][p], cb = up[1][p], cr = up[2][p];
    out->pixels[p * 3 + 0] = clamp(y + crr[cr]);
    out->pixels[p * 3 + 1] = clamp(y + ((cbg[cb] + crg[cr]) >> 16));
    out->pixels[p * 3 + 2] = clamp(y + cbb[cb]);
  }
  out->w = width;
  out->h = height;
  return 0;
}

uint8_t to_gray(const uint8_t* px, int ch) {
  switch (ch) {
    case 1:
    case 2:  // gray (+alpha): alpha ignored
      return px[0];
    default:  // RGB / RGBA — PIL/BT.601 integer rounding
      return uint8_t((19595u * px[0] + 38470u * px[1] + 7471u * px[2] +
                      32768u) >> 16);
  }
}

std::vector<uint8_t> read_file(const char* path) {
  std::vector<uint8_t> buf;
  FILE* f = fopen(path, "rb");
  if (!f) return buf;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz > 0) {
    buf.resize(size_t(sz));
    if (fread(buf.data(), 1, size_t(sz), f) != size_t(sz)) buf.clear();
  }
  fclose(f);
  return buf;
}

}  // namespace

extern "C" {

// Read the dimensions of one PNG. Returns 0 on success.
int rpe_png_dims(const char* path, int* w, int* h) {
  auto buf = read_file(path);
  PngImage img;
  // cheap header-only parse: decode fully is fine for one probe image, but
  // parse just IHDR here.
  if (buf.size() < 33) return 1;
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (memcmp(buf.data(), kSig, 8) != 0) return 1;
  const uint8_t* d = buf.data() + 16;
  *w = (int(d[0]) << 24) | (d[1] << 16) | (d[2] << 8) | d[3];
  *h = (int(d[4]) << 24) | (d[5] << 16) | (d[6] << 8) | d[7];
  return 0;
}

// Dimensions of one PNG or baseline JPEG (header-only parse).
// Returns 0 on success; 2 = JPEG but progressive/unsupported (caller should
// use the PIL path); 1 = unreadable/unknown format.
int rpe_image_dims(const char* path, int* w, int* h) {
  auto buf = read_file(path);
  if (buf.size() >= 33 &&
      memcmp(buf.data(), "\x89PNG\r\n\x1a\n", 8) == 0) {
    const uint8_t* d = buf.data() + 16;
    *w = (int(d[0]) << 24) | (d[1] << 16) | (d[2] << 8) | d[3];
    *h = (int(d[4]) << 24) | (d[5] << 16) | (d[6] << 8) | d[7];
    return 0;
  }
  if (buf.size() >= 4 && buf[0] == 0xFF && buf[1] == 0xD8) {
    size_t i = 2;
    while (i + 9 <= buf.size()) {
      if (buf[i] != 0xFF) return 1;
      uint8_t m = buf[i + 1];
      if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) { i += 2; continue; }
      size_t ln = (size_t(buf[i + 2]) << 8) | buf[i + 3];
      if (m == 0xC0 || m == 0xC1) {
        *h = (buf[i + 5] << 8) | buf[i + 6];
        *w = (buf[i + 7] << 8) | buf[i + 8];
        return 0;
      }
      if (m == 0xC2) return 2;  // progressive: PIL fallback
      if (m == 0xDA) return 1;
      i += 2 + ln;
    }
    return 1;
  }
  return 1;
}

// Decode a batch of same-size PNGs into `out` (n * h * w bytes, grayscale)
// or (n * h * w * 3, BGR) when to_gray == 0. Returns 0 on success, else the
// 1-based index of the first failing file.
int rpe_decode_batch(const char** paths, int n, int w, int h,
                     unsigned char* out, int to_gray_flag, int nthreads) {
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  const size_t px_per_img = size_t(w) * h;
  const int out_ch = to_gray_flag ? 1 : 3;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load()) return;
      auto buf = read_file(paths[i]);
      PngImage img;
      bool ok = false;
      try {
        if (buf.size() >= 8 &&
            memcmp(buf.data(), "\x89PNG\r\n\x1a\n", 8) == 0) {
          ok = decode_png(buf.data(), buf.size(), &img, uint32_t(w),
                          uint32_t(h)) == 0;
        } else if (buf.size() >= 2 && buf[0] == 0xFF && buf[1] == 0xD8) {
          ok = decode_jpeg(buf.data(), buf.size(), &img, uint32_t(w),
                           uint32_t(h)) == 0;
        }
        ok = ok && int(img.w) == w && int(img.h) == h;
      } catch (...) {
        ok = false;  // bad_alloc etc. -> per-file failure, not terminate
      }
      if (!ok) {
        int expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
        return;
      }
      unsigned char* dst = out + size_t(i) * px_per_img * out_ch;
      if (to_gray_flag) {
        for (size_t p = 0; p < px_per_img; ++p)
          dst[p] = to_gray(&img.pixels[p * img.channels], img.channels);
      } else {
        for (size_t p = 0; p < px_per_img; ++p) {
          const uint8_t* s = &img.pixels[p * img.channels];
          uint8_t rr = s[0], gg = img.channels >= 3 ? s[1] : s[0],
                  bb = img.channels >= 3 ? s[2] : s[0];
          dst[p * 3 + 0] = bb;  // BGR, reference channel order
          dst[p * 3 + 1] = gg;
          dst[p * 3 + 2] = rr;
        }
      }
    }
  };

  int nt = nthreads > 0 ? nthreads : int(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt > n) nt = n;
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failed.load();
}

}  // extern "C"
