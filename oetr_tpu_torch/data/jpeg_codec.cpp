// A baseline JPEG codec for the host, integer arithmetic only.
//
// It computes what libjpeg-turbo computes with its default settings (the
// ones cv2.imread and cv2.imwrite use), so that its output is cv2's:
//
// Decode: SOF0 and 8-bit SOF1 (Huffman, sequential), 1 or 3 components,
// any integral sampling ratio (4:4:4, 4:2:2, 4:4:0, 4:2:0 ...), 8- and
// 16-bit DQT, DRI and restart markers, interleaved and non-interleaved
// scans; the ISLOW integer IDCT (jidctint.c) with its range limit, fancy
// upsampling (jdsample.c: h2v1, h1v2, h2v2 triangle filters, box
// replication elsewhere and where a downsampled row is <= 2 samples), the
// integer YCbCr->RGB tables (jdcolor.c). A gray read of a color file is
// the Y plane; an RGB-coded file (Adobe transform 0 or component ids
// 'R','G','B') converts to gray with the encoder's Y weights.
// Progressive, lossless, arithmetic-coded, hierarchical, 12-bit and
// 2- or 4-component (CMYK) files throw, naming the SOF marker.
//
// Encode: baseline, the JFIF APP0 header, the Annex K quantization
// tables scaled to kQuality (forced to baseline), 4:2:0 for color (h2v2
// downsampling with libjpeg's alternating 1,2 bias) and one component for
// gray, the ISLOW FDCT (jfdctint.c) and libjpeg-turbo's reciprocal
// quantizer, the standard Huffman tables, no restart interval: the bytes
// of cv2.imwrite at its defaults.
//
// C interface (bound with ctypes by data/jpeg.py):
//   int oetr_jpeg_decode(src, n, gray, &out, &h, &w, &c, err, err_cap)
//     0 and a malloc'd [h, w, c] uint8 buffer (RGB, or c = 1 for gray);
//     else nonzero, the reason in err and no buffer.
//   int oetr_jpeg_encode(pix, h, w, c, &out, &n, err, err_cap)
//     pix is [h, w, c] uint8, c = 3 (RGB) or 1 (gray); 0 and a malloc'd
//     buffer of n bytes, else nonzero and the reason in err.
//   void oetr_jpeg_free(p)
#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Error(buf);
}

// Zigzag position -> natural (row-major) index; 16 extra entries absorb a
// run past the end of a corrupt block, as libjpeg's table does.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- DCTs --
// jidctint.c / jfdctint.c: CONST_BITS 13, PASS1_BITS 2.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) {
  return (x + (int32_t(1) << (n - 1))) >> n;
}

// libjpeg's post-IDCT range limit: index (x & 1023) of a table that maps
// [-128, 127] to [0, 255], clamps [128, 511] to 255 and [-512, -129] to 0.
struct RangeLimit {
  u8 t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      int v = i < 512 ? i : i - 1024;  // the signed value of the index
      int s = v + 128;
      t[i] = u8(s < 0 ? 0 : (s > 255 ? 255 : s));
    }
  }
};
const RangeLimit kRange;

// Dequantize and inverse-DCT one block into 8 rows of out (stride).
void idct_islow(const int16_t* coef, const u16* q, u8* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const u16* qp = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = (int(in[0]) * int(qp[0])) * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int32_t z2 = int32_t(in[16]) * qp[16];
    int32_t z3 = int32_t(in[48]) * qp[48];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int32_t(in[0]) * qp[0];
    z3 = int32_t(in[32]) * qp[32];
    int32_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int32_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int32_t(in[56]) * qp[56];
    tmp1 = int32_t(in[40]) * qp[40];
    tmp2 = int32_t(in[24]) * qp[24];
    tmp3 = int32_t(in[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, n);
    w[56] = descale(tmp10 - tmp3, n);
    w[8] = descale(tmp11 + tmp2, n);
    w[48] = descale(tmp11 - tmp2, n);
    w[16] = descale(tmp12 + tmp1, n);
    w[40] = descale(tmp12 - tmp1, n);
    w[24] = descale(tmp13 + tmp0, n);
    w[32] = descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    u8* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      u8 dc = kRange.t[descale(w[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; c++) o[c] = dc;
      continue;
    }
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (int32_t(w[0]) + w[4]) * (1 << kConstBits);
    int32_t tmp1 = (int32_t(w[0]) - w[4]) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    o[0] = kRange.t[descale(tmp10 + tmp3, n) & 1023];
    o[7] = kRange.t[descale(tmp10 - tmp3, n) & 1023];
    o[1] = kRange.t[descale(tmp11 + tmp2, n) & 1023];
    o[6] = kRange.t[descale(tmp11 - tmp2, n) & 1023];
    o[2] = kRange.t[descale(tmp12 + tmp1, n) & 1023];
    o[5] = kRange.t[descale(tmp12 - tmp1, n) & 1023];
    o[3] = kRange.t[descale(tmp13 + tmp0, n) & 1023];
    o[4] = kRange.t[descale(tmp13 - tmp0, n) & 1023];
  }
}

// Forward DCT of one block of (sample - 128) values, in place; 16-bit
// storage between the passes as libjpeg-turbo's SIMD build keeps it.
void fdct_islow(int16_t* d) {
  for (int r = 0; r < 8; r++) {
    int16_t* p = d + 8 * r;
    int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int32_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int32_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int16_t((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = int16_t((tmp10 - tmp11) * (1 << kPass1Bits));
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int n = kConstBits - kPass1Bits;
    p[2] = int16_t(descale(z1 + tmp13 * FIX_0_765366865, n));
    p[6] = int16_t(descale(z1 + tmp12 * (-FIX_1_847759065), n));
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = int16_t(descale(tmp4 + z1 + z3, n));
    p[5] = int16_t(descale(tmp5 + z2 + z4, n));
    p[3] = int16_t(descale(tmp6 + z2 + z3, n));
    p[1] = int16_t(descale(tmp7 + z1 + z4, n));
  }
  for (int c = 0; c < 8; c++) {
    int16_t* p = d + c;
    int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int32_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int32_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int16_t(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = int16_t(descale(tmp10 - tmp11, kPass1Bits));
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int n = kConstBits + kPass1Bits;
    p[16] = int16_t(descale(z1 + tmp13 * FIX_0_765366865, n));
    p[48] = int16_t(descale(z1 + tmp12 * (-FIX_1_847759065), n));
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = int16_t(descale(tmp4 + z1 + z3, n));
    p[40] = int16_t(descale(tmp5 + z2 + z4, n));
    p[24] = int16_t(descale(tmp6 + z2 + z3, n));
    p[8] = int16_t(descale(tmp7 + z1 + z4, n));
  }
}

// ------------------------------------------------------ color tables --
// jccolor.c's RGB->YCbCr table (SCALEBITS 16), also the decoder's RGB->Y.
struct RgbYcc {
  int32_t t[8 * 256];
  RgbYcc() {
    auto fix = [](double x) { return int32_t(x * 65536.0 + 0.5); };
    const int32_t half = 1 << 15, cbcr = 128 << 16;
    for (int i = 0; i < 256; i++) {
      t[i] = fix(0.29900) * i;
      t[i + 256] = fix(0.58700) * i;
      t[i + 512] = fix(0.11400) * i + half;
      t[i + 768] = -fix(0.16874) * i;
      t[i + 1024] = -fix(0.33126) * i;
      t[i + 1280] = fix(0.50000) * i + cbcr + half - 1;
      t[i + 1536] = -fix(0.41869) * i;
      t[i + 1792] = -fix(0.08131) * i;
    }
  }
  u8 y(int r, int g, int b) const {
    return u8((t[r] + t[g + 256] + t[b + 512]) >> 16);
  }
  u8 cb(int r, int g, int b) const {
    return u8((t[r + 768] + t[g + 1024] + t[b + 1280]) >> 16);
  }
  u8 cr(int r, int g, int b) const {  // R->Cr is B->Cb's table
    return u8((t[r + 1280] + t[g + 1536] + t[b + 1792]) >> 16);
  }
};
const RgbYcc kRgbYcc;

// jdcolor.c's YCbCr->RGB tables.
struct YccRgb {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccRgb() {
    auto fix = [](double x) { return int32_t(x * 65536.0 + 0.5); };
    const int32_t half = 1 << 15;
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = int((fix(1.40200) * x + half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccRgb kYccRgb;

inline u8 clamp255(int v) { return u8(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ============================================================ decoder ==

struct Huff {
  bool defined = false;
  u8 bits[17] = {};
  u8 vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  u8 look_nbits[1 << 9] = {};
  u8 look_sym[1 << 9] = {};
};

void derive_huff(Huff& h, bool dc) {
  int size[257], code[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < h.bits[l]; i++) size[p++] = l;
  size[p] = 0;
  int nsym = p;
  int c = 0, si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) {
      code[p++] = c;
      c++;
    }
    if (c >= (1 << si)) fail("bad Huffman table");
    c <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (h.bits[l]) {
      h.valoffset[l] = p - code[p];
      p += h.bits[l];
      h.maxcode[l] = code[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.valoffset[17] = 0;
  h.maxcode[17] = 0xFFFFF;
  memset(h.look_nbits, 0, sizeof h.look_nbits);
  p = 0;
  for (int l = 1; l <= 9; l++) {
    for (int i = 1; i <= h.bits[l]; i++, p++) {
      int look = code[p] << (9 - l);
      for (int k = 1 << (9 - l); k > 0; k--) {
        h.look_nbits[look] = u8(l);
        h.look_sym[look] = h.vals[p];
        look++;
      }
    }
  }
  if (dc)
    for (int i = 0; i < nsym; i++)
      if (h.vals[i] > 15) fail("bad Huffman table");
}

struct BitReader {
  const u8* d;
  size_t n;
  size_t pos;
  u64 acc = 0;
  int cnt = 0;
  bool marker = false;  // a marker stops the data: zeros are fed after it

  void fill() {
    while (cnt <= 56) {
      u64 byte = 0;
      if (!marker && pos < n) {
        if (d[pos] == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) q++;
          if (q < n && d[q] == 0x00) {
            byte = 0xFF;
            pos = q + 1;
          } else {
            marker = true;  // pos stays on the marker's first 0xFF
          }
        } else {
          byte = d[pos++];
        }
      }
      acc |= byte << (56 - cnt);
      cnt += 8;
    }
  }
  int get(int s) {  // s in 1..16, after fill()
    int v = int(acc >> (64 - s));
    acc <<= s;
    cnt -= s;
    return v;
  }
  int decode(const Huff& h) {
    fill();
    int look = int(acc >> (64 - 9));
    int nb = h.look_nbits[look];
    if (nb) {
      acc <<= nb;
      cnt -= nb;
      return h.look_sym[look];
    }
    for (int l = 10; l <= 16; l++) {
      int32_t c = int32_t(acc >> (64 - l));
      if (c <= h.maxcode[l]) {
        acc <<= l;
        cnt -= l;
        return h.vals[(c + h.valoffset[l]) & 0xFF];
      }
    }
    // A corrupt code: libjpeg warns and takes 0.
    acc <<= 16;
    cnt -= 16;
    return 0;
  }
  void reset() {
    acc = 0;
    cnt = 0;
    marker = false;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id, h, v, tq;
  int bw, bh;          // blocks allocated (whole MCUs)
  int wib, hib;        // blocks of real data
  int dw, dh;          // downsampled size
  std::vector<int16_t> coef;
  u16 q[64];
  bool q_latched = false;
  int dc_pred = 0;
};

struct Decoder {
  const u8* d;
  size_t n;
  size_t pos = 0;
  u16 qt[4][64];
  bool qdef[4] = {};
  Huff dc[4], ac[4];
  int restart = 0;
  int width = 0, height = 0;
  int maxh = 1, maxv = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;

  u8 byte() {
    if (pos >= n) fail("truncated JPEG header");
    return d[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int pt = byte();
      int prec = pt >> 4, t = pt & 15;
      if (t > 3 || prec > 1) fail("bad DQT table %d", t);
      for (int i = 0; i < 64; i++)
        qt[t][kNatural[i]] = u16(prec ? word() : byte());
      qdef[t] = true;
    }
  }
  void read_dht(size_t end) {
    while (pos < end) {
      int tc = byte();
      int cls = tc >> 4, t = tc & 15;
      if (cls > 1 || t > 3) fail("bad DHT table");
      Huff& h = cls ? ac[t] : dc[t];
      int count = 0;
      h.bits[0] = 0;
      for (int l = 1; l <= 16; l++) {
        h.bits[l] = byte();
        count += h.bits[l];
      }
      if (count > 256) fail("bad Huffman table");
      for (int i = 0; i < count; i++) h.vals[i] = byte();
      derive_huff(h, cls == 0);
      h.defined = true;
    }
  }
  void read_sof(int marker) {
    if (frame) fail("two frames");
    int prec = byte();
    if (prec != 8) fail("%d-bit precision (SOF%d)", prec, marker - 0xC0);
    height = word();
    width = word();
    int nc = byte();
    if (height == 0) fail("DNL-sized JPEG (height 0)");
    if (width == 0) fail("empty JPEG");
    if (nc == 4) fail("4-component (CMYK/YCCK) JPEG (SOF%d)", marker - 0xC0);
    if (nc != 1 && nc != 3)
      fail("%d-component JPEG (SOF%d)", nc, marker - 0xC0);
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad sampling factors");
      maxh = std::max(maxh, c.h);
      maxv = std::max(maxv, c.v);
    }
    mcux = (width + 8 * maxh - 1) / (8 * maxh);
    mcuy = (height + 8 * maxv - 1) / (8 * maxv);
    for (auto& c : comps) {
      if (maxh % c.h || maxv % c.v) fail("fractional sampling ratio");
      c.dw = int((int64_t(width) * c.h + maxh - 1) / maxh);
      c.dh = int((int64_t(height) * c.v + maxv - 1) / maxv);
      c.wib = (c.dw + 7) / 8;
      c.hib = (c.dh + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    }
    frame = true;
  }

  void decode_block(BitReader& br, Component& c, const Huff& hd,
                    const Huff& ha, int16_t* blk) {
    int s = br.decode(hd);
    int diff = 0;
    if (s) {
      if (s > 16) s = 16;
      br.fill();
      diff = extend(br.get(s), s);
    }
    c.dc_pred += diff;
    blk[0] = int16_t(c.dc_pred);
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        br.fill();
        blk[kNatural[k]] = int16_t(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // Position after the entropy data: the next marker (garbage skipped).
  size_t find_marker(size_t from) {
    size_t p = from;
    while (p + 1 < n) {
      if (d[p] == 0xFF && d[p + 1] != 0x00 && d[p + 1] != 0xFF) return p;
      p++;
    }
    return n;
  }

  void read_sos() {
    if (!frame) fail("SOS before SOF");
    int ns = byte();
    if (ns < 1 || ns > 4) fail("bad SOS");
    std::vector<Component*> sc;
    std::vector<int> td(ns), ta(ns);
    for (int i = 0; i < ns; i++) {
      int id = byte(), t = byte();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) fail("SOS names an unknown component %d", id);
      sc.push_back(found);
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3 || !dc[td[i]].defined || !ac[ta[i]].defined)
        fail("SOS names an undefined Huffman table");
    }
    int ss = byte(), se = byte(), a = byte();
    if (ss != 0 || se != 63 || a != 0) fail("not a sequential scan");
    for (auto* c : sc) {
      if (!c->q_latched) {
        if (!qdef[c->tq]) fail("undefined quantization table %d", c->tq);
        memcpy(c->q, qt[c->tq], sizeof c->q);
        c->q_latched = true;
      }
      c->dc_pred = 0;
    }
    BitReader br{d, n, pos};
    int togo = restart;
    auto restart_marker = [&]() {
      size_t m = br.marker ? br.pos : find_marker(br.pos);
      while (m + 1 < n && d[m + 1] == 0xFF) m++;
      if (m + 1 < n && d[m + 1] >= 0xD0 && d[m + 1] <= 0xD7) m += 2;
      br.pos = m;
      br.reset();
      for (auto* c : sc) c->dc_pred = 0;
      togo = restart;
    };
    if (ns == 1) {
      Component& c = *sc[0];
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++) {
          if (restart) {
            if (togo == 0) restart_marker();
            togo--;
          }
          decode_block(br, c, dc[td[0]], ac[ta[0]],
                       &c.coef[(size_t(by) * c.bw + bx) * 64]);
        }
    } else {
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          if (restart) {
            if (togo == 0) restart_marker();
            togo--;
          }
          for (int i = 0; i < ns; i++) {
            Component& c = *sc[i];
            for (int y = 0; y < c.v; y++)
              for (int x = 0; x < c.h; x++) {
                size_t by = size_t(my) * c.v + y, bx = size_t(mx) * c.h + x;
                decode_block(br, c, dc[td[i]], ac[ta[i]],
                             &c.coef[(by * c.bw + bx) * 64]);
              }
          }
        }
    }
    pos = br.marker ? br.pos : find_marker(br.pos);
  }

  void parse() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG (no SOI)");
    pos = 2;
    bool scanned = false;
    for (;;) {
      size_t m = find_marker(pos);
      if (m >= n) {
        if (scanned) return;  // no EOI: libjpeg warns and ends the image
        fail("no image data");
      }
      int marker = d[m + 1];
      pos = m + 2;
      if (marker == 0xD9) {
        if (!scanned) fail("no image data");
        return;
      }
      if (marker >= 0xD0 && marker <= 0xD7) continue;
      if (marker == 0x01) continue;
      int len = word();
      if (len < 2) fail("bad marker length");
      size_t end = pos + size_t(len) - 2;
      if (end > n) fail("truncated JPEG marker 0x%02X", marker);
      switch (marker) {
        case 0xC0:
        case 0xC1:
          read_sof(marker);
          break;
        case 0xC2:
        case 0xC6:
        case 0xCA:
        case 0xCE:
          fail("progressive JPEG (SOF%d)", marker - 0xC0);
        case 0xC3:
        case 0xC7:
        case 0xCB:
        case 0xCF:
          fail("lossless JPEG (SOF%d)", marker - 0xC0);
        case 0xC5:
          fail("hierarchical JPEG (SOF%d)", marker - 0xC0);
        case 0xC9:
          fail("arithmetic-coded JPEG (SOF%d)", marker - 0xC0);
        case 0xCC:
          fail("arithmetic-coded JPEG (DAC)");
        case 0xDE:
        case 0xDF:
          fail("hierarchical JPEG (marker 0x%02X)", marker);
        case 0xDC:
          fail("JPEG with a DNL marker");
        case 0xC4:
          read_dht(end);
          break;
        case 0xDB:
          read_dqt(end);
          break;
        case 0xDD:
          if (len != 4) fail("bad DRI");
          restart = word();
          break;
        case 0xE0:
          if (len >= 16 && !memcmp(d + pos, "JFIF\0", 5)) jfif = true;
          break;
        case 0xEE:
          if (len >= 14 && !memcmp(d + pos, "Adobe", 5)) {
            adobe = true;
            adobe_transform = d[pos + 11];
          }
          break;
        case 0xDA:
          read_sos();
          scanned = true;
          continue;
        default:
          break;
      }
      pos = end;
    }
  }

  bool rgb_coded() const {
    if (comps.size() != 3) return false;
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
  }

  // The component's samples, inverse-DCT'd: [bh*8, bw*8].
  std::vector<u8> plane(const Component& c) const {
    size_t stride = size_t(c.bw) * 8;
    std::vector<u8> out(stride * c.bh * 8);
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.q,
                   &out[size_t(by) * 8 * stride + size_t(bx) * 8], int(stride));
    return out;
  }

  // The component upsampled to the image's size [height, width].
  std::vector<u8> upsample(const Component& c) const {
    std::vector<u8> in = plane(c);
    const size_t stride = size_t(c.bw) * 8;
    const int W = width, H = height;
    std::vector<u8> out(size_t(W) * H);
    auto row = [&](int r) {  // context rows replicate the edge rows
      r = r < 0 ? 0 : (r >= c.dh ? c.dh - 1 : r);
      return &in[size_t(r) * stride];
    };
    const int fh = maxh / c.h, fv = maxv / c.v;
    if (fh == 1 && fv == 1) {
      for (int y = 0; y < H; y++) memcpy(&out[size_t(y) * W], row(y), W);
    } else if (fh == 2 && fv == 1 && c.dw > 2) {
      std::vector<u8> tmp(size_t(c.dw) * 2);
      for (int y = 0; y < H; y++) {
        const u8* ip = row(y);
        u8* o = tmp.data();
        int v = ip[0];
        *o++ = u8(v);
        *o++ = u8((v * 3 + ip[1] + 2) >> 2);
        for (int x = 1; x < c.dw - 1; x++) {
          v = ip[x] * 3;
          *o++ = u8((v + ip[x - 1] + 1) >> 2);
          *o++ = u8((v + ip[x + 1] + 2) >> 2);
        }
        v = ip[c.dw - 1];
        *o++ = u8((v * 3 + ip[c.dw - 2] + 1) >> 2);
        *o++ = u8(v);
        memcpy(&out[size_t(y) * W], tmp.data(), W);
      }
    } else if (fh == 1 && fv == 2) {
      for (int y = 0; y < H; y++) {
        int r = y >> 1, odd = y & 1;
        const u8* i0 = row(r);
        const u8* i1 = row(odd ? r + 1 : r - 1);
        int bias = odd ? 2 : 1;
        u8* o = &out[size_t(y) * W];
        for (int x = 0; x < W; x++) o[x] = u8((i0[x] * 3 + i1[x] + bias) >> 2);
      }
    } else if (fh == 2 && fv == 2 && c.dw > 2) {
      std::vector<u8> tmp(size_t(c.dw) * 2);
      for (int y = 0; y < H; y++) {
        int r = y >> 1, odd = y & 1;
        const u8* i0 = row(r);
        const u8* i1 = row(odd ? r + 1 : r - 1);
        u8* o = tmp.data();
        int thiscol = i0[0] * 3 + i1[0];
        int nextcol = i0[1] * 3 + i1[1];
        *o++ = u8((thiscol * 4 + 8) >> 4);
        *o++ = u8((thiscol * 3 + nextcol + 7) >> 4);
        int lastcol = thiscol;
        thiscol = nextcol;
        for (int x = 2; x < c.dw; x++) {
          nextcol = i0[x] * 3 + i1[x];
          *o++ = u8((thiscol * 3 + lastcol + 8) >> 4);
          *o++ = u8((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        *o++ = u8((thiscol * 3 + lastcol + 8) >> 4);
        *o++ = u8((thiscol * 4 + 7) >> 4);
        memcpy(&out[size_t(y) * W], tmp.data(), W);
      }
    } else {
      // Box replication (int_upsample, h2v1_upsample, h2v2_upsample).
      for (int y = 0; y < H; y++) {
        const u8* ip = &in[size_t(y / fv) * stride];
        u8* o = &out[size_t(y) * W];
        for (int x = 0; x < W; x++) o[x] = ip[x / fh];
      }
    }
    return out;
  }

  std::vector<u8> pixels(bool gray, int* channels) {
    for (auto& c : comps)
      if (!c.q_latched) fail("component %d has no scan", c.id);
    const size_t np = size_t(width) * height;
    if (comps.size() == 1) {
      std::vector<u8> y = upsample(comps[0]);
      *channels = gray ? 1 : 3;
      if (gray) return y;
      std::vector<u8> out(np * 3);
      for (size_t i = 0; i < np; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      return out;
    }
    const bool rgb = rgb_coded();
    if (gray && !rgb) {
      *channels = 1;
      return upsample(comps[0]);
    }
    std::vector<u8> p0 = upsample(comps[0]), p1 = upsample(comps[1]),
                    p2 = upsample(comps[2]);
    if (gray) {  // RGB-coded file read as gray: rgb_gray_convert
      *channels = 1;
      std::vector<u8> out(np);
      for (size_t i = 0; i < np; i++) out[i] = kRgbYcc.y(p0[i], p1[i], p2[i]);
      return out;
    }
    *channels = 3;
    std::vector<u8> out(np * 3);
    for (size_t i = 0; i < np; i++) {
      if (rgb) {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
        continue;
      }
      int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i] = clamp255(y + kYccRgb.cr_r[cr]);
      out[3 * i + 1] =
          clamp255(y + int((kYccRgb.cb_g[cb] + kYccRgb.cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp255(y + kYccRgb.cb_b[cb]);
    }
    return out;
  }
};

// ============================================================ encoder ==

const int kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 tables: bits[1..16], then the values.
const u8 kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const u8 kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const u8 kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const u8 kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const u8 kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const u8 kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const u8 kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  const u8* bits;
  const u8* vals;
  int nvals;
  u32 code[256];
  u8 size[256];
  void derive() {
    memset(size, 0, sizeof size);
    u32 c = 0;
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l]; i++, p++) {
        code[vals[p]] = c++;
        size[vals[p]] = u8(l);
      }
      c <<= 1;
    }
  }
};

// jcdctmgr.c's reciprocal quantizer with 16-bit DCTELEM.
struct Divisor {
  u16 recip, corr;
  int shift;
};

Divisor reciprocal(u16 divisor) {
  if (divisor == 1) return {1, 0, -16};
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int r = 16 + b;
  u32 fq = (u32(1) << r) / divisor;
  u32 fr = (u32(1) << r) % divisor;
  u16 c = u16(divisor / 2);
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2u) {
    c++;
  } else {
    fq++;
  }
  return {u16(fq), c, r - 16};
}

struct Writer {
  std::vector<u8> out;
  u64 acc = 0;  // bit buffer, msb-first in the low `cnt` bits
  int cnt = 0;
  void b(int v) { out.push_back(u8(v)); }
  void w(int v) {
    b(v >> 8);
    b(v & 0xFF);
  }
  void bits(u32 code, int size) {
    acc = (acc << size) | (code & ((u32(1) << size) - 1));
    cnt += size;
    while (cnt >= 8) {
      u8 c = u8(acc >> (cnt - 8));
      out.push_back(c);
      if (c == 0xFF) out.push_back(0);
      cnt -= 8;
    }
  }
  void flush() {
    if (cnt) bits(0x7F, 7);
    cnt = 0;
    acc = 0;
  }
};

inline int nbits(int v) { return v ? 32 - __builtin_clz(u32(v)) : 0; }

void encode_block(Writer& wr, const int16_t* blk, int& last_dc,
                  const EncTable& dct, const EncTable& act) {
  int temp = blk[0] - last_dc;
  last_dc = blk[0];
  int temp2 = temp;
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nb = nbits(temp);
  wr.bits(dct.code[nb], dct.size[nb]);
  if (nb) wr.bits(u32(temp2), nb);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    temp = blk[kNatural[k]];
    if (temp == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      wr.bits(act.code[0xF0], act.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nb = nbits(temp);
    int sym = (r << 4) + nb;
    wr.bits(act.code[sym], act.size[sym]);
    wr.bits(u32(temp2), nb);
    r = 0;
  }
  if (r > 0) wr.bits(act.code[0], act.size[0]);
}

// One component's samples, padded as libjpeg pads them.
struct Plane {
  int w, h;  // padded size
  std::vector<u8> p;
  u8 at(int y, int x) const { return p[size_t(y) * w + x]; }
};

// [H, W] samples -> rows and columns replicated out to [ph, pw].
Plane pad_plane(const u8* src, int H, int W, int ph, int pw) {
  Plane pl{pw, ph, std::vector<u8>(size_t(pw) * ph)};
  for (int y = 0; y < ph; y++) {
    const u8* s = src + size_t(y < H ? y : H - 1) * W;
    u8* o = &pl.p[size_t(y) * pw];
    memcpy(o, s, W);
    for (int x = W; x < pw; x++) o[x] = s[W - 1];
  }
  return pl;
}

void forward_block(const Plane& pl, int by, int bx, const Divisor* div,
                   int16_t* coef) {
  int16_t ws[64];
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++)
      ws[8 * y + x] = int16_t(int(pl.at(by * 8 + y, bx * 8 + x)) - 128);
  fdct_islow(ws);
  for (int i = 0; i < 64; i++) {
    int temp = ws[i];
    const Divisor& d = div[i];
    bool neg = temp < 0;
    if (neg) temp = -temp;
    u32 product = u32(temp + d.corr) * d.recip;
    product >>= d.shift + 16;
    temp = int16_t(product);
    coef[i] = int16_t(neg ? -temp : temp);
  }
}

// cv2.IMWRITE_JPEG_QUALITY's default; jpeg_quality_scaling gives the
// tables' percentage as 200 - 2 * quality from 50 up.
constexpr int kQuality = 95;

std::vector<u8> encode(const u8* pix, int H, int W, int C) {
  if (H < 1 || W < 1 || H > 65500 || W > 65500) fail("bad image size");
  if (C != 1 && C != 3) fail("%d channels (1 or 3 expected)", C);
  const int scale = 200 - kQuality * 2;
  u16 qtab[2][64];
  const int* base[2] = {kStdLuma, kStdChroma};
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) {
      long v = (long(base[t][i]) * scale + 50) / 100;
      if (v <= 0) v = 1;
      if (v > 32767) v = 32767;
      if (v > 255) v = 255;  // force_baseline
      qtab[t][i] = u16(v);
    }
  Divisor div[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) div[t][i] = reciprocal(u16(qtab[t][i] << 3));

  EncTable dct[2] = {{kDcLumaBits, kDcVals, 12, {}, {}},
                     {kDcChromaBits, kDcVals, 12, {}, {}}};
  EncTable act[2] = {{kAcLumaBits, kAcLumaVals, 162, {}, {}},
                     {kAcChromaBits, kAcChromaVals, 162, {}, {}}};
  for (int t = 0; t < 2; t++) {
    dct[t].derive();
    act[t].derive();
  }

  Writer wr;
  wr.out.reserve(size_t(H) * W * C / 2 + 1024);
  wr.w(0xFFD8);
  // JFIF APP0: version 1.01, aspect ratio 1:1, no thumbnail.
  wr.w(0xFFE0);
  wr.w(16);
  for (char ch : {'J', 'F', 'I', 'F', '\0'}) wr.b(ch);
  wr.b(1);
  wr.b(1);
  wr.b(0);
  wr.w(1);
  wr.w(1);
  wr.b(0);
  wr.b(0);
  const int ntab = C == 3 ? 2 : 1;
  for (int t = 0; t < ntab; t++) {
    wr.w(0xFFDB);
    wr.w(67);
    wr.b(t);
    for (int i = 0; i < 64; i++) wr.b(qtab[t][kNatural[i]]);
  }
  wr.w(0xFFC0);
  wr.w(8 + 3 * C);
  wr.b(8);
  wr.w(H);
  wr.w(W);
  wr.b(C);
  if (C == 3) {
    const int hv[3] = {0x22, 0x11, 0x11};
    for (int c = 0; c < 3; c++) {
      wr.b(c + 1);
      wr.b(hv[c]);
      wr.b(c ? 1 : 0);
    }
  } else {
    wr.b(1);
    wr.b(0x11);
    wr.b(0);
  }
  for (int t = 0; t < ntab; t++) {
    for (int cls = 0; cls < 2; cls++) {
      const EncTable& e = cls ? act[t] : dct[t];
      wr.w(0xFFC4);
      wr.w(2 + 1 + 16 + e.nvals);
      wr.b((cls << 4) | t);
      for (int l = 1; l <= 16; l++) wr.b(e.bits[l]);
      for (int i = 0; i < e.nvals; i++) wr.b(e.vals[i]);
    }
  }
  wr.w(0xFFDA);
  wr.w(6 + 2 * C);
  wr.b(C);
  for (int c = 0; c < C; c++) {
    wr.b(c + 1);
    wr.b(c ? 0x11 : 0x00);
  }
  wr.b(0);
  wr.b(63);
  wr.b(0);

  int16_t blk[64];
  if (C == 1) {
    const int wib = (W + 7) / 8, hib = (H + 7) / 8;
    Plane y = pad_plane(pix, H, W, hib * 8, wib * 8);
    int last = 0;
    for (int by = 0; by < hib; by++)
      for (int bx = 0; bx < wib; bx++) {
        forward_block(y, by, bx, div[0], blk);
        encode_block(wr, blk, last, dct[0], act[0]);
      }
  } else {
    const size_t np = size_t(H) * W;
    std::vector<u8> Y(np), Cb(np), Cr(np);
    for (size_t i = 0; i < np; i++) {
      int r = pix[3 * i], g = pix[3 * i + 1], bl = pix[3 * i + 2];
      Y[i] = kRgbYcc.y(r, g, bl);
      Cb[i] = kRgbYcc.cb(r, g, bl);
      Cr[i] = kRgbYcc.cr(r, g, bl);
    }
    const int mcux = (W + 15) / 16, mcuy = (H + 15) / 16;
    const int wib_y = (W + 7) / 8, hib_y = (H + 7) / 8;
    const int cw = (W + 1) / 2, ch = (H + 1) / 2;
    const int wib_c = (cw + 7) / 8;
    // Luma: the color buffer's rows to a multiple of 2, columns to its
    // blocks, then the iMCU rows: all by edge replication.
    Plane y = pad_plane(Y.data(), H, W, mcuy * 16, wib_y * 8);
    // Chroma: h2v2 downsampling of the replicated [2*ceil(H/2),
    // 16*wib_c] buffer, rows then padded to the iMCU height.
    Plane c[2];
    const std::vector<u8>* src[2] = {&Cb, &Cr};
    for (int k = 0; k < 2; k++) {
      Plane full = pad_plane(src[k]->data(), H, W, 2 * ch, 16 * wib_c);
      std::vector<u8> ds(size_t(ch) * wib_c * 8);
      for (int r = 0; r < ch; r++) {
        int bias = 1;
        for (int x = 0; x < wib_c * 8; x++) {
          int s = full.at(2 * r, 2 * x) + full.at(2 * r, 2 * x + 1) +
                  full.at(2 * r + 1, 2 * x) + full.at(2 * r + 1, 2 * x + 1);
          ds[size_t(r) * wib_c * 8 + x] = u8((s + bias) >> 2);
          bias ^= 3;
        }
      }
      c[k] = pad_plane(ds.data(), ch, wib_c * 8, mcuy * 8, wib_c * 8);
    }
    int last[3] = {0, 0, 0};
    int16_t ybl[4][64];
    for (int my = 0; my < mcuy; my++)
      for (int mx = 0; mx < mcux; mx++) {
        // Blocks past the component's last column or row are dummies:
        // zero, with the DC of the block before them in the MCU.
        for (int yy = 0; yy < 2; yy++)
          for (int xx = 0; xx < 2; xx++) {
            int i = 2 * yy + xx, by = 2 * my + yy, bx = 2 * mx + xx;
            if (by < hib_y && bx < wib_y) {
              forward_block(y, by, bx, div[0], ybl[i]);
            } else {
              memset(ybl[i], 0, sizeof ybl[i]);
              ybl[i][0] = ybl[i - 1][0];
            }
          }
        for (int i = 0; i < 4; i++)
          encode_block(wr, ybl[i], last[0], dct[0], act[0]);
        for (int k = 0; k < 2; k++) {
          forward_block(c[k], my, mx, div[1], blk);
          encode_block(wr, blk, last[k + 1], dct[1], act[1]);
        }
      }
  }
  wr.flush();
  wr.w(0xFFD9);
  return wr.out;
}

void copy_err(const char* msg, char* err, size_t cap) {
  if (err && cap) {
    snprintf(err, cap, "%s", msg);
  }
}

}  // namespace

extern "C" {

int oetr_jpeg_decode(const uint8_t* src, size_t n, int gray, uint8_t** out,
                     int* h, int* w, int* c, char* err, size_t err_cap) {
  *out = nullptr;
  try {
    Decoder dec;
    dec.d = src;
    dec.n = n;
    dec.parse();
    std::vector<u8> px = dec.pixels(gray != 0, c);
    uint8_t* buf = static_cast<uint8_t*>(malloc(px.size()));
    if (!buf) fail("out of memory");
    memcpy(buf, px.data(), px.size());
    *out = buf;
    *h = dec.height;
    *w = dec.width;
    return 0;
  } catch (const std::exception& e) {
    copy_err(e.what(), err, err_cap);
    return 1;
  }
}

int oetr_jpeg_encode(const uint8_t* pix, int h, int w, int c, uint8_t** out,
                     size_t* n, char* err, size_t err_cap) {
  *out = nullptr;
  try {
    std::vector<u8> bytes = encode(pix, h, w, c);
    uint8_t* buf = static_cast<uint8_t*>(malloc(bytes.size()));
    if (!buf) fail("out of memory");
    memcpy(buf, bytes.data(), bytes.size());
    *out = buf;
    *n = bytes.size();
    return 0;
  } catch (const std::exception& e) {
    copy_err(e.what(), err, err_cap);
    return 1;
  }
}

void oetr_jpeg_free(uint8_t* p) { free(p); }

}  // extern "C"
