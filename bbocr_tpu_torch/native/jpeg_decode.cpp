// Baseline JPEG decoder, bit-exact with libjpeg-turbo's default
// decompression to RGB (the one Pillow runs for Image.open(...).convert("RGB")).
//
// Supported: SOF0/SOF1 (Huffman, sequential, 8-bit samples), 1 or 3
// components, per-component sampling whose expansion to the largest factor
// is 1x1, 2x1 or 2x2, interleaved or one-component scans, DRI/RSTn restart
// markers, 8- and 16-bit quantisation tables. Everything else (progressive,
// arithmetic coding, lossless, 12-bit, CMYK, Adobe APP14, RGB component ids,
// DNL heights) is refused as unsupported.
//
// What libjpeg-turbo does, and this file does the same way:
//   jdhuff.c   canonical Huffman tables, HUFF_EXTEND, DC prediction reset at
//              each restart, zero bits after a marker, 0xFF 0x00 stuffing;
//   jidctint.c jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2, the all-zero
//              column shortcut of pass 1, range limiting through the
//              10-bit wrap of IDCT_range_limit;
//   jdsample.c h2v1/h2v2 fancy upsampling (3:1 triangle, +1/+2 and +8/+7
//              bias alternation, special first and last columns) for
//              downsampled widths over 2, else pixel replication; the
//              context rows above the first and below the last real row
//              repeat that row (jdmainct.c);
//   jdcolor.c  ycc_rgb_convert with SCALEBITS 16 tables.
//
// C interface, bound with ctypes: bbocr_jpeg_header, bbocr_jpeg_decode.
// Both return 0, 1 (corrupt data) or 2 (unsupported variant) and write a
// message into ``err``.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kCorrupt = 1;
constexpr int kUnsupported = 2;

struct Error {
  int code;
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw Error{kCorrupt, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw Error{kUnsupported, m}; }

// jutils.c jpeg_natural_order, with the 16 extra entries that keep a
// corrupt run length inside the block.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  // (length << 8) | value for codes of at most kLookBits bits, else 0
  uint16_t look[1 << kLookBits] = {};

  void build(const uint8_t counts[17], const uint8_t* symbols, int nsym) {
    std::memcpy(vals, symbols, nsym);
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < counts[l]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) corrupt("bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (counts[l]) {
        valoffset[l] = p - huffcode[p];
        p += counts[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 0; i < counts[l]; i++, p++) {
        int base = huffcode[p] << (kLookBits - l);
        for (int j = 0; j < (1 << (kLookBits - l)); j++)
          look[base + j] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
    defined = true;
  }
};

// Entropy-coded data reader (jdhuff.c fill_bit_buffer semantics).
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  const uint8_t* marker_at = nullptr;  // the 0xFF of the marker that ended the data

  void fill() {
    while (bits <= 56) {
      uint32_t c = 0;
      if (!marker_at && p < end) {
        c = *p;
        if (c == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) q++;  // padding FFs before a marker
          if (q < end && *q == 0x00) {
            p = q + 1;  // stuffed zero: a literal 0xFF
          } else {
            marker_at = q - 1;
            c = 0;
          }
        } else {
          p++;
        }
      }
      // past a marker (or the end of the buffer) zeros are fed in
      buf |= static_cast<uint64_t>(c) << (56 - bits);
      bits += 8;
    }
  }
  int get(int n) {
    if (n == 0) return 0;
    if (bits < n) fill();
    int v = static_cast<int>(buf >> (64 - n));
    buf <<= n;
    bits -= n;
    return v;
  }
  int decode(const HuffTable& t) {
    if (bits < 16) fill();
    int look = t.look[buf >> (64 - kLookBits)];
    if (look) {
      int l = look >> 8;
      buf <<= l;
      bits -= l;
      return look & 0xFF;
    }
    int code = get(1);
    int l = 1;
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      if (++l > 16) return 0;  // libjpeg: corrupt data warning, symbol 0
    }
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  // Where parsing resumes after the entropy-coded segment.
  const uint8_t* next_marker() {
    if (marker_at) return marker_at;
    const uint8_t* q = p;
    while (q + 1 < end && !(q[0] == 0xFF && q[1] != 0x00 && q[1] != 0xFF)) q++;
    return q;
  }
  // Skip to the restart marker after the current interval; libjpeg's
  // read_restart_marker, without its resynchronisation of a corrupt stream.
  void restart(int expected) {
    const uint8_t* q = next_marker();
    while (q + 1 < end && q[1] == 0xFF) q++;
    if (q + 1 >= end || q[1] != 0xD0 + expected) corrupt("missing or out-of-order restart marker");
    p = q + 2;
    buf = 0;
    bits = 0;
    marker_at = nullptr;
  }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }  // HUFF_EXTEND

// jidctint.c
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

// IDCT_range_limit: the low 10 bits read as a signed value, plus 128, clamped.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int v = 0; v < 1024; v++) {
      int s = v < 512 ? v : v - 1024;
      s += 128;
      t[v] = static_cast<uint8_t>(s < 0 ? 0 : s > 255 ? 255 : s);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int col = 0; col < 8; col++) {
    const int16_t* in = coef + col;
    const uint16_t* qt = q + col;
    int* w = ws + col;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 && in[48] == 0 &&
        in[56] == 0) {
      int dc = static_cast<int>(static_cast<int64_t>(in[0]) * qt[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = static_cast<int64_t>(in[16]) * qt[16];
    int64_t z3 = static_cast<int64_t>(in[48]) * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = static_cast<int64_t>(in[0]) * qt[0];
    z3 = static_cast<int64_t>(in[32]) * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(in[56]) * qt[56];
    tmp1 = static_cast<int64_t>(in[40]) * qt[40];
    tmp2 = static_cast<int64_t>(in[24]) * qt[24];
    tmp3 = static_cast<int64_t>(in[8]) * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    constexpr int n = kConstBits - kPass1Bits;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, n));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, n));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, n));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, n));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, n));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, n));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, n));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  for (int row = 0; row < 8; row++) {
    const int* w = ws + 8 * row;
    uint8_t* o = out + row * stride;
    constexpr int n = kConstBits + kPass1Bits + 3;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
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

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int width = 0, height = 0;  // downsampled size (jdinput.c)
  int stride = 0, rows = 0;   // plane size, MCU-padded
  bool latched = false;
  uint16_t q[64] = {};
  int dc_pred = 0;
  std::vector<uint8_t> plane;
};

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  bool saw_sof = false, saw_jfif = false, done = false;
  Component comp[4];
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  HuffTable dc[4], ac[4];

  Decoder(const uint8_t* d, int64_t n) : data(d), end(d + n) {}

  int u16(const uint8_t* p) {
    if (p + 2 > end) corrupt("truncated segment");
    return (p[0] << 8) | p[1];
  }

  void parse(bool header_only) {
    const uint8_t* p = data;
    if (end - p < 2 || p[0] != 0xFF || p[1] != 0xD8) corrupt("not a JPEG file (no SOI marker)");
    p += 2;
    for (;;) {
      while (p < end && *p != 0xFF) p++;  // garbage between markers
      while (p < end && *p == 0xFF) p++;
      if (p >= end) corrupt("no EOI marker before the end of the data");
      int m = *p++;
      if (m == 0xD9) break;                      // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;      // stray RSTn
      if (m == 0x01) continue;                   // TEM
      int len = u16(p);
      if (len < 2 || p + len > end) corrupt("truncated segment");
      const uint8_t* seg = p + 2;
      const uint8_t* seg_end = p + len;
      if (m == 0xC0 || m == 0xC1) {
        sof(seg, seg_end);
        if (header_only) return;
      } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
        unsupported("progressive JPEG");
      } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
        unsupported("lossless JPEG");
      } else if (m >= 0xC9 && m <= 0xCF && m != 0xCC) {
        unsupported("arithmetic-coded JPEG");
      } else if (m == 0xC5) {
        unsupported("hierarchical JPEG");
      } else if (m == 0xC4) {
        dht(seg, seg_end);
      } else if (m == 0xCC) {
        unsupported("arithmetic-coded JPEG");
      } else if (m == 0xDB) {
        dqt(seg, seg_end);
      } else if (m == 0xDD) {
        if (len != 4) corrupt("bad DRI segment");
        restart_interval = u16(seg);
      } else if (m == 0xDC) {
        unsupported("JPEG with a DNL marker");
      } else if (m == 0xE0) {
        if (seg_end - seg >= 5 && std::memcmp(seg, "JFIF\0", 5) == 0) saw_jfif = true;
      } else if (m == 0xEE) {
        if (seg_end - seg >= 5 && std::memcmp(seg, "Adobe", 5) == 0) unsupported("JPEG with an Adobe APP14 transform marker");
      } else if (m == 0xDA) {
        if (!saw_sof) corrupt("SOS before SOF");
        p = scan(seg, seg_end);
        continue;
      }
      p = seg_end;
    }
    if (!saw_sof) corrupt("no SOF marker");
  }

  void sof(const uint8_t* s, const uint8_t* e) {
    if (saw_sof) corrupt("second SOF marker");
    if (e - s < 6) corrupt("bad SOF segment");
    if (s[0] != 8) unsupported(std::to_string(s[0]) + "-bit JPEG");
    height = u16(s + 1);
    width = u16(s + 3);
    ncomp = s[5];
    if (height == 0) unsupported("JPEG with a DNL marker");
    if (width == 0) corrupt("zero image width");
    if (ncomp == 4) unsupported("CMYK JPEG");
    if (ncomp != 1 && ncomp != 3) unsupported(std::to_string(ncomp) + "-component JPEG");
    if (e - s < 6 + 3 * ncomp) corrupt("bad SOF segment");
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) corrupt("bad component in SOF");
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    if (ncomp == 3 && !saw_jfif && comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B')
      unsupported("RGB-coded JPEG");
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (ncomp == 1) c.h = c.v = hmax = vmax = 1;  // one component: its MCU is one block
      int hx = hmax / c.h, vx = vmax / c.v;
      if (hmax % c.h || vmax % c.v || vx > hx || hx > 2 || vx > 2)
        unsupported("JPEG sampling factors other than 1x1, 2x1 or 2x2 per component");
      c.width = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.height = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      c.stride = (ncomp == 1 ? (width + 7) / 8 : mcus_x * c.h) * 8;
      c.rows = (ncomp == 1 ? (height + 7) / 8 : mcus_y * c.v) * 8;
    }
    if (ncomp == 1) {
      mcus_x = (width + 7) / 8;
      mcus_y = (height + 7) / 8;
    }
    saw_sof = true;
  }

  void dht(const uint8_t* s, const uint8_t* e) {
    while (s < e) {
      if (e - s < 17) corrupt("bad DHT segment");
      int tc = s[0] >> 4, th = s[0] & 15;
      if (tc > 1 || th > 3) corrupt("bad DHT segment");
      uint8_t counts[17] = {0};
      int n = 0;
      for (int l = 1; l <= 16; l++) n += counts[l] = s[l];
      if (n > 256 || e - s < 17 + n) corrupt("bad DHT segment");
      for (int i = 0; i < n && tc == 0; i++)
        if (s[17 + i] > 15) corrupt("bad DC Huffman table");
      (tc ? ac : dc)[th].build(counts, s + 17, n);
      s += 17 + n;
    }
  }

  void dqt(const uint8_t* s, const uint8_t* e) {
    while (s < e) {
      int pq = s[0] >> 4, tq = s[0] & 15;
      if (pq > 1 || tq > 3) corrupt("bad DQT segment");
      int n = pq ? 128 : 64;
      if (e - s < 1 + n) corrupt("bad DQT segment");
      for (int i = 0; i < 64; i++)
        qt[tq][kNatural[i]] = static_cast<uint16_t>(pq ? (s[1 + 2 * i] << 8) | s[2 + 2 * i] : s[1 + i]);
      qt_defined[tq] = true;
      s += 1 + n;
    }
  }

  void decode_block(BitReader& br, Component& c, uint8_t* out) {
    int16_t coef[64] = {0};
    const HuffTable& dct = dc[c.dc_tbl];
    const HuffTable& act = ac[c.ac_tbl];
    int s = br.decode(dct);
    if (s) s = extend(br.get(s), s);
    c.dc_pred += s;
    coef[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    idct_islow(coef, c.q, out, c.stride);
  }

  const uint8_t* scan(const uint8_t* s, const uint8_t* e) {
    int ns = s[0];
    if (ns < 1 || ns > ncomp || e - s != 4 + 2 * ns) corrupt("bad SOS segment");
    Component* sc[4];
    for (int i = 0; i < ns; i++) {
      int id = s[1 + 2 * i], j = 0;
      while (j < ncomp && comp[j].id != id) j++;
      if (j == ncomp) corrupt("SOS names an unknown component");
      sc[i] = &comp[j];
      sc[i]->dc_tbl = s[2 + 2 * i] >> 4;
      sc[i]->ac_tbl = s[2 + 2 * i] & 15;
      if (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3 || !dc[sc[i]->dc_tbl].defined || !ac[sc[i]->ac_tbl].defined)
        corrupt("SOS uses an undefined Huffman table");
    }
    const uint8_t* t = s + 1 + 2 * ns;
    if (t[0] != 0 || t[1] != 63 || t[2] != 0) unsupported("progressive JPEG");
    for (int i = 0; i < ns; i++) {
      Component& c = *sc[i];
      if (!c.latched) {  // jdinput.c latch_quant_tables
        if (!qt_defined[c.tq]) corrupt("component uses an undefined quantisation table");
        std::memcpy(c.q, qt[c.tq], sizeof(c.q));
        c.plane.assign(static_cast<size_t>(c.stride) * c.rows, 0);
        c.latched = true;
      }
      c.dc_pred = 0;
    }
    BitReader br{e, end};
    int nx, ny;
    if (ns == 1) {  // non-interleaved: one block per MCU over the component's own blocks
      nx = (sc[0]->width + 7) / 8;
      ny = (sc[0]->height + 7) / 8;
    } else {
      nx = mcus_x;
      ny = mcus_y;
    }
    int64_t total = static_cast<int64_t>(nx) * ny, left = restart_interval;
    int next_rst = 0;
    for (int64_t m = 0; m < total; m++) {
      if (restart_interval) {
        if (left == 0) {
          br.restart(next_rst);
          next_rst = (next_rst + 1) & 7;
          for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
          left = restart_interval;
        }
        left--;
      }
      int mx = static_cast<int>(m % nx), my = static_cast<int>(m / nx);
      if (ns == 1) {
        Component& c = *sc[0];
        decode_block(br, c, c.plane.data() + static_cast<size_t>(my) * 8 * c.stride + mx * 8);
      } else {
        for (int i = 0; i < ns; i++) {
          Component& c = *sc[i];
          for (int by = 0; by < c.v; by++)
            for (int bx = 0; bx < c.h; bx++)
              decode_block(br, c, c.plane.data() + static_cast<size_t>(my * c.v + by) * 8 * c.stride +
                                      (mx * c.h + bx) * 8);
        }
      }
    }
    return br.next_marker();
  }

  // One component at full size, width x height (jdsample.c).
  std::vector<uint8_t> upsample(const Component& c) {
    int hx = hmax / c.h, vx = vmax / c.v;
    std::vector<uint8_t> out(static_cast<size_t>(width) * height);
    const int dw = c.width, dh = c.height;
    auto row = [&](int r) { return c.plane.data() + static_cast<size_t>(r < 0 ? 0 : r >= dh ? dh - 1 : r) * c.stride; };
    std::vector<uint8_t> line(static_cast<size_t>(2 * dw + 2));
    for (int y = 0; y < height; y++) {
      int r = y / vx;
      uint8_t* o = out.data() + static_cast<size_t>(y) * width;
      if (hx == 1) {  // fullsize (vx is 1 too: 1x2 is refused)
        std::memcpy(o, row(r), width);
        continue;
      }
      const uint8_t* in0 = row(r);
      if (dw <= 2) {  // h2v1_upsample / h2v2_upsample: replication
        for (int x = 0; x < width; x++) o[x] = in0[x / 2];
        continue;
      }
      uint8_t* l = line.data();
      if (vx == 1) {  // h2v1_fancy_upsample
        l[0] = in0[0];
        l[1] = static_cast<uint8_t>((in0[0] * 3 + in0[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; x++) {
          int v = in0[x] * 3;
          l[2 * x] = static_cast<uint8_t>((v + in0[x - 1] + 1) >> 2);
          l[2 * x + 1] = static_cast<uint8_t>((v + in0[x + 1] + 2) >> 2);
        }
        l[2 * dw - 2] = static_cast<uint8_t>((in0[dw - 1] * 3 + in0[dw - 2] + 1) >> 2);
        l[2 * dw - 1] = in0[dw - 1];
      } else {  // h2v2_fancy_upsample: even rows lean on the row above, odd ones on the row below
        const uint8_t* in1 = row((y & 1) ? r + 1 : r - 1);
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        l[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
        l[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 1; x < dw - 1; x++) {
          next_sum = in0[x + 1] * 3 + in1[x + 1];
          l[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          l[2 * x + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        l[2 * dw - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        l[2 * dw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
      }
      std::memcpy(o, l, width);
    }
    return out;
  }

  void finish(uint8_t* out) {
    for (int i = 0; i < ncomp; i++)
      if (!comp[i].latched) corrupt("a component has no scan");
    if (ncomp == 1) {
      const Component& c = comp[0];
      for (int y = 0; y < height; y++) std::memcpy(out + static_cast<size_t>(y) * width, c.plane.data() + static_cast<size_t>(y) * c.stride, width);
      return;
    }
    std::vector<uint8_t> yy = upsample(comp[0]), cb = upsample(comp[1]), cr = upsample(comp[2]);
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t{1} << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1 << kScale) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
    const size_t n = static_cast<size_t>(width) * height;
    for (size_t i = 0; i < n; i++) {
      int y = yy[i], b = cb[i], r = cr[i];
      out[3 * i] = clamp(y + cr_r[r]);
      out[3 * i + 1] = clamp(y + static_cast<int>((cb_g[b] + cr_g[r]) >> kScale));
      out[3 * i + 2] = clamp(y + cb_b[b]);
    }
  }
};

int report(const Error& e, char* err, int32_t err_len) {
  if (err && err_len > 0) std::snprintf(err, static_cast<size_t>(err_len), "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

extern "C" {

// dims: height, width, components (1 or 3).
int bbocr_jpeg_header(const uint8_t* data, int64_t size, int32_t* dims, char* err, int32_t err_len) {
  try {
    Decoder d(data, size);
    d.parse(true);
    if (!d.saw_sof) corrupt("no SOF marker");
    dims[0] = d.height;
    dims[1] = d.width;
    dims[2] = d.ncomp;
    return 0;
  } catch (const Error& e) {
    return report(e, err, err_len);
  }
}

// out: height * width * components bytes, rows of interleaved RGB (or gray).
int bbocr_jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t out_size, char* err, int32_t err_len) {
  try {
    Decoder d(data, size);
    d.parse(false);
    if (out_size != static_cast<int64_t>(d.width) * d.height * d.ncomp) corrupt("output buffer has the wrong size");
    d.finish(out);
    return 0;
  } catch (const Error& e) {
    return report(e, err, err_len);
  } catch (const std::bad_alloc&) {
    return report(Error{kCorrupt, "out of memory"}, err, err_len);
  }
}

}  // extern "C"
