// Baseline JPEG encoder, byte-exact with the libjpeg-turbo that Pillow runs
// for Image.fromarray(rgb).save(buf, "JPEG", quality=q): JFIF 1.01 header
// (no density unit, 1:1), the two standard quantisation tables scaled by
// quality, YCbCr 4:2:0, the four standard Huffman tables, one interleaved
// scan.
//
// What libjpeg-turbo does, and this file does the same way:
//   jcparam.c  jpeg_quality_scaling (5000 / q below 50, 200 - 2 q above)
//              and jpeg_add_quant_table with force_baseline (1..255);
//   jccolor.c  rgb_ycc_convert with SCALEBITS 16 tables, ONE_HALF rounding
//              for Y and ONE_HALF - 1 plus the CENTERJSAMPLE offset for Cb
//              and Cr;
//   jcprepct.c the last row repeated to fill the last row group (2 rows),
//              and the last downsampled row repeated to a whole iMCU row;
//   jcsample.c fullsize_downsample for Y and h2v2_downsample for Cb and Cr
//              (bias 1, 2, 1, 2, ... along each output row), both after
//              repeating the last column to whole blocks (Y) or whole
//              2x2-subsampled blocks (Cb, Cr);
//   jfdctint.c jpeg_fdct_islow: CONST_BITS 13, PASS1_BITS 2, output
//              scaled up by 8;
//   jcdctmgr.c quantisation by the reciprocal of (quantval << 3) with the
//              16-bit DCTELEM of a SIMD build (compute_reciprocal);
//   jccoefct.c dummy blocks right of and below the image: all AC zero, DC
//              copied from the block before them in the MCU;
//   jchuff.c   DC differences and AC run lengths with the standard tables,
//              0xFF 0x00 stuffing, the last byte padded with one bits.
//
// C interface, bound with ctypes: bbocr_jpeg_encode. It returns the number
// of bytes written, or -1 when ``cap`` is too small.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jcparam.c std_luminance_quant_tbl / std_chrominance_quant_tbl (natural order).
const int kStdQuant[2][64] = {
    {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
     14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
     18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

// jstdhuff.c: counts of codes of each length 1..16, then the symbols.
const uint8_t kBitsDcLum[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kBitsDcChr[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kValDc[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kBitsAcLum[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kValAcLum[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kBitsAcChr[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kValAcChr[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffSpec {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
};

const HuffSpec kHuff[4] = {  // DC 0, AC 0, DC 1, AC 1: the order jcmarker.c writes them
    {kBitsDcLum, kValDc, 12}, {kBitsAcLum, kValAcLum, 162},
    {kBitsDcChr, kValDc, 12}, {kBitsAcChr, kValAcChr, 162}};

struct HuffCodes {
  uint32_t code[256] = {};
  int size[256] = {};
};

// jchuff.c jpeg_make_c_derived_tbl: canonical codes.
HuffCodes derive(const HuffSpec& spec) {
  HuffCodes t;
  int sizes[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < spec.bits[l - 1]; i++) sizes[p++] = l;
  sizes[p] = 0;
  uint32_t code = 0;
  int si = sizes[0];
  p = 0;
  while (sizes[p]) {
    while (sizes[p] == si) {
      t.code[spec.vals[p]] = code++;
      t.size[spec.vals[p]] = si;
      p++;
    }
    code <<= 1;
    si++;
  }
  return t;
}

// jcparam.c: quality -> percentage scale -> baseline table.
void scaled_table(int which, int quality, int out[64]) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long temp = ((long)kStdQuant[which][i] * scale + 50L) / 100L;
    if (temp <= 0L) temp = 1L;
    if (temp > 32767L) temp = 32767L;
    if (temp > 255L) temp = 255L;  // force_baseline
    out[i] = (int)temp;
  }
}

// jcdctmgr.c compute_reciprocal with a 16-bit DCTELEM.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint64_t fq = (1ULL << r) / divisor;
  uint64_t fr = (1ULL << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2U) {
    c++;
  } else {
    fq++;
  }
  return Divisor{(uint32_t)fq, c, r};
}

// jfdctint.c jpeg_fdct_islow on level-shifted samples, in place.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

void fdct_islow(int32_t* data) {
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass == 0 ? 1 : 8;      // along a row, then down a column
    const int stride = pass == 0 ? 8 : 1;    // to the next row, then the next column
    const int even_shift = pass == 0 ? 0 : kPass1Bits;
    const int odd_shift = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
    for (int line = 0; line < 8; line++) {
      int32_t* d = data + line * stride;
      int32_t tmp0 = d[0 * step] + d[7 * step], tmp7 = d[0 * step] - d[7 * step];
      int32_t tmp1 = d[1 * step] + d[6 * step], tmp6 = d[1 * step] - d[6 * step];
      int32_t tmp2 = d[2 * step] + d[5 * step], tmp5 = d[2 * step] - d[5 * step];
      int32_t tmp3 = d[3 * step] + d[4 * step], tmp4 = d[3 * step] - d[4 * step];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        d[0] = (tmp10 + tmp11) << kPass1Bits;
        d[4] = (tmp10 - tmp11) << kPass1Bits;
      } else {
        d[0 * step] = descale(tmp10 + tmp11, even_shift);
        d[4 * step] = descale(tmp10 - tmp11, even_shift);
      }
      int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      d[2 * step] = descale(z1 + tmp13 * FIX_0_765366865, odd_shift);
      d[6 * step] = descale(z1 + tmp12 * (-FIX_1_847759065), odd_shift);
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
      d[7 * step] = descale(tmp4 + z1 + z3, odd_shift);
      d[5 * step] = descale(tmp5 + z2 + z4, odd_shift);
      d[3 * step] = descale(tmp6 + z2 + z3, odd_shift);
      d[1 * step] = descale(tmp7 + z1 + z4, odd_shift);
    }
  }
}

struct Writer {
  uint8_t* out;
  int64_t cap, pos = 0;
  bool overflow = false;
  uint64_t acc = 0;  // pending bits, most significant first
  int nacc = 0;

  void byte(uint8_t b) {
    if (pos < cap) out[pos] = b; else overflow = true;
    pos++;
  }
  void u16(int v) {
    byte((uint8_t)(v >> 8));
    byte((uint8_t)v);
  }
  void bits(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1u));
    nacc += size;
    while (nacc >= 8) {
      uint8_t b = (uint8_t)(acc >> (nacc - 8));
      byte(b);
      if (b == 0xFF) byte(0);
      nacc -= 8;
    }
  }
  void flush() {  // pad the last byte with one bits, drop the rest
    bits(0x7F, 7);
    acc = 0;
    nacc = 0;
  }
};

// One component's samples, padded to its blocks, row major.
struct Plane {
  int w, h;  // padded width and height in samples
  std::vector<uint8_t> px;
};

}  // namespace

extern "C" {

// rgb: (h, w, 3) uint8, row major. Returns the file's length, or -1 when
// it would not fit in ``cap`` bytes.
int64_t bbocr_jpeg_encode(const uint8_t* rgb, int32_t h, int32_t w, int32_t quality, uint8_t* out, int64_t cap) {
  // Y at full resolution, Cb and Cr 2x2 subsampled.
  const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  const int ybw = (w + 7) / 8, ybh = (h + 7) / 8;  // Y blocks holding image data
  const int cbw = mcux, cbh = mcuy;                // Cb, Cr blocks (one per MCU)

  // jccolor.c tables.
  const int32_t SCALEBITS = 16, ONE_HALF = 1 << 15, CBCR_OFFSET = 128 << 16;
  auto FIX = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
  int32_t tab[8][256];
  for (int i = 0; i < 256; i++) {
    tab[0][i] = FIX(0.29900) * i;
    tab[1][i] = FIX(0.58700) * i;
    tab[2][i] = FIX(0.11400) * i + ONE_HALF;
    tab[3][i] = -FIX(0.16874) * i;
    tab[4][i] = -FIX(0.33126) * i;
    tab[5][i] = FIX(0.50000) * i + CBCR_OFFSET + ONE_HALF - 1;  // also R's Cr term
    tab[6][i] = -FIX(0.41869) * i;
    tab[7][i] = -FIX(0.08131) * i;
  }
  // Full-resolution planes over rows padded to even and columns to the
  // 16-wide chroma blocks, the last row and column repeated.
  const int fw = cbw * 16, fh = h + (h & 1);
  Plane Y{ybw * 8, cbh * 16, {}}, Cb{cbw * 8, cbh * 8, {}}, Cr{cbw * 8, cbh * 8, {}};
  std::vector<uint8_t> fy((size_t)fw * fh), fcb((size_t)fw * fh), fcr((size_t)fw * fh);
  for (int y = 0; y < fh; y++) {
    const uint8_t* row = rgb + (size_t)(y < h ? y : h - 1) * w * 3;
    for (int x = 0; x < fw; x++) {
      const uint8_t* p = row + (size_t)(x < w ? x : w - 1) * 3;
      const int r = p[0], g = p[1], b = p[2];
      size_t o = (size_t)y * fw + x;
      fy[o] = (uint8_t)((tab[0][r] + tab[1][g] + tab[2][b]) >> SCALEBITS);
      fcb[o] = (uint8_t)((tab[3][r] + tab[4][g] + tab[5][b]) >> SCALEBITS);
      fcr[o] = (uint8_t)((tab[5][r] + tab[6][g] + tab[7][b]) >> SCALEBITS);
    }
  }
  // jcsample.c fullsize_downsample keeps ybw * 8 columns (the repeated
  // last column); jcprepct.c repeats the last row to the iMCU row.
  Y.px.resize((size_t)Y.w * Y.h);
  for (int y = 0; y < Y.h; y++) {
    const int sy = y < h ? y : h - 1;
    std::memcpy(&Y.px[(size_t)y * Y.w], &fy[(size_t)sy * fw], Y.w);
  }
  // h2v2_downsample, then the last chroma row repeated.
  const int ch = fh / 2;
  for (Plane* pl : {&Cb, &Cr}) {
    const std::vector<uint8_t>& full = pl == &Cb ? fcb : fcr;
    pl->px.resize((size_t)pl->w * pl->h);
    for (int y = 0; y < pl->h; y++) {
      const int sy = y < ch ? y : ch - 1;
      const uint8_t* r0 = &full[(size_t)(2 * sy) * fw];
      const uint8_t* r1 = r0 + fw;
      int bias = 1;
      for (int x = 0; x < pl->w; x++) {
        pl->px[(size_t)y * pl->w + x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }

  int qt[2][64];
  scaled_table(0, quality, qt[0]);
  scaled_table(1, quality, qt[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) div[t][i] = reciprocal((uint32_t)qt[t][i] << 3);
  HuffCodes codes[4];
  for (int i = 0; i < 4; i++) codes[i] = derive(kHuff[i]);

  Writer wr{out, cap};
  // SOI, JFIF APP0 (version 1.01, no units, density 1:1, no thumbnail).
  const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                          0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  for (uint8_t b : head) wr.byte(b);
  for (int t = 0; t < 2; t++) {  // DQT, 8-bit entries in zigzag order
    wr.u16(0xFFDB);
    wr.u16(67);
    wr.byte((uint8_t)t);
    for (int i = 0; i < 64; i++) wr.byte((uint8_t)qt[t][kNatural[i]]);
  }
  wr.u16(0xFFC0);  // SOF0
  wr.u16(17);
  wr.byte(8);
  wr.u16(h);
  wr.u16(w);
  wr.byte(3);
  const uint8_t comps[3][3] = {{1, 0x22, 0}, {2, 0x11, 1}, {3, 0x11, 1}};
  for (auto& c : comps) {
    wr.byte(c[0]);
    wr.byte(c[1]);
    wr.byte(c[2]);
  }
  for (int i = 0; i < 4; i++) {  // DHT
    const HuffSpec& s = kHuff[i];
    wr.u16(0xFFC4);
    wr.u16(2 + 1 + 16 + s.nvals);
    wr.byte((uint8_t)(((i & 1) << 4) | (i >> 1)));
    for (int l = 0; l < 16; l++) wr.byte(s.bits[l]);
    for (int v = 0; v < s.nvals; v++) wr.byte(s.vals[v]);
  }
  wr.u16(0xFFDA);  // SOS
  wr.u16(12);
  wr.byte(3);
  const uint8_t sos[3][2] = {{1, 0x00}, {2, 0x11}, {3, 0x11}};
  for (auto& c : sos) {
    wr.byte(c[0]);
    wr.byte(c[1]);
  }
  wr.byte(0);
  wr.byte(63);
  wr.byte(0);

  int32_t last_dc[3] = {0, 0, 0};
  auto quantize = [&](const Plane& pl, int bx, int by, int t, int32_t coef[64]) {
    int32_t d[64];
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++) d[y * 8 + x] = (int32_t)pl.px[(size_t)(by * 8 + y) * pl.w + bx * 8 + x] - 128;
    fdct_islow(d);
    for (int i = 0; i < 64; i++) {
      const Divisor& q = div[t][i];
      int32_t v = d[i];
      const bool neg = v < 0;
      if (neg) v = -v;
      v = (int32_t)(((uint64_t)(uint32_t)(v + (int32_t)q.corr) * q.recip) >> q.shift);
      coef[i] = neg ? -v : v;
    }
  };
  auto encode = [&](const int32_t coef[64], int comp, const HuffCodes& dc, const HuffCodes& ac) {
    int32_t temp = coef[0] - last_dc[comp], temp2 = temp;
    last_dc[comp] = coef[0];
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    int nbits = 0;
    while (temp) {
      nbits++;
      temp >>= 1;
    }
    wr.bits(dc.code[nbits], dc.size[nbits]);
    if (nbits) wr.bits((uint32_t)temp2, nbits);
    int run = 0;
    for (int k = 1; k < 64; k++) {
      temp = coef[kNatural[k]];
      if (temp == 0) {
        run++;
        continue;
      }
      while (run > 15) {
        wr.bits(ac.code[0xF0], ac.size[0xF0]);
        run -= 16;
      }
      temp2 = temp;
      if (temp < 0) {
        temp = -temp;
        temp2--;
      }
      nbits = 1;
      while ((temp >>= 1)) nbits++;
      const int sym = (run << 4) + nbits;
      wr.bits(ac.code[sym], ac.size[sym]);
      wr.bits((uint32_t)temp2, nbits);
      run = 0;
    }
    if (run > 0) wr.bits(ac.code[0], ac.size[0]);
  };

  int32_t blocks[4][64];
  int32_t chroma[64];
  for (int my = 0; my < mcuy; my++) {
    for (int mx = 0; mx < mcux; mx++) {
      for (int yi = 0; yi < 2; yi++) {
        for (int xi = 0; xi < 2; xi++) {
          const int bx = mx * 2 + xi, by = my * 2 + yi, n = yi * 2 + xi;
          if (by >= ybh) {  // a row of dummy blocks below the image
            std::memset(blocks[n], 0, sizeof(blocks[n]));
            blocks[n][0] = blocks[1][0];  // the last block of the row above
          } else if (bx >= ybw) {  // a dummy block right of the image
            std::memset(blocks[n], 0, sizeof(blocks[n]));
            blocks[n][0] = blocks[n - 1][0];
          } else {
            quantize(Y, bx, by, 0, blocks[n]);
          }
        }
      }
      for (int n = 0; n < 4; n++) encode(blocks[n], 0, codes[0], codes[1]);
      quantize(Cb, mx, my, 1, chroma);
      encode(chroma, 1, codes[2], codes[3]);
      quantize(Cr, mx, my, 1, chroma);
      encode(chroma, 2, codes[2], codes[3]);
    }
  }
  wr.flush();
  wr.u16(0xFFD9);
  return wr.overflow ? -1 : wr.pos;
}

}  // extern "C"
