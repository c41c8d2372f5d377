// Baseline, extended-sequential and progressive JPEG decoder on the host,
// to RGB.
//
// The port's datasets read photographs without PIL (datasets/image_io.py
// ::decode_jpeg binds this file through ctypes; it is built with g++ at
// first use). Its result is the bits of
// np.asarray(PIL.Image.open(path).convert("RGB")), that is libjpeg-turbo's
// defaults as Pillow calls them:
//   - Huffman decoding of SOF0 / SOF1 / SOF2 scans, 8-bit samples, 1 or 3
//     components, restart intervals, several DHT / DQT segments (8- and
//     16-bit quantization tables), interleaved and single-component scans;
//   - a sequential scan's block goes through the IDCT as it is decoded; a
//     progressive file's scans decode into one coefficient buffer per
//     component (int16 [blocks_h][blocks_w][64], natural order): DC first
//     and refinement scans, AC first scans with their EOB runs and AC
//     refinement scans follow jdphuff.c (decode_mcu_DC_first, _DC_refine,
//     _AC_first, _AC_refine); a component's quantization table is latched
//     at its first scan, as libjpeg latches it;
//   - after a progressive file's EOI the buffer goes through the IDCT; one
//     whose scans leave some component's coefficient 1-9 unrefined (Al >
//     0, or never sent) is refused, since libjpeg would then smooth the
//     blocks (jdcoefct.c smoothing_ok / decompress_smooth_data);
//   - jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2, the post-IDCT range
//     limit table that wraps around 128);
//   - fancy upsampling: h2v1_fancy_upsample and h2v2_fancy_upsample where
//     the downsampled width exceeds 2 (box replication otherwise),
//     h1v2_fancy_upsample, box replication for other integral factors;
//     rows above the top and below the last real row repeat the edge row;
//   - ycc_rgb_convert's fixed-point tables (SCALEBITS 16); an Adobe
//     transform 0 or the component ids 'R', 'G', 'B' mean RGB as stored;
//   - grey repeated to RGB; EXIF orientation ignored (convert("RGB")
//     ignores it).
// Arithmetic, lossless, hierarchical and 12-bit files, 2- or 4-component
// files and progressive files with unrefined bits are refused with a
// message naming the marker, the component count or the bits. A file cut
// short (no EOI) is refused too.
//
// C interface: jd_info(data, n, info[5], err, errlen) reads the headers
// (width, height, components, SOF marker, precision); jd_decode(data, n,
// out, out_len, err, errlen) writes height x width x 3 bytes. Both return
// 0, or nonzero with a message in err.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
    6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // past the end: a corrupt run lands on 63, as libjpeg's table does
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  std::string msg;
};

struct Huff {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[17];
  // 9-bit lookahead: (code length << 8) | symbol, 0 where longer
  uint16_t look[512];

  void derive() {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) throw Error{"bad Huffman table"};
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= 9; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++p) {
        int lookbits = huffcode[p] << (9 - l);
        for (int c = 0; c < (1 << (9 - l)); ++c) look[lookbits + c] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;          // downsampled width and height
  int bw = 0, bh = 0;          // blocks of the plane (the MCU-padded grid)
  std::vector<int16_t> coef;   // progressive: bw x bh blocks of 64 coefficients, natural order
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples
  int dc = 0;
  bool q_latched = false;
  uint16_t q[64];
  // the bit each coefficient was last refined to (libjpeg's coef_bits):
  // -1 before any scan sent it
  int coef_bits[64];

  int16_t *block(int bx, int by) { return &coef[(static_cast<size_t>(by) * bw + bx) * 64]; }
};

struct Decoder {
  const uint8_t *data;
  size_t n, pos = 0;
  int width = 0, height = 0, precision = 0, sof = -1, ncomp = 0;
  int hmax = 1, vmax = 1;
  Component comp[4];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc_tab[4], ac_tab[4];
  int restart = 0;
  bool progressive = false;
  int eobrun = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool frame_done = false;
  // the entropy-coded segment's bit reader
  uint64_t acc = 0;
  int nbits = 0;
  bool at_marker = false;

  Decoder(const uint8_t *d, size_t len) : data(d), n(len) {}

  int byte() {
    if (pos >= n) throw Error{"truncated file"};
    return data[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // -------------------------------------------------------------- markers
  int next_marker() {
    for (;;) {
      if (pos >= n) throw Error{"no EOI marker before the end of the file"};
      if (data[pos] != 0xFF) {
        ++pos;  // garbage between segments, as libjpeg skips it
        continue;
      }
      while (pos < n && data[pos] == 0xFF) ++pos;
      if (pos >= n) throw Error{"truncated marker"};
      int m = data[pos++];
      if (m != 0) return m;
    }
  }

  static std::string sof_name(int m) {
    char buf[96];
    const char *kind = "unknown";
    switch (m) {
      case 0xC2: kind = "progressive Huffman"; break;
      case 0xC3: kind = "lossless Huffman"; break;
      case 0xC5: kind = "differential sequential Huffman"; break;
      case 0xC6: kind = "differential progressive Huffman"; break;
      case 0xC7: kind = "differential lossless Huffman"; break;
      case 0xC9: kind = "extended sequential arithmetic"; break;
      case 0xCA: kind = "progressive arithmetic"; break;
      case 0xCB: kind = "lossless arithmetic"; break;
      case 0xCD: kind = "differential sequential arithmetic"; break;
      case 0xCE: kind = "differential progressive arithmetic"; break;
      case 0xCF: kind = "differential lossless arithmetic"; break;
    }
    std::snprintf(buf, sizeof(buf), "SOF%d (0xFF%02X, %s)", m - 0xC0, m, kind);
    return buf;
  }

  void read_sof(int m) {
    int len = word();
    size_t end = pos + len - 2;
    precision = byte();
    height = word();
    width = word();
    ncomp = byte();
    sof = m;
    if (m != 0xC0 && m != 0xC1 && m != 0xC2)
      throw Error{sof_name(m) + " is not decoded: only baseline, extended-sequential and progressive Huffman "
                  "JPEGs (SOF0, SOF1, SOF2)"};
    progressive = m == 0xC2;
    if (precision != 8)
      throw Error{"a " + std::to_string(precision) + "-bit JPEG is not decoded: only 8-bit samples"};
    if (ncomp != 1 && ncomp != 3)
      throw Error{"a JPEG of " + std::to_string(ncomp) +
                  " components is not decoded: only 1 (grey) or 3 (YCbCr or RGB); 4 is CMYK or YCCK"};
    if (width <= 0 || height <= 0)
      throw Error{"a JPEG of " + std::to_string(width) + "x" + std::to_string(height) +
                  " (a height given by a DNL marker) is not decoded"};
    hmax = vmax = 1;
    for (int c = 0; c < ncomp; ++c) {
      comp[c].id = byte();
      int hv = byte();
      comp[c].h = hv >> 4;
      comp[c].v = hv & 15;
      comp[c].tq = byte();
      if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 || comp[c].v > 4 || comp[c].tq > 3)
        throw Error{"bad sampling factors or quantization table in SOF"};
      if (comp[c].h > hmax) hmax = comp[c].h;
      if (comp[c].v > vmax) vmax = comp[c].v;
    }
    if (pos != end) throw Error{"bad SOF length"};
    int mcux = (width + 8 * hmax - 1) / (8 * hmax), mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      Component &k = comp[c];
      if (hmax % k.h || vmax % k.v)
        throw Error{"sampling factors that are not integral ratios are not decoded"};
      k.dw = (width * k.h + hmax - 1) / hmax;
      k.dh = (height * k.v + vmax - 1) / vmax;
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      if (progressive) k.coef.assign(static_cast<size_t>(k.bw) * k.bh * 64, 0);
      k.plane.assign(static_cast<size_t>(k.bw) * 8 * k.bh * 8, 0);
      for (int i = 0; i < 64; ++i) k.coef_bits[i] = -1;
    }
    frame_done = true;
  }

  void read_dht() {
    int len = word();
    size_t end = pos + len - 2;
    while (pos < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Error{"bad DHT table class or id"};
      Huff &t = tc ? ac_tab[th] : dc_tab[th];
      int count = 0;
      t.bits[0] = 0;
      for (int l = 1; l <= 16; ++l) {
        t.bits[l] = static_cast<uint8_t>(byte());
        count += t.bits[l];
      }
      if (count > 256) throw Error{"bad DHT symbol count"};
      for (int i = 0; i < count; ++i) t.vals[i] = static_cast<uint8_t>(byte());
      t.derive();
    }
    if (pos != end) throw Error{"bad DHT length"};
  }

  void read_dqt() {
    int len = word();
    size_t end = pos + len - 2;
    while (pos < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) throw Error{"bad DQT precision or id"};
      for (int i = 0; i < 64; ++i) qt[tq][kNatural[i]] = static_cast<uint16_t>(pq ? word() : byte());
      qt_defined[tq] = true;
    }
    if (pos != end) throw Error{"bad DQT length"};
  }

  void read_app(int m) {
    int len = word();
    size_t end = pos + len - 2;
    if (end > n) throw Error{"truncated APP segment"};
    const uint8_t *p = data + pos;
    size_t l = len - 2;
    if (m == 0xE0 && l >= 5 && std::memcmp(p, "JFIF\0", 5) == 0) jfif = true;
    if (m == 0xEE && l >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    pos = end;
  }

  void skip_segment() {
    int len = word();
    if (len < 2 || pos + len - 2 > n) throw Error{"bad segment length"};
    pos += len - 2;
  }

  // ------------------------------------------------------------ bit reader
  void fill() {
    while (nbits <= 56) {
      int b = 0;
      if (!at_marker && pos < n) {
        b = data[pos];
        if (b == 0xFF) {
          int nx = pos + 1 < n ? data[pos + 1] : -1;
          if (nx == 0x00) {
            pos += 2;
          } else {
            at_marker = true;  // leave the marker for the caller; feed zeros, as libjpeg does
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      acc |= static_cast<uint64_t>(b) << (56 - nbits);
      nbits += 8;
    }
  }
  int bits(int s) {
    if (s == 0) return 0;
    if (nbits < s) fill();
    int v = static_cast<int>(acc >> (64 - s));
    acc <<= s;
    nbits -= s;
    return v;
  }
  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }
  int decode(const Huff &t) {
    if (nbits < 16) fill();
    int look = static_cast<int>(acc >> 55);
    int e = t.look[look];
    if (e) {
      int l = e >> 8;
      acc <<= l;
      nbits -= l;
      return e & 0xFF;
    }
    int code = static_cast<int>(acc >> 55);
    int l = 9;
    acc <<= 9;
    nbits -= 9;
    while (code > t.maxcode[l]) {
      code = (code << 1) | static_cast<int>(acc >> 63);
      acc <<= 1;
      --nbits;
      if (++l > 16) throw Error{"corrupt Huffman code"};
    }
    return t.vals[code + t.valoffset[l]];
  }

  void reset_bits() {
    acc = 0;
    nbits = 0;
  }

  void restart_marker() {
    reset_bits();
    at_marker = false;
    // the marker follows the segment's padding bits
    while (pos < n && data[pos] != 0xFF) ++pos;
    while (pos < n && data[pos] == 0xFF) ++pos;
    if (pos >= n) throw Error{"missing restart marker"};
    int m = data[pos++];
    if (m < 0xD0 || m > 0xD7) throw Error{"expected a restart marker"};
  }

  // ------------------------------------------------------------- one block
  // a sequential scan's block: every coefficient at once, then the IDCT
  void decode_block(Component &k, int bx, int by) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    const Huff &dct = dc_tab[k.td], &act = ac_tab[k.ta];
    int s = decode(dct);
    int diff = s ? extend(bits(s), s) : 0;
    k.dc += diff;
    coef[0] = static_cast<int16_t>(k.dc);
    for (int i = 1; i < 64; ++i) {
      int rs = decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        coef[kNatural[i]] = static_cast<int16_t>(extend(bits(s), s));
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
    idct_islow(coef, k.q, &k.plane[(static_cast<size_t>(by) * 8 * k.bw + bx) * 8], k.bw * 8);
  }

  // progressive scans (jdphuff.c): the DC band's first scan and refinements
  void dc_first(Component &k, int bx, int by, int al) {
    int s = decode(dc_tab[k.td]);
    k.dc += s ? extend(bits(s), s) : 0;
    k.block(bx, by)[0] = static_cast<int16_t>(k.dc * (1 << al));
  }
  void dc_refine(Component &k, int bx, int by, int al) {
    if (bits(1)) k.block(bx, by)[0] |= static_cast<int16_t>(1 << al);
  }

  // an AC band's first scan: coefficients ss..se, or a block of an EOB run
  void ac_first(Component &k, int bx, int by, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    int16_t *coef = k.block(bx, by);
    const Huff &act = ac_tab[k.ta];
    for (int i = ss; i <= se; ++i) {
      int rs = decode(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        coef[kNatural[i]] = static_cast<int16_t>(extend(bits(s), s) * (1 << al));
      } else if (r == 15) {
        i += 15;
      } else {
        eobrun = (1 << r) - 1;
        if (r) eobrun += bits(r);
        break;
      }
    }
  }

  // an AC band's refinement (decode_mcu_AC_refine): a new coefficient is
  // +-1 at bit al; each already-nonzero coefficient passed over takes a
  // correction bit that moves it away from zero
  void ac_refine(Component &k, int bx, int by, int ss, int se, int al) {
    int16_t *coef = k.block(bx, by);
    const int p1 = 1 << al, m1 = -(1 << al);
    auto correct = [&](int16_t &c) {
      if (bits(1) && (c & p1) == 0) c = static_cast<int16_t>(c + (c >= 0 ? p1 : m1));
    };
    int i = ss;
    if (eobrun == 0) {
      for (; i <= se; ++i) {
        int rs = decode(ac_tab[k.ta]);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = bits(1) ? p1 : m1;  // s != 1 is corrupt data; libjpeg warns and goes on
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits(r);
          break;
        }
        // pass over r zero coefficients, correcting the nonzero ones
        do {
          int16_t &c = coef[kNatural[i]];
          if (c != 0) {
            correct(c);
          } else if (--r < 0) {
            break;
          }
          ++i;
        } while (i <= se);
        if (s) coef[kNatural[i]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; i <= se; ++i) {
        int16_t &c = coef[kNatural[i]];
        if (c != 0) correct(c);
      }
      --eobrun;
    }
  }

  // IDCT_range_limit: x -> x + 128 clamped, indexed by x & 1023
  struct RangeLimit {
    uint8_t t[1024];
    RangeLimit() {
      for (int i = 0; i < 1024; ++i) {
        int v = (i < 512 ? i : i - 1024) + 128;
        t[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
    }
  };

  // jpeg_idct_islow (jidctint.c), 8-bit samples
  static void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out, int stride) {
    static const RangeLimit range;  // initialized once, thread-safe
    const uint8_t *limit = range.t;
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633, F1501 = 12299,
                  F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t *ip = in + c;
      const uint16_t *qp = q + c;
      int *wp = ws + c;
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
        int dc = (ip[0] * qp[0]) * (1 << 2);
        for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
        continue;
      }
      int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = ip[0] * qp[0];
      z3 = ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << 13);
      int64_t tmp1 = (z2 - z3) * (1 << 13);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = ip[56] * qp[56];
      tmp1 = ip[40] * qp[40];
      tmp2 = ip[24] * qp[24];
      tmp3 = ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = 13 - 2;
      const int64_t rnd = int64_t(1) << (sh - 1);
      wp[0] = static_cast<int>((tmp10 + tmp3 + rnd) >> sh);
      wp[56] = static_cast<int>((tmp10 - tmp3 + rnd) >> sh);
      wp[8] = static_cast<int>((tmp11 + tmp2 + rnd) >> sh);
      wp[48] = static_cast<int>((tmp11 - tmp2 + rnd) >> sh);
      wp[16] = static_cast<int>((tmp12 + tmp1 + rnd) >> sh);
      wp[40] = static_cast<int>((tmp12 - tmp1 + rnd) >> sh);
      wp[24] = static_cast<int>((tmp13 + tmp0 + rnd) >> sh);
      wp[32] = static_cast<int>((tmp13 - tmp0 + rnd) >> sh);
    }
    for (int r = 0; r < 8; ++r) {
      const int *wp = ws + 8 * r;
      uint8_t *op = out + static_cast<size_t>(r) * stride;
      if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
        uint8_t v = limit[((wp[0] + (1 << 4)) >> 5) & 1023];
        for (int i = 0; i < 8; ++i) op[i] = v;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << 13);
      int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << 13);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = 13 + 2 + 3;
      const int64_t rnd = int64_t(1) << (sh - 1);
      op[0] = limit[static_cast<int>((tmp10 + tmp3 + rnd) >> sh) & 1023];
      op[7] = limit[static_cast<int>((tmp10 - tmp3 + rnd) >> sh) & 1023];
      op[1] = limit[static_cast<int>((tmp11 + tmp2 + rnd) >> sh) & 1023];
      op[6] = limit[static_cast<int>((tmp11 - tmp2 + rnd) >> sh) & 1023];
      op[2] = limit[static_cast<int>((tmp12 + tmp1 + rnd) >> sh) & 1023];
      op[5] = limit[static_cast<int>((tmp12 - tmp1 + rnd) >> sh) & 1023];
      op[3] = limit[static_cast<int>((tmp13 + tmp0 + rnd) >> sh) & 1023];
      op[4] = limit[static_cast<int>((tmp13 - tmp0 + rnd) >> sh) & 1023];
    }
  }

  // ------------------------------------------------------------------ scan
  void read_sos() {
    if (!frame_done) throw Error{"SOS before SOF"};
    int len = word();
    size_t end = pos + len - 2;
    int ns = byte();
    if (ns < 1 || ns > ncomp) throw Error{"bad SOS component count"};
    Component *sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = byte(), t = byte();
      sc[i] = nullptr;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == id) sc[i] = &comp[c];
      if (!sc[i]) throw Error{"SOS names an unknown component"};
      sc[i]->td = t >> 4;
      sc[i]->ta = t & 15;
    }
    int ss = byte(), se = byte(), ahal = byte();
    int ah = ahal >> 4, al = ahal & 15;
    if (pos != end) throw Error{"bad SOS length"};
    if (!progressive && (ss != 0 || se != 63 || ahal != 0))
      throw Error{"a sequential scan must cover coefficients 0-63"};
    // start_pass_phuff_decoder's checks
    if (progressive && ((ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1)) || (ah != 0 && al != ah - 1) ||
                        al > 13))
      throw Error{"bad progressive scan: Ss " + std::to_string(ss) + ", Se " + std::to_string(se) + ", Ah " +
                  std::to_string(ah) + ", Al " + std::to_string(al) + ", " + std::to_string(ns) + " components"};
    // the tables the scan reads: a DC refinement reads none, an AC scan no DC table
    const bool need_dc = !progressive || (ss == 0 && ah == 0), need_ac = !progressive || ss > 0;
    for (int i = 0; i < ns; ++i) {
      Component &k = *sc[i];
      if ((need_dc && (k.td > 3 || !dc_tab[k.td].defined)) || (need_ac && (k.ta > 3 || !ac_tab[k.ta].defined)))
        throw Error{"SOS names an undefined Huffman table"};
      if (!k.q_latched) {
        if (!qt_defined[k.tq]) throw Error{"a component's quantization table is undefined"};
        std::memcpy(k.q, qt[k.tq], sizeof(k.q));
        k.q_latched = true;
      }
      if (progressive) {
        if (ss > 0 && k.coef_bits[0] < 0)
          throw Error{"bad progression: an AC scan before the component's first DC scan"};
        for (int c = ss; c <= se; ++c) {
          if (ah != (k.coef_bits[c] < 0 ? 0 : k.coef_bits[c]))
            throw Error{"bad progression: coefficient " + std::to_string(c) + " refined from bit " +
                        std::to_string(ah) + " where it is at " + std::to_string(k.coef_bits[c])};
          k.coef_bits[c] = al;
        }
      } else {
        for (int c = 0; c < 64; ++c) k.coef_bits[c] = 0;
      }
    }
    for (int i = 0; i < ns; ++i) sc[i]->dc = 0;
    eobrun = 0;
    reset_bits();
    at_marker = false;
    int mcux, mcuy;
    if (ns == 1) {
      mcux = (sc[0]->dw + 7) / 8;
      mcuy = (sc[0]->dh + 7) / 8;
    } else {
      mcux = (width + 8 * hmax - 1) / (8 * hmax);
      mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    }
    int left = restart;
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        if (restart) {
          if (left == 0) {
            // the DC predictors and the EOB run end at RSTn
            restart_marker();
            for (int i = 0; i < ns; ++i) sc[i]->dc = 0;
            eobrun = 0;
            left = restart;
          }
          --left;
        }
        auto one = [&](Component &k, int bx, int by) {
          if (!progressive)
            decode_block(k, bx, by);
          else if (ss == 0)
            ah == 0 ? dc_first(k, bx, by, al) : dc_refine(k, bx, by, al);
          else
            ah == 0 ? ac_first(k, bx, by, ss, se, al) : ac_refine(k, bx, by, ss, se, al);
        };
        if (ns == 1) {
          one(*sc[0], mx, my);
        } else {
          for (int i = 0; i < ns; ++i) {
            Component &k = *sc[i];
            for (int v = 0; v < k.v; ++v)
              for (int h = 0; h < k.h; ++h) one(k, mx * k.h + h, my * k.v + v);
          }
        }
      }
    }
    // the scan's padding bits; the next marker follows
    reset_bits();
    at_marker = false;
  }

  void parse(bool headers_only) {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) throw Error{"not a JPEG file (no SOI marker)"};
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        if (frame_done) throw Error{"a second SOF marker"};
        read_sof(m);
        if (headers_only) return;
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xCC) {
        throw Error{"arithmetic coding (DAC, 0xFFCC) is not decoded"};
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        word();
        restart = word();
      } else if (m == 0xDA) {
        read_sos();
      } else if (m == 0xD9) {
        if (!frame_done) throw Error{"EOI before SOF"};
        finish();
        return;
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m >= 0xD0 && m <= 0xD7) {
        // a stray restart marker between segments
      } else if (m == 0x01) {
        // TEM: no length
      } else {
        skip_segment();
      }
    }
  }

  // ----------------------------------------------------- the coefficients
  // After EOI: every component was sent; a progressive file's blocks that
  // a row of the plane reads go through the IDCT, unless libjpeg would
  // smooth them.
  void finish() {
    for (int c = 0; c < ncomp; ++c)
      if (!comp[c].q_latched) throw Error{"no scan sent component " + std::to_string(c)};
    if (!progressive) return;
    // smoothing_ok (jdcoefct.c): every component's DC partly known, its
    // quantizers of coefficients 0-9 nonzero, and some coefficient 1-9 not
    // refined to bit 0
    static const int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool ok = true, useful = false;
    int which = -1, coefi = -1;
    for (int c = 0; c < ncomp; ++c) {
      const Component &k = comp[c];
      if (k.coef_bits[0] < 0) ok = false;
      for (int i = 0; i < 10 && ok; ++i)
        if (k.q[kSmoothPos[i]] == 0) ok = false;
      for (int i = 1; i < 10; ++i) {
        if (k.coef_bits[i] != 0 && !useful) {
          useful = true;
          which = c;
          coefi = i;
        }
      }
    }
    if (ok && useful)
      throw Error{"coefficient bits left unrefined: libjpeg would smooth these blocks (component " +
                  std::to_string(which) + "'s coefficient " + std::to_string(coefi) + " ends at bit " +
                  std::to_string(comp[which].coef_bits[coefi]) + "; -1: never sent)"};
    for (int c = 0; c < ncomp; ++c) {
      Component &k = comp[c];
      const int nbx = (k.dw + 7) / 8, nby = (k.dh + 7) / 8;
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx)
          idct_islow(k.block(bx, by), k.q, &k.plane[(static_cast<size_t>(by) * 8 * k.bw + bx) * 8], k.bw * 8);
    }
  }

  // ------------------------------------------------------- upsample, color
  // component k's samples at full resolution, row y (width columns), into dst
  void upsample_row(const Component &k, int y, std::vector<int> &colsum, uint8_t *dst) const {
    const int hf = hmax / k.h, vf = vmax / k.v;
    const int stride = k.bw * 8;
    const uint8_t *pl = k.plane.data();
    auto row = [&](int r) {
      if (r < 0) r = 0;
      if (r > k.dh - 1) r = k.dh - 1;
      return pl + static_cast<size_t>(r) * stride;
    };
    const int dw = k.dw;
    if (hf == 1 && vf == 1) {
      std::memcpy(dst, row(y), width);
    } else if (hf == 2 && vf == 1 && dw > 2) {
      const uint8_t *in = row(y);
      std::vector<uint8_t> out(2 * dw);
      int iv = in[0];
      out[0] = static_cast<uint8_t>(iv);
      out[1] = static_cast<uint8_t>((iv * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; ++i) {
        iv = in[i] * 3;
        out[2 * i] = static_cast<uint8_t>((iv + in[i - 1] + 1) >> 2);
        out[2 * i + 1] = static_cast<uint8_t>((iv + in[i + 1] + 2) >> 2);
      }
      iv = in[dw - 1];
      out[2 * dw - 2] = static_cast<uint8_t>((iv * 3 + in[dw - 2] + 1) >> 2);
      out[2 * dw - 1] = static_cast<uint8_t>(iv);
      std::memcpy(dst, out.data(), width);
    } else if (hf == 2 && vf == 2 && dw > 2) {
      int r = y / 2;
      const uint8_t *near = row(r), *far = (y & 1) ? row(r + 1) : row(r - 1);
      for (int i = 0; i < dw; ++i) colsum[i] = near[i] * 3 + far[i];
      std::vector<uint8_t> out(2 * dw);
      out[0] = static_cast<uint8_t>((colsum[0] * 4 + 8) >> 4);
      out[1] = static_cast<uint8_t>((colsum[0] * 3 + colsum[1] + 7) >> 4);
      for (int i = 1; i < dw - 1; ++i) {
        out[2 * i] = static_cast<uint8_t>((colsum[i] * 3 + colsum[i - 1] + 8) >> 4);
        out[2 * i + 1] = static_cast<uint8_t>((colsum[i] * 3 + colsum[i + 1] + 7) >> 4);
      }
      out[2 * dw - 2] = static_cast<uint8_t>((colsum[dw - 1] * 3 + colsum[dw - 2] + 8) >> 4);
      out[2 * dw - 1] = static_cast<uint8_t>((colsum[dw - 1] * 4 + 7) >> 4);
      std::memcpy(dst, out.data(), width);
    } else if (hf == 1 && vf == 2) {
      int r = y / 2;
      const uint8_t *near = row(r), *far = (y & 1) ? row(r + 1) : row(r - 1);
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width; ++x) dst[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
    } else {
      // box replication (libjpeg's h2v1 / h2v2 / int upsample)
      const uint8_t *in = row(y / vf);
      for (int x = 0; x < width; ++x) dst[x] = in[x / hf];
    }
  }

  void to_rgb(uint8_t *out) const {
    const size_t W = width;
    if (ncomp == 1) {
      std::vector<int> cs;
      std::vector<uint8_t> g(W);
      for (int y = 0; y < height; ++y) {
        upsample_row(comp[0], y, cs, g.data());
        uint8_t *o = out + y * W * 3;
        for (size_t x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      }
      return;
    }
    bool rgb;
    if (jfif) {
      rgb = false;
    } else if (adobe) {
      rgb = adobe_transform == 0;
    } else {
      rgb = comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
    }
    // ycc_rgb_convert's tables (jdcolor.c), SCALEBITS 16
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t ONE_HALF = int64_t(1) << 15;
    auto FIX = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((FIX(1.40200) * x + ONE_HALF) >> 16);
      cb_b[i] = static_cast<int>((FIX(1.77200) * x + ONE_HALF) >> 16);
      cr_g[i] = -FIX(0.71414) * x;
      cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    std::vector<int> cs(comp[0].bw * 8 + comp[1].bw * 8 + comp[2].bw * 8 + 16);
    std::vector<uint8_t> p0(W), p1(W), p2(W);
    for (int y = 0; y < height; ++y) {
      upsample_row(comp[0], y, cs, p0.data());
      upsample_row(comp[1], y, cs, p1.data());
      upsample_row(comp[2], y, cs, p2.data());
      uint8_t *o = out + y * W * 3;
      if (rgb) {
        for (size_t x = 0; x < W; ++x) {
          o[3 * x] = p0[x];
          o[3 * x + 1] = p1[x];
          o[3 * x + 2] = p2[x];
        }
        continue;
      }
      for (size_t x = 0; x < W; ++x) {
        int Y = p0[x], cb = p1[x], cr = p2[x];
        o[3 * x] = clamp(Y + cr_r[cr]);
        o[3 * x + 1] = clamp(Y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp(Y + cb_b[cb]);
      }
    }
  }
};

void set_err(char *err, int errlen, const std::string &msg) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

// info: width, height, components, SOF marker, precision
int jd_info(const uint8_t *data, int64_t n, int32_t *info, char *err, int32_t errlen) {
  Decoder d(data, static_cast<size_t>(n));
  try {
    d.parse(true);
  } catch (const Error &e) {
    // a refused SOF still reports what it was
    info[0] = d.width;
    info[1] = d.height;
    info[2] = d.ncomp;
    info[3] = d.sof;
    info[4] = d.precision;
    set_err(err, errlen, e.msg);
    return 1;
  }
  info[0] = d.width;
  info[1] = d.height;
  info[2] = d.ncomp;
  info[3] = d.sof;
  info[4] = d.precision;
  return 0;
}

int jd_decode(const uint8_t *data, int64_t n, uint8_t *out, int64_t out_len, char *err, int32_t errlen) {
  Decoder d(data, static_cast<size_t>(n));
  try {
    d.parse(false);
    if (static_cast<int64_t>(d.width) * d.height * 3 != out_len) throw Error{"output buffer of the wrong size"};
    d.to_rgb(out);
  } catch (const Error &e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception &e) {
    set_err(err, errlen, e.what());
    return 2;
  }
  return 0;
}

}  // extern "C"
