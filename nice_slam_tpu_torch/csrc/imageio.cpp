// Host image codecs of the port's dataset loaders, so that no image library
// is needed to read a recorded RGB-D sequence:
//
//   * nst_png_unfilter: undoes the five PNG row filters (None, Sub, Up,
//     Average, Paeth) of an inflated, non-interlaced image.  Average and
//     Paeth depend on the byte to the left, so they run row by row here;
//     chunk parsing and inflate stay in Python (io/codecs.py, zlib).
//   * nst_jpeg_decode: baseline and 8-bit extended sequential JPEG
//     (SOF0 / SOF1), Huffman coded, with restart intervals, 1 or 3
//     components, sampling 4:4:4, 4:2:2 and 4:2:0, interleaved or not.  It
//     computes what libjpeg-turbo returns with its default settings (the
//     decoder behind cv2.imread): the integer "islow" inverse DCT of
//     jidctint.c, the "fancy" triangular chroma upsampling of jdsample.c
//     (h2v1, h2v2) with the edge rows replicated as jdmainct.c does, and
//     the fixed-point YCbCr -> RGB tables of jdcolor.c.  Progressive,
//     arithmetic-coded, lossless, 12-bit, CMYK and Adobe-RGB files, and an
//     EXIF orientation other than 1, are refused with a message.
//   * nst_jpeg_encode: baseline JPEG writer (4:2:0 for color, IJG quality
//     scaling of the standard quantization tables, the standard Huffman
//     tables, integer forward DCT of jfdctint.c, the RGB -> YCbCr tables of
//     jccolor.c).  Its bytes depend only on the pixels and the quality.
//
// Every entry point returns 0 on success, else writes a message into `err`
// and returns non-zero.  Build: g++ -O3 -shared -fPIC -std=c++17
// imageio.cpp (io/codecs.py, at first use, into build/).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

void set_err(char *err, int errlen, const std::string &msg) {
  if (err && errlen > 0) {
    std::snprintf(err, (size_t)errlen, "%s", msg.c_str());
  }
}

// natural (row-major) index of the k-th coefficient in zigzag order; the
// 16 extra entries absorb a run that overflows a corrupt block, as
// libjpeg's table does
int g_natural[80];

struct ZigzagInit {
  ZigzagInit() {
    int k = 0;
    for (int s = 0; s < 15; ++s) {
      if (s % 2 == 0) {   // up the diagonal: row from high to low
        for (int r = (s < 8 ? s : 7); r >= 0 && s - r < 8; --r)
          g_natural[k++] = r * 8 + (s - r);
      } else {
        for (int c = (s < 8 ? s : 7); c >= 0 && s - c < 8; --c)
          g_natural[k++] = (s - c) * 8 + c;
      }
    }
    for (; k < 80; ++k) g_natural[k] = 63;
  }
} g_zigzag_init;

// ---------------------------------------------------------------- PNG

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// ---------------------------------------------------------------- JPEG

struct Huffman {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint16_t look[512];   // 9-bit lookahead: (length << 8) | value, 0 = miss

  bool build() {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += bits[l];
      k += bits[l];
      maxcode[l] = bits[l] ? code - 1 : -1;
      if (code > (1 << l)) return false;   // over-subscribed lengths
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look, 0, sizeof(look));
    code = 0;
    k = 0;
    for (int l = 1; l <= 9; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        int shift = 9 - l;
        for (int j = 0; j < (1 << shift); ++j)
          look[(code << shift) | j] = (uint16_t)((l << 8) | vals[k]);
      }
      code <<= 1;
    }
    present = true;
    return true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int bw = 0, bh = 0;        // blocks per row / column, padded to MCUs
  int dw = 0, dh = 0;        // downsampled width / height in samples
  int pred = 0;              // DC predictor
  std::vector<int16_t> coef; // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples after the IDCT
};

struct JpegDecoder {
  const uint8_t *d;
  size_t n;
  size_t pos = 0;
  std::string err;

  uint16_t qt[4][64];        // natural order
  bool qset[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0, precision = 8;
  Component comp[4];
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool frame_seen = false, any_scan = false;
  int adobe_transform = -1;
  int orientation = 1;

  // entropy-coded segment reader, MSB-first in a 64-bit word
  uint64_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;

  JpegDecoder(const uint8_t *data, size_t len) : d(data), n(len) {}

  bool fail(const std::string &m) {
    if (err.empty()) err = m;
    return false;
  }

  int u16(size_t p) const { return (d[p] << 8) | d[p + 1]; }

  void fill() {
    while (bitcnt <= 56) {
      uint32_t b = 0;
      if (!hit_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          uint8_t next = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;   // past the data: libjpeg reads zeros
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      bitbuf |= (uint64_t)b << (56 - bitcnt);
      bitcnt += 8;
    }
  }

  inline int get_bits(int k) {
    if (k == 0) return 0;
    if (bitcnt < k) fill();
    int v = (int)(bitbuf >> (64 - k));
    bitbuf <<= k;
    bitcnt -= k;
    return v;
  }

  inline int decode(const Huffman &h) {
    if (bitcnt < 16) fill();
    int e = h.look[bitbuf >> (64 - 9)];
    if (e) {
      int l = e >> 8;
      bitbuf <<= l;
      bitcnt -= l;
      return e & 0xFF;
    }
    int code = 0;
    for (int l = 1; l <= 16; ++l) {
      code = (code << 1) | (int)(bitbuf >> 63);
      bitbuf <<= 1;
      --bitcnt;
      if (code <= h.maxcode[l])
        return h.vals[h.valptr[l] + code - h.mincode[l]];
    }
    return 0;   // corrupt data: libjpeg substitutes a zero symbol
  }

  static inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  void decode_block(Component &c, int16_t *blk) {
    int s = decode(dc[c.td]);
    if (s > 16) s = 0;   // a corrupt table's symbol: no difference bits
    int diff = s ? extend(get_bits(s), s) : 0;
    c.pred += diff;
    blk[0] = (int16_t)c.pred;
    const Huffman &h = ac[c.ta];
    for (int k = 1; k < 64;) {
      int rs = decode(h);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        int val = extend(get_bits(sz), sz);
        blk[g_natural[k]] = (int16_t)val;
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;
      }
    }
  }

  void reset_bits() {
    bitbuf = 0;
    bitcnt = 0;
    hit_marker = false;
  }

  // the next RSTn marker, then the first byte after it
  bool restart() {
    reset_bits();
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] >= 0xD0
                             && d[pos + 1] <= 0xD7))
      ++pos;
    if (pos + 1 >= n) return fail("a restart marker is missing");
    pos += 2;
    return true;
  }

  // the next marker that is not RSTn
  void skip_to_marker() {
    reset_bits();
    while (pos + 1 < n) {
      if (d[pos] == 0xFF && d[pos + 1] != 0x00 && d[pos + 1] != 0xFF
          && !(d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7))
        return;
      ++pos;
    }
    pos = n;
  }

  bool parse_dqt(size_t p, size_t end) {
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      ++p;
      if (tq > 3) return fail("quantization table id > 3");
      size_t need = pq ? 128 : 64;
      if (p + need > end) return fail("truncated DQT segment");
      for (int k = 0; k < 64; ++k)
        qt[tq][g_natural[k]] =
            (uint16_t)(pq ? (d[p + 2 * k] << 8 | d[p + 2 * k + 1]) : d[p + k]);
      qset[tq] = true;
      p += need;
    }
    return true;
  }

  bool parse_dht(size_t p, size_t end) {
    while (p < end) {
      if (p + 17 > end) return fail("truncated DHT segment");
      int tc = d[p] >> 4, th = d[p] & 15;
      if (tc > 1 || th > 3) return fail("bad Huffman table id");
      Huffman &h = tc ? ac[th] : dc[th];
      int total = 0;
      h.bits[0] = 0;
      for (int l = 1; l <= 16; ++l) {
        h.bits[l] = d[p + l];
        total += h.bits[l];
      }
      p += 17;
      if (total > 256 || p + total > end)
        return fail("bad Huffman table lengths");
      std::memcpy(h.vals, d + p, (size_t)total);
      p += total;
      if (!h.build()) return fail("bad Huffman table lengths");
    }
    return true;
  }

  bool parse_sof(size_t p, size_t end) {
    if (frame_seen) return fail("more than one frame header");
    if (end - p < 6) return fail("truncated SOF segment");
    precision = d[p];
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = d[p + 5];
    if (precision != 8)
      return fail(std::to_string(precision)
                  + "-bit samples are not supported (8-bit only)");
    if (ncomp == 4) return fail("CMYK (4-component) JPEG is not supported");
    if (ncomp != 1 && ncomp != 3)
      return fail(std::to_string(ncomp) + "-component JPEG is not supported");
    if (width <= 0 || height <= 0)
      return fail("no image size in the frame header (DNL is not supported)");
    if (end - p < (size_t)(6 + 3 * ncomp)) return fail("truncated SOF segment");
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component &c = comp[i];
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        return fail("bad component sampling factors");
      if (c.h > hmax) hmax = c.h;
      if (c.v > vmax) vmax = c.v;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component &c = comp[i];
      if (hmax % c.h || vmax % c.v)
        return fail("unsupported chroma sampling");
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    if (ncomp == 3) {
      if (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B')
        return fail("RGB (not YCbCr) JPEG is not supported");
      for (int i = 1; i < 3; ++i) {
        int ex = hmax / comp[i].h, ey = vmax / comp[i].v;
        if (!((ex == 1 && ey == 1) || (ex == 2 && ey == 1)
              || (ex == 2 && ey == 2)))
          return fail("unsupported chroma sampling (4:4:4, 4:2:2 and "
                      "4:2:0 only)");
      }
      if (hmax != comp[0].h || vmax != comp[0].v)
        return fail("unsupported chroma sampling (luma not the densest)");
    }
    frame_seen = true;
    return true;
  }

  bool parse_exif(size_t p, size_t end) {
    // "Exif\0\0", then a TIFF header; IFD0's tag 0x0112 is the orientation
    if (end - p < 14 || std::memcmp(d + p, "Exif\0\0", 6) != 0) return true;
    size_t t = p + 6;
    bool le;
    if (d[t] == 'I' && d[t + 1] == 'I') le = true;
    else if (d[t] == 'M' && d[t + 1] == 'M') le = false;
    else return true;
    auto rd16 = [&](size_t q) -> int {
      return le ? (d[q] | d[q + 1] << 8) : (d[q] << 8 | d[q + 1]);
    };
    auto rd32 = [&](size_t q) -> uint32_t {
      return le ? (uint32_t)(d[q] | d[q + 1] << 8 | d[q + 2] << 16
                             | (uint32_t)d[q + 3] << 24)
                : ((uint32_t)d[q] << 24 | d[q + 1] << 16 | d[q + 2] << 8
                   | d[q + 3]);
    };
    uint32_t ifd = rd32(t + 4);
    if (t + ifd + 2 > end) return true;
    int count = rd16(t + ifd);
    for (int i = 0; i < count; ++i) {
      size_t e = t + ifd + 2 + 12 * (size_t)i;
      if (e + 12 > end) break;
      if (rd16(e) == 0x0112) {
        orientation = rd16(e + 8);
        break;
      }
    }
    return true;
  }

  bool decode_scan(size_t p, size_t end) {
    if (!frame_seen) return fail("scan before the frame header");
    int ns = d[p];
    if (ns < 1 || ns > 4 || end - p < (size_t)(4 + 2 * ns))
      return fail("bad scan header");
    Component *sc[4];
    for (int i = 0; i < ns; ++i) {
      int cid = d[p + 1 + 2 * i], tables = d[p + 2 + 2 * i];
      sc[i] = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == cid) sc[i] = &comp[j];
      if (!sc[i]) return fail("scan names an unknown component");
      sc[i]->td = tables >> 4;
      sc[i]->ta = tables & 15;
      if (sc[i]->td > 3 || sc[i]->ta > 3) return fail("bad table id");
      if (!dc[sc[i]->td].present || !ac[sc[i]->ta].present)
        return fail("scan uses an undefined Huffman table");
      if (!qset[sc[i]->tq])
        return fail("component uses an undefined quantization table");
    }
    size_t q = p + 1 + 2 * ns;
    int ss = d[q], se = d[q + 1], ahal = d[q + 2];
    if (ss != 0 || se != 63 || ahal != 0)
      return fail("spectral selection or successive approximation in a "
                  "sequential scan");
    pos = end;
    reset_bits();
    for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
    int mcus_x, mcus_y;
    if (ns == 1) {   // non-interleaved: an MCU is one block
      mcus_x = (sc[0]->dw + 7) / 8;
      mcus_y = (sc[0]->dh + 7) / 8;
    } else {
      mcus_x = mcux;
      mcus_y = mcuy;
    }
    int64_t total = (int64_t)mcus_x * mcus_y;
    int64_t todo = restart_interval;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval && todo == 0) {
        if (!restart()) return false;
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        todo = restart_interval;
      }
      int my = (int)(m / mcus_x), mx = (int)(m % mcus_x);
      if (ns == 1) {
        Component &c = *sc[0];
        decode_block(c, &c.coef[((size_t)my * c.bw + mx) * 64]);
      } else {
        for (int i = 0; i < ns; ++i) {
          Component &c = *sc[i];
          for (int by = 0; by < c.v; ++by)
            for (int bx = 0; bx < c.h; ++bx) {
              size_t row = (size_t)my * c.v + by, col = (size_t)mx * c.h + bx;
              decode_block(c, &c.coef[(row * c.bw + col) * 64]);
            }
        }
      }
      --todo;
    }
    any_scan = true;
    skip_to_marker();
    return true;
  }

  bool parse() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return fail("not a JPEG file");
    pos = 2;
    while (true) {
      while (pos < n && d[pos] != 0xFF) ++pos;   // garbage between markers
      while (pos < n && d[pos] == 0xFF) ++pos;   // fill bytes
      if (pos >= n) break;                       // no EOI: as libjpeg, stop
      int marker = d[pos++];
      if (marker == 0xD9) break;
      if (marker == 0xD8 || marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7))
        continue;
      if (pos + 2 > n) return fail("truncated marker segment");
      size_t len = (size_t)u16(pos);
      if (len < 2 || pos + len > n) return fail("truncated marker segment");
      size_t p = pos + 2, end = pos + len;
      pos = end;
      switch (marker) {
        case 0xC0:
        case 0xC1:
          if (!parse_sof(p, end)) return false;
          break;
        case 0xC2:
        case 0xC6:
        case 0xCA:
        case 0xCE:
          return fail("progressive JPEG is not supported");
        case 0xC3:
        case 0xC5:
        case 0xC7:
        case 0xCB:
        case 0xCF:
          return fail("lossless or hierarchical JPEG is not supported");
        case 0xC9:
        case 0xCC:
        case 0xCD:
          return fail("arithmetic-coded JPEG is not supported");
        case 0xC4:
          if (!parse_dht(p, end)) return false;
          break;
        case 0xDB:
          if (!parse_dqt(p, end)) return false;
          break;
        case 0xDD:
          if (end - p < 2) return fail("truncated DRI segment");
          restart_interval = u16(p);
          break;
        case 0xDA:
          if (!decode_scan(p, end)) return false;
          break;
        case 0xE1:
          parse_exif(p, end);
          break;
        case 0xEE:
          if (end - p >= 12 && std::memcmp(d + p, "Adobe", 5) == 0)
            adobe_transform = d[p + 11];
          break;
        default:
          break;   // APPn, COM, DNL: nothing the decode needs
      }
    }
    if (!frame_seen) return fail("no frame header");
    if (!any_scan) return fail("no scan");
    if (ncomp == 3 && adobe_transform == 0)
      return fail("Adobe RGB (untransformed) JPEG is not supported");
    if (orientation != 1)
      return fail("EXIF orientation " + std::to_string(orientation)
                  + " is not applied by this decoder (1 only)");
    return true;
  }

  // jidctint.c jpeg_idct_islow, the output range-limited to 0..255 as
  // libjpeg-turbo's SIMD version saturates
  static void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out,
                         int stride) {
    const int CB = 13, P1 = 2;
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t *ip = in + c;
      const uint16_t *qp = q + c;
      int *wp = ws + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48]
          && !ip[56]) {
        int dcv = (int)((int64_t)ip[0] * qp[0] * (1 << P1));
        for (int r = 0; r < 8; ++r) wp[8 * r] = dcv;
        continue;
      }
      int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = (int64_t)ip[0] * qp[0];
      z3 = (int64_t)ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << CB);
      int64_t tmp1 = (z2 - z3) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = (int64_t)ip[56] * qp[56];
      tmp1 = (int64_t)ip[40] * qp[40];
      tmp2 = (int64_t)ip[24] * qp[24];
      tmp3 = (int64_t)ip[8] * qp[8];
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
      const int sh = CB - P1;
      const int64_t rnd = (int64_t)1 << (sh - 1);
      wp[0] = (int)((tmp10 + tmp3 + rnd) >> sh);
      wp[56] = (int)((tmp10 - tmp3 + rnd) >> sh);
      wp[8] = (int)((tmp11 + tmp2 + rnd) >> sh);
      wp[48] = (int)((tmp11 - tmp2 + rnd) >> sh);
      wp[16] = (int)((tmp12 + tmp1 + rnd) >> sh);
      wp[40] = (int)((tmp12 - tmp1 + rnd) >> sh);
      wp[24] = (int)((tmp13 + tmp0 + rnd) >> sh);
      wp[32] = (int)((tmp13 - tmp0 + rnd) >> sh);
    }
    auto clamp = [](int64_t x) -> uint8_t {
      x += 128;
      return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
    };
    for (int r = 0; r < 8; ++r) {
      const int *wp = ws + 8 * r;
      uint8_t *op = out + (size_t)r * stride;
      const int sh = CB + P1 + 3;
      const int64_t rnd = (int64_t)1 << (sh - 1);
      // (the all-zero-AC shortcut of jidctint.c gives the same values)
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CB);
      int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
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
      op[0] = clamp((tmp10 + tmp3 + rnd) >> sh);
      op[7] = clamp((tmp10 - tmp3 + rnd) >> sh);
      op[1] = clamp((tmp11 + tmp2 + rnd) >> sh);
      op[6] = clamp((tmp11 - tmp2 + rnd) >> sh);
      op[2] = clamp((tmp12 + tmp1 + rnd) >> sh);
      op[5] = clamp((tmp12 - tmp1 + rnd) >> sh);
      op[3] = clamp((tmp13 + tmp0 + rnd) >> sh);
      op[4] = clamp((tmp13 - tmp0 + rnd) >> sh);
    }
  }

  void inverse_transform() {
    for (int i = 0; i < ncomp; ++i) {
      Component &c = comp[i];
      int stride = c.bw * 8;
      c.plane.assign((size_t)stride * c.bh * 8, 0);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], qt[c.tq],
                     &c.plane[(size_t)by * 8 * stride + (size_t)bx * 8],
                     stride);
      std::vector<int16_t>().swap(c.coef);
    }
  }

  // component i at full resolution, row y (width samples) into `out`:
  // jdsample.c's fancy upsampling for h2v1 / h2v2, box where the
  // component is 2 samples wide or less (as libjpeg-turbo chooses)
  void upsampled_row(int i, int y, uint8_t *out) const {
    const Component &c = comp[i];
    int stride = c.bw * 8;
    int ex = hmax / c.h, ey = vmax / c.v;
    int dw = c.dw;
    if (ex == 1 && ey == 1) {
      std::memcpy(out, &c.plane[(size_t)y * stride], (size_t)width);
      return;
    }
    std::vector<uint8_t> tmp((size_t)2 * dw + 2);
    uint8_t *o = tmp.data();
    if (dw <= 2) {   // box upsampling
      const uint8_t *ip = &c.plane[(size_t)(y / ey) * stride];
      for (int x = 0; x < dw; ++x) o[2 * x] = o[2 * x + 1] = ip[x];
    } else if (ey == 1) {   // h2v1
      const uint8_t *ip = &c.plane[(size_t)y * stride];
      int iv = ip[0];
      o[0] = (uint8_t)iv;
      o[1] = (uint8_t)((iv * 3 + ip[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        iv = ip[x] * 3;
        o[2 * x] = (uint8_t)((iv + ip[x - 1] + 1) >> 2);
        o[2 * x + 1] = (uint8_t)((iv + ip[x + 1] + 2) >> 2);
      }
      iv = ip[dw - 1];
      o[2 * dw - 2] = (uint8_t)((iv * 3 + ip[dw - 2] + 1) >> 2);
      o[2 * dw - 1] = (uint8_t)iv;
    } else {   // h2v2: the nearer row 3/4, the further 1/4, edges replicated
      int r = y / 2;
      int other = (y % 2 == 0) ? r - 1 : r + 1;
      if (other < 0) other = 0;
      if (other > c.dh - 1) other = c.dh - 1;
      const uint8_t *i0 = &c.plane[(size_t)r * stride];
      const uint8_t *i1 = &c.plane[(size_t)other * stride];
      int this_sum = i0[0] * 3 + i1[0];
      int next_sum = i0[1] * 3 + i1[1];
      o[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
      o[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int x = 1; x < dw - 1; ++x) {
        next_sum = i0[x + 1] * 3 + i1[x + 1];
        o[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        o[2 * x + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      o[2 * dw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      o[2 * dw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
    }
    std::memcpy(out, o, (size_t)width);
  }

  // jdcolor.c ycc_rgb_convert (or the gray plane), rows of RGB or gray
  void to_pixels(uint8_t *out) const {
    if (ncomp == 1) {
      std::vector<uint8_t> row((size_t)width);
      for (int y = 0; y < height; ++y) {
        upsampled_row(0, y, row.data());
        std::memcpy(out + (size_t)y * width, row.data(), (size_t)width);
      }
      return;
    }
    const int SB = 16;
    const int64_t HALF = (int64_t)1 << (SB - 1);
    auto fix = [](double x) -> int64_t {
      return (int64_t)(x * (double)(1 << 16) + 0.5);
    };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    auto lim = [](int v) -> uint8_t {
      return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    std::vector<uint8_t> yr((size_t)width), cbr((size_t)width),
        crr((size_t)width);
    for (int y = 0; y < height; ++y) {
      upsampled_row(0, y, yr.data());
      upsampled_row(1, y, cbr.data());
      upsampled_row(2, y, crr.data());
      uint8_t *op = out + (size_t)y * width * 3;
      for (int x = 0; x < width; ++x) {
        int yy = yr[x], cb = cbr[x], cr = crr[x];
        op[3 * x] = lim(yy + cr_r[cr]);
        op[3 * x + 1] = lim(yy + (int)((cb_g[cb] + cr_g[cr]) >> SB));
        op[3 * x + 2] = lim(yy + cb_b[cb]);
      }
    }
  }
};

// ---------------------------------------------------------------- encoder

const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
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
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
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
// ITU T.81 K.1 / K.2, natural order
const int kStdLumQ[64] = {
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChromQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

struct HuffCode {
  uint16_t code[256];
  uint8_t size[256];

  bool build(const uint8_t *bits, const uint8_t *vals) {
    std::memset(size, 0, sizeof(size));
    int code_v = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k, ++code_v) {
        code[vals[k]] = (uint16_t)code_v;
        size[vals[k]] = (uint8_t)l;
      }
      code_v <<= 1;
    }
    return true;
  }
};

struct BitWriter {
  std::vector<uint8_t> &out;
  uint32_t acc = 0;
  int cnt = 0;

  explicit BitWriter(std::vector<uint8_t> &o) : out(o) {}

  void put(uint32_t v, int k) {
    if (k == 0) return;
    acc = (acc << k) | (v & ((1u << k) - 1));
    cnt += k;
    while (cnt >= 8) {
      uint8_t b = (uint8_t)(acc >> (cnt - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0x00);
      cnt -= 8;
    }
    acc &= (1u << cnt) - 1;
  }

  void flush() {   // pad the last byte with 1 bits
    if (cnt > 0) put((1u << (8 - cnt)) - 1, 8 - cnt);
  }
};

// jfdctint.c jpeg_fdct_islow on level-shifted samples; output scaled by 8
void fdct_islow(int *data) {
  const int CB = 13, P1 = 2;
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
  auto descale = [](int64_t x, int nb) -> int {
    return (int)((x + ((int64_t)1 << (nb - 1))) >> nb);
  };
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < 8; ++i) {
      int *p = pass == 0 ? data + 8 * i : data + i;
      int st = pass == 0 ? 1 : 8;
      int64_t tmp0 = p[0] + p[7 * st], tmp7 = p[0] - p[7 * st];
      int64_t tmp1 = p[st] + p[6 * st], tmp6 = p[st] - p[6 * st];
      int64_t tmp2 = p[2 * st] + p[5 * st], tmp5 = p[2 * st] - p[5 * st];
      int64_t tmp3 = p[3 * st] + p[4 * st], tmp4 = p[3 * st] - p[4 * st];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        p[0] = (int)((tmp10 + tmp11) * (1 << P1));
        p[4 * st] = (int)((tmp10 - tmp11) * (1 << P1));
      } else {
        p[0] = descale(tmp10 + tmp11, P1);
        p[4 * st] = descale(tmp10 - tmp11, P1);
      }
      int sh = pass == 0 ? CB - P1 : CB + P1;
      int64_t z1 = (tmp12 + tmp13) * F0541;
      p[2 * st] = descale(z1 + tmp13 * F0765, sh);
      p[6 * st] = descale(z1 + tmp12 * (-F1847), sh);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      p[7 * st] = descale(tmp4 + z1 + z3, sh);
      p[5 * st] = descale(tmp5 + z2 + z4, sh);
      p[3 * st] = descale(tmp6 + z2 + z3, sh);
      p[st] = descale(tmp7 + z1 + z4, sh);
    }
  }
}

void quant_table(const int *base, int quality, uint16_t *out) {
  // jcparam.c jpeg_quality_scaling + jpeg_add_quant_table (baseline)
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = ((long)base[i] * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;
    out[i] = (uint16_t)t;
  }
}

struct Plane {
  int w = 0, h = 0;   // padded to whole blocks of the MCU grid
  std::vector<uint8_t> px;
};

void encode_block(const uint8_t *src, int stride, const uint16_t *q, int &pred,
                  const HuffCode &dc, const HuffCode &ac, BitWriter &bw) {
  int blk[64];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c)
      blk[8 * r + c] = (int)src[(size_t)r * stride + c] - 128;
  fdct_islow(blk);
  int qc[64];
  for (int i = 0; i < 64; ++i) {   // jcdctmgr.c: divisor = q * 8, rounded
    int qv = q[i] * 8;
    int t = blk[i];
    qc[i] = t < 0 ? -((-t + (qv >> 1)) / qv) : (t + (qv >> 1)) / qv;
  }
  auto nbits = [](int v) {
    int a = v < 0 ? -v : v, k = 0;
    while (a) {
      ++k;
      a >>= 1;
    }
    return k;
  };
  int diff = qc[0] - pred;
  pred = qc[0];
  int s = nbits(diff);
  bw.put(dc.code[s], dc.size[s]);
  bw.put((uint32_t)(diff < 0 ? diff - 1 : diff), s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = qc[g_natural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    s = nbits(v);
    int sym = (run << 4) | s;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put((uint32_t)(v < 0 ? v - 1 : v), s);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0x00], ac.size[0x00]);
}

void put16(std::vector<uint8_t> &o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)(v & 0xFF));
}

void put_dht(std::vector<uint8_t> &o, int id, const uint8_t *bits,
             const uint8_t *vals) {
  int total = 0;
  for (int l = 1; l <= 16; ++l) total += bits[l];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + total);
  o.push_back((uint8_t)id);
  for (int l = 1; l <= 16; ++l) o.push_back(bits[l]);
  for (int i = 0; i < total; ++i) o.push_back(vals[i]);
}

int jpeg_encode(const uint8_t *pix, int h, int w, int c, int quality,
                uint8_t **out, int64_t *len, char *err, int errlen);

}  // namespace

extern "C" {

void nst_free(void *p) { std::free(p); }

// Undo the row filters of a non-interlaced PNG image: `raw` holds h rows of
// one filter byte plus `rowbytes` bytes; `bpp` is the bytes per pixel
// (at least 1).  Writes h * rowbytes bytes to `out`.
int nst_png_unfilter(const uint8_t *raw, int64_t raw_len, int h,
                     int64_t rowbytes, int bpp, uint8_t *out, char *err,
                     int errlen) {
  if (raw_len < (int64_t)h * (rowbytes + 1)) {
    set_err(err, errlen, "image data too short for the header's size");
    return 1;
  }
  for (int y = 0; y < h; ++y) {
    const uint8_t *src = raw + (int64_t)y * (rowbytes + 1);
    int f = src[0];
    ++src;
    uint8_t *dst = out + (int64_t)y * rowbytes;
    const uint8_t *up = y ? dst - rowbytes : nullptr;
    switch (f) {
      case 0:
        std::memcpy(dst, src, (size_t)rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          dst[i] = (uint8_t)(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i)
          dst[i] = (uint8_t)(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0, b = up ? up[i] : 0;
          dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0, b = up ? up[i] : 0;
          int c = (up && i >= bpp) ? up[i - bpp] : 0;
          dst[i] = (uint8_t)(src[i] + paeth(a, b, c));
        }
        break;
      default:
        set_err(err, errlen, "unknown PNG row filter " + std::to_string(f));
        return 1;
    }
  }
  return 0;
}

// Decode a JPEG held in memory.  On success *out is a malloc'd buffer of
// h * w * c bytes (c = 3, RGB, for a YCbCr file; c = 1 for a grayscale
// one), freed with nst_free.
int nst_jpeg_decode(const uint8_t *data, int64_t len, uint8_t **out, int *h,
                    int *w, int *c, char *err, int errlen) {
  *out = nullptr;
  try {
    JpegDecoder dec(data, (size_t)len);
    if (!dec.parse()) {
      set_err(err, errlen, dec.err);
      return 1;
    }
    dec.inverse_transform();
    size_t bytes = (size_t)dec.width * dec.height * dec.ncomp;
    uint8_t *buf = (uint8_t *)std::malloc(bytes);
    if (!buf) {
      set_err(err, errlen, "out of memory");
      return 1;
    }
    dec.to_pixels(buf);
    *out = buf;
    *h = dec.height;
    *w = dec.width;
    *c = dec.ncomp;
    return 0;
  } catch (const std::exception &e) {   // std::bad_alloc of a huge frame
    set_err(err, errlen, std::string("decode failed: ") + e.what());
    return 1;
  }
}

// Encode h x w pixels (c = 3: RGB, 4:2:0; c = 1: grayscale) as a baseline
// JPEG of the given quality.  On success *out is a malloc'd buffer of *len
// bytes, freed with nst_free.
int nst_jpeg_encode(const uint8_t *pix, int h, int w, int c, int quality,
                    uint8_t **out, int64_t *len, char *err, int errlen) {
  *out = nullptr;
  try {
    return jpeg_encode(pix, h, w, c, quality, out, len, err, errlen);
  } catch (const std::exception &e) {
    set_err(err, errlen, std::string("encode failed: ") + e.what());
    return 1;
  }
}

}  // extern "C"

namespace {

int jpeg_encode(const uint8_t *pix, int h, int w, int c, int quality,
                uint8_t **out, int64_t *len, char *err, int errlen) {
  if (h <= 0 || w <= 0 || h > 65535 || w > 65535 || (c != 1 && c != 3)) {
    set_err(err, errlen, "unsupported image size or channel count");
    return 1;
  }
  uint16_t q[2][64];
  quant_table(kStdLumQ, quality, q[0]);
  quant_table(kStdChromQ, quality, q[1]);
  int hs = c == 3 ? 2 : 1;   // luma sampling factor (h and v)
  int mcu = 8 * hs;
  int mcux = (w + mcu - 1) / mcu, mcuy = (h + mcu - 1) / mcu;

  // color conversion (jccolor.c rgb_ycc_convert), planes padded to whole
  // MCUs by replicating the last column and row
  const int64_t HALF = (int64_t)1 << 15;
  auto fix = [](double x) -> int64_t {
    return (int64_t)(x * (double)(1 << 16) + 0.5);
  };
  Plane y_pl, cb_pl, cr_pl;
  y_pl.w = mcux * mcu;
  y_pl.h = mcuy * mcu;
  y_pl.px.resize((size_t)y_pl.w * y_pl.h);
  std::vector<uint8_t> cbf, crf;
  if (c == 3) {
    cbf.resize(y_pl.px.size());
    crf.resize(y_pl.px.size());
  }
  for (int yy = 0; yy < y_pl.h; ++yy) {
    int sy = yy < h ? yy : h - 1;
    for (int xx = 0; xx < y_pl.w; ++xx) {
      int sx = xx < w ? xx : w - 1;
      const uint8_t *p = pix + ((size_t)sy * w + sx) * c;
      size_t o = (size_t)yy * y_pl.w + xx;
      if (c == 1) {
        y_pl.px[o] = p[0];
        continue;
      }
      int64_t r = p[0], g = p[1], b = p[2];
      y_pl.px[o] = (uint8_t)((fix(0.29900) * r + fix(0.58700) * g
                              + fix(0.11400) * b + HALF) >> 16);
      cbf[o] = (uint8_t)((-fix(0.16874) * r - fix(0.33126) * g
                          + fix(0.50000) * b + ((int64_t)128 << 16) + HALF - 1)
                         >> 16);
      crf[o] = (uint8_t)((fix(0.50000) * r - fix(0.41869) * g
                          - fix(0.08131) * b + ((int64_t)128 << 16) + HALF - 1)
                         >> 16);
    }
  }
  if (c == 3) {   // jcsample.c h2v2_downsample: 2x2 means, bias 1, 2, 1, ...
    for (Plane *pl : {&cb_pl, &cr_pl}) {
      pl->w = y_pl.w / 2;
      pl->h = y_pl.h / 2;
      pl->px.resize((size_t)pl->w * pl->h);
    }
    for (int yy = 0; yy < cb_pl.h; ++yy) {
      int bias = 1;
      for (int xx = 0; xx < cb_pl.w; ++xx) {
        size_t a = (size_t)(2 * yy) * y_pl.w + 2 * xx, b = a + y_pl.w;
        size_t o = (size_t)yy * cb_pl.w + xx;
        cb_pl.px[o] = (uint8_t)((cbf[a] + cbf[a + 1] + cbf[b] + cbf[b + 1]
                                 + bias) >> 2);
        cr_pl.px[o] = (uint8_t)((crf[a] + crf[a + 1] + crf[b] + crf[b + 1]
                                 + bias) >> 2);
        bias ^= 3;
      }
    }
  }

  HuffCode dc_l, ac_l, dc_c, ac_c;
  dc_l.build(kDcLumBits, kDcVals);
  ac_l.build(kAcLumBits, kAcLumVals);
  dc_c.build(kDcChromBits, kDcVals);
  ac_c.build(kAcChromBits, kAcChromVals);

  std::vector<uint8_t> o;
  o.reserve((size_t)w * h * c / 2 + 1024);
  o.push_back(0xFF);
  o.push_back(0xD8);
  const uint8_t jfif[] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                          0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00,
                          0x00};
  o.insert(o.end(), jfif, jfif + sizeof(jfif));
  for (int t = 0; t < (c == 3 ? 2 : 1); ++t) {
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 2 + 1 + 64);
    o.push_back((uint8_t)t);
    for (int k = 0; k < 64; ++k) o.push_back((uint8_t)q[t][g_natural[k]]);
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 8 + 3 * c);
  o.push_back(8);
  put16(o, h);
  put16(o, w);
  o.push_back((uint8_t)c);
  for (int i = 0; i < c; ++i) {
    o.push_back((uint8_t)(i + 1));
    o.push_back((uint8_t)(i == 0 ? (hs << 4 | hs) : 0x11));
    o.push_back((uint8_t)(i == 0 ? 0 : 1));
  }
  put_dht(o, 0x00, kDcLumBits, kDcVals);
  put_dht(o, 0x10, kAcLumBits, kAcLumVals);
  if (c == 3) {
    put_dht(o, 0x01, kDcChromBits, kDcVals);
    put_dht(o, 0x11, kAcChromBits, kAcChromVals);
  }
  o.push_back(0xFF);
  o.push_back(0xDA);
  put16(o, 6 + 2 * c);
  o.push_back((uint8_t)c);
  for (int i = 0; i < c; ++i) {
    o.push_back((uint8_t)(i + 1));
    o.push_back((uint8_t)(i == 0 ? 0x00 : 0x11));
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  BitWriter bw(o);
  int pred[3] = {0, 0, 0};
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx) {
      for (int by = 0; by < hs; ++by)
        for (int bx = 0; bx < hs; ++bx) {
          size_t off = (size_t)(my * mcu + 8 * by) * y_pl.w + mx * mcu + 8 * bx;
          encode_block(&y_pl.px[off], y_pl.w, q[0], pred[0], dc_l, ac_l, bw);
        }
      if (c == 3) {
        size_t off = (size_t)(my * 8) * cb_pl.w + mx * 8;
        encode_block(&cb_pl.px[off], cb_pl.w, q[1], pred[1], dc_c, ac_c, bw);
        encode_block(&cr_pl.px[off], cr_pl.w, q[1], pred[2], dc_c, ac_c, bw);
      }
    }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);

  uint8_t *buf = (uint8_t *)std::malloc(o.size());
  if (!buf) {
    set_err(err, errlen, "out of memory");
    return 1;
  }
  std::memcpy(buf, o.data(), o.size());
  *out = buf;
  *len = (int64_t)o.size();
  return 0;
}

}  // namespace
