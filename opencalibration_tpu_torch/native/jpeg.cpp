// JPEG decoder and encoder for 8-bit images, with a plain C interface for
// ctypes.
//
// The decoder reads baseline (SOF0), extended-Huffman 8-bit (SOF1) and
// progressive (SOF2, spectral selection and successive approximation) files
// with one or three components, restart intervals, and luma sampling 1x1,
// 2x1, 1x2 or 2x2 over 1x1 chroma. It reproduces libjpeg's integer paths
// so that its output equals what OpenCV's imread (libjpeg-turbo) gives:
// the "islow" inverse DCT (jidctint.c), the "fancy" triangle upsampling
// (jdsample.c) and the fixed-point YCbCr -> RGB tables (jdcolor.c). The
// EXIF Orientation tag of an APP1 segment is applied as imread applies it.
//
// The encoder writes a baseline file as imencode(".jpg") does at its
// defaults: a JFIF APP0 header, the standard quantisation tables scaled to
// the quality, the standard Huffman tables, 4:2:0 sampling for three
// channels, the "islow" forward DCT (jfdctint.c) with libjpeg-turbo's
// reciprocal quantisation, and jcsample.c's h2v2 downsampling.
//
// Pixels are B, G, R in memory for three channels, as in OpenCV.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {  // zigzag index -> natural index
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

enum { OK = 0, MALFORMED = 1, UNSUPPORTED = 2 };

// ---------------------------------------------------------------- IDCT ----
const int CONST_BITS = 13, PASS1_BITS = 2;
const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// jidctint.c's post-IDCT range limit: the 10-bit wrap of the table
inline uint8_t idct_limit(int32_t v) {
    int m = v & 1023;
    if (m < 128) return (uint8_t)(128 + m);
    if (m < 512) return 255;
    if (m < 896) return 0;
    return (uint8_t)(m - 896);
}

void idct_islow(const int16_t *coef, const uint16_t *q, uint8_t *out, int stride) {
    int32_t ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t *in = coef + c;
        const uint16_t *qt = q + c;
        int32_t *w = ws + c;
        if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
            int32_t dc = (int32_t)(in[0] * qt[0]) * (1 << PASS1_BITS);
            for (int k = 0; k < 8; k++) w[8 * k] = dc;
            continue;
        }
        int32_t z2 = in[16] * qt[16], z3 = in[48] * qt[48];
        int32_t z1 = (z2 + z3) * FIX_0_541196100;
        int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
        int32_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = in[0] * qt[0];
        z3 = in[32] * qt[32];
        int32_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int32_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = in[56] * qt[56];
        tmp1 = in[40] * qt[40];
        tmp2 = in[24] * qt[24];
        tmp3 = in[8] * qt[8];
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
        const int sh = CONST_BITS - PASS1_BITS;
        w[0] = descale(tmp10 + tmp3, sh);
        w[56] = descale(tmp10 - tmp3, sh);
        w[8] = descale(tmp11 + tmp2, sh);
        w[48] = descale(tmp11 - tmp2, sh);
        w[16] = descale(tmp12 + tmp1, sh);
        w[40] = descale(tmp12 - tmp1, sh);
        w[24] = descale(tmp13 + tmp0, sh);
        w[32] = descale(tmp13 - tmp0, sh);
    }
    const int sh = CONST_BITS + PASS1_BITS + 3;
    for (int r = 0; r < 8; r++) {
        const int32_t *w = ws + 8 * r;
        uint8_t *o = out + (size_t)r * stride;
        if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
            uint8_t v = idct_limit(descale(w[0], PASS1_BITS + 3));
            for (int k = 0; k < 8; k++) o[k] = v;
            continue;
        }
        int32_t z2 = w[2], z3 = w[6];
        int32_t z1 = (z2 + z3) * FIX_0_541196100;
        int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
        int32_t tmp3 = z1 + z2 * FIX_0_765366865;
        int32_t tmp0 = (w[0] + w[4]) * (1 << CONST_BITS);
        int32_t tmp1 = (w[0] - w[4]) * (1 << CONST_BITS);
        int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
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
        o[0] = idct_limit(descale(tmp10 + tmp3, sh));
        o[7] = idct_limit(descale(tmp10 - tmp3, sh));
        o[1] = idct_limit(descale(tmp11 + tmp2, sh));
        o[6] = idct_limit(descale(tmp11 - tmp2, sh));
        o[2] = idct_limit(descale(tmp12 + tmp1, sh));
        o[5] = idct_limit(descale(tmp12 - tmp1, sh));
        o[3] = idct_limit(descale(tmp13 + tmp0, sh));
        o[4] = idct_limit(descale(tmp13 - tmp0, sh));
    }
}

// ------------------------------------------------------------- decoder ----
struct Huff {
    bool present = false;
    uint8_t vals[256];
    int32_t maxcode[18];
    int32_t valoff[18];
    uint16_t look[512];  // (length << 8) | value for codes of <= 9 bits, 0 if longer
};

bool build_huff(Huff &h, const uint8_t *bits, const uint8_t *vals, int nvals) {
    memcpy(h.vals, vals, nvals);
    memset(h.look, 0, sizeof(h.look));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
        h.valoff[l] = k - code;
        for (int i = 0; i < bits[l - 1]; i++, k++, code++) {
            if (l <= 9) {
                int shift = 9 - l;
                for (int j = 0; j < (1 << shift); j++) h.look[(code << shift) | j] = (uint16_t)((l << 8) | vals[k]);
            }
        }
        h.maxcode[l] = bits[l - 1] ? code - 1 : -1;
        if (code > (1 << l)) return false;
        code <<= 1;
    }
    h.maxcode[17] = 0x7fffffff;
    h.present = true;
    return true;
}

struct Comp {
    int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
    int bw = 0, bh = 0;    // blocks allocated (MCU padding included)
    int wib = 0, hib = 0;  // width / height in blocks
    int dsw = 0, dsh = 0;  // downsampled width / height
    int dc_pred = 0;
    std::vector<int16_t> coef;
};

struct Decoder {
    const uint8_t *p;
    size_t n, pos = 0;
    uint16_t q[4][64];
    Huff dc[4], ac[4];
    Comp c[3];
    int nc = 0, W = 0, H = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    bool progressive = false, have_frame = false;
    int restart = 0, orientation = 1;
    bool jfif = false, adobe = false;
    int adobe_transform = -1;
    uint32_t bitbuf = 0;
    int bitcnt = 0;
    bool marker_hit = false;
    int eobrun = 0;

    int u16(size_t o) const { return (p[o] << 8) | p[o + 1]; }

    void fill() {
        while (bitcnt <= 24) {
            uint32_t b = 0;
            if (!marker_hit && pos < n) {
                b = p[pos];
                if (b == 0xFF) {
                    uint8_t nx = pos + 1 < n ? p[pos + 1] : 0xD9;
                    if (nx == 0x00) {
                        pos += 2;
                    } else {
                        marker_hit = true;
                        b = 0;
                    }
                } else {
                    pos++;
                }
            }
            bitbuf |= b << (24 - bitcnt);
            bitcnt += 8;
        }
    }
    int bits(int k) {
        if (k == 0) return 0;
        fill();
        int v = (int)(bitbuf >> (32 - k));
        bitbuf <<= k;
        bitcnt -= k;
        return v;
    }
    int huff(const Huff &h) {
        fill();
        uint16_t e = h.look[bitbuf >> 23];
        if (e) {
            int l = e >> 8;
            bitbuf <<= l;
            bitcnt -= l;
            return e & 0xFF;
        }
        for (int l = 10; l <= 16; l++) {
            int32_t code = (int32_t)(bitbuf >> (32 - l));
            if (code <= h.maxcode[l]) {
                bitbuf <<= l;
                bitcnt -= l;
                return h.vals[h.valoff[l] + code];
            }
        }
        bitbuf <<= 16;  // corrupt data: libjpeg warns and returns 0
        bitcnt -= 16;
        return 0;
    }
    static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

    void reset_bits() {
        bitbuf = 0;
        bitcnt = 0;
    }

    void restart_marker() {
        reset_bits();
        while (pos + 1 < n && !(p[pos] == 0xFF && p[pos + 1] >= 0xD0 && p[pos + 1] <= 0xD7)) pos++;
        if (pos + 1 < n) pos += 2;
        marker_hit = false;
        for (int i = 0; i < nc; i++) c[i].dc_pred = 0;
        eobrun = 0;
    }

    // ---- headers
    int parse_app1(size_t off, int len) {
        if (len < 14 || memcmp(p + off, "Exif\0\0", 6) != 0) return OK;
        const uint8_t *t = p + off + 6;
        size_t tn = len - 6;
        bool le = t[0] == 'I';
        auto r16 = [&](size_t o) -> int {
            if (o + 2 > tn) return 0;
            return le ? t[o] | t[o + 1] << 8 : t[o] << 8 | t[o + 1];
        };
        auto r32 = [&](size_t o) -> uint32_t {
            if (o + 4 > tn) return 0;
            return le ? (uint32_t)t[o] | (uint32_t)t[o + 1] << 8 | (uint32_t)t[o + 2] << 16 | (uint32_t)t[o + 3] << 24
                      : (uint32_t)t[o] << 24 | (uint32_t)t[o + 1] << 16 | (uint32_t)t[o + 2] << 8 | (uint32_t)t[o + 3];
        };
        size_t ifd = r32(4);
        int count = r16(ifd);
        for (int i = 0; i < count; i++) {
            size_t e = ifd + 2 + (size_t)i * 12;
            if (e + 12 > tn) break;
            if (r16(e) == 0x0112 && r16(e + 2) == 3) {
                int o = r16(e + 8);
                if (o >= 1 && o <= 8) orientation = o;
            }
        }
        return OK;
    }

    int parse_dqt(size_t off, int len) {
        size_t end = off + len;
        while (off < end) {
            int pq = p[off] >> 4, tq = p[off] & 15;
            if (tq > 3) return MALFORMED;
            off++;
            for (int i = 0; i < 64; i++) {
                if (pq) {
                    q[tq][kZigzag[i]] = (uint16_t)u16(off);
                    off += 2;
                } else {
                    q[tq][kZigzag[i]] = p[off++];
                }
            }
        }
        return off == end ? OK : MALFORMED;
    }

    int parse_dht(size_t off, int len) {
        size_t end = off + len;
        while (off + 17 <= end) {
            int tc = p[off] >> 4, th = p[off] & 15;
            if (tc > 1 || th > 3) return MALFORMED;
            const uint8_t *counts = p + off + 1;
            int total = 0;
            for (int i = 0; i < 16; i++) total += counts[i];
            if (total > 256 || off + 17 + total > end) return MALFORMED;
            if (!build_huff(tc ? ac[th] : dc[th], counts, p + off + 17, total)) return MALFORMED;
            off += 17 + total;
        }
        return OK;
    }

    int parse_sof(size_t off, int len, int marker) {
        if (have_frame) return MALFORMED;
        if (len < 6) return MALFORMED;
        if (p[off] != 8) return UNSUPPORTED;  // 12-bit samples
        H = u16(off + 1);
        W = u16(off + 3);
        nc = p[off + 5];
        if (W == 0 || H == 0) return UNSUPPORTED;  // height from a DNL marker
        if (nc != 1 && nc != 3) return UNSUPPORTED;
        if (len < 6 + 3 * nc) return MALFORMED;
        progressive = marker == 0xC2;
        hmax = vmax = 1;
        for (int i = 0; i < nc; i++) {
            Comp &k = c[i];
            k.id = p[off + 6 + 3 * i];
            k.h = p[off + 7 + 3 * i] >> 4;
            k.v = p[off + 7 + 3 * i] & 15;
            k.tq = p[off + 8 + 3 * i] & 3;
            if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4) return MALFORMED;
            if (k.h > hmax) hmax = k.h;
            if (k.v > vmax) vmax = k.v;
        }
        if (nc == 1) c[0].h = c[0].v = hmax = vmax = 1;  // a one-component frame is never subsampled
        if (hmax > 2 || vmax > 2) return UNSUPPORTED;
        for (int i = 1; i < nc; i++)
            if (c[i].h != 1 || c[i].v != 1) return UNSUPPORTED;
        mcux = (W + 8 * hmax - 1) / (8 * hmax);
        mcuy = (H + 8 * vmax - 1) / (8 * vmax);
        for (int i = 0; i < nc; i++) {
            Comp &k = c[i];
            k.dsw = (W * k.h + hmax - 1) / hmax;
            k.dsh = (H * k.v + vmax - 1) / vmax;
            k.wib = (k.dsw + 7) / 8;
            k.hib = (k.dsh + 7) / 8;
            k.bw = mcux * k.h;
            k.bh = mcuy * k.v;
            k.coef.assign((size_t)k.bw * k.bh * 64, 0);
        }
        have_frame = true;
        return OK;
    }

    // ---- entropy-coded segments
    void block_baseline(Comp &k, int16_t *b) {
        int s = huff(dc[k.td]);
        int diff = s ? extend(bits(s), s) : 0;
        k.dc_pred += diff;
        b[0] = (int16_t)k.dc_pred;
        const Huff &t = ac[k.ta];
        for (int i = 1; i < 64; i++) {
            int rs = huff(t);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
                i += r;
                if (i > 63) break;
                b[kZigzag[i]] = (int16_t)extend(bits(s), s);
            } else {
                if (r != 15) break;
                i += 15;
            }
        }
    }
    void block_dc_first(Comp &k, int16_t *b, int al) {
        int s = huff(dc[k.td]);
        int diff = s ? extend(bits(s), s) : 0;
        k.dc_pred += diff;
        b[0] = (int16_t)(k.dc_pred * (1 << al));
    }
    void block_dc_refine(int16_t *b, int al) {
        if (bits(1)) b[0] |= (int16_t)(1 << al);
    }
    void block_ac_first(Comp &k, int16_t *b, int ss, int se, int al) {
        if (eobrun > 0) {
            eobrun--;
            return;
        }
        const Huff &t = ac[k.ta];
        for (int i = ss; i <= se; i++) {
            int rs = huff(t);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                i += r;
                if (i > 63) break;
                b[kZigzag[i]] = (int16_t)(extend(bits(s), s) * (1 << al));
            } else if (r == 15) {
                i += 15;
            } else {
                eobrun = 1 << r;
                if (r) eobrun += bits(r);
                eobrun--;
                break;
            }
        }
    }
    void block_ac_refine(Comp &k, int16_t *b, int ss, int se, int al) {
        int p1 = 1 << al, m1 = -1 * (1 << al);
        int i = ss;
        const Huff &t = ac[k.ta];
        if (eobrun == 0) {
            for (; i <= se; i++) {
                int rs = huff(t);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    s = bits(1) ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += bits(r);
                    break;
                }
                do {
                    int16_t *coef = b + kZigzag[i];
                    if (*coef != 0) {
                        if (bits(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
                    } else {
                        if (--r < 0) break;
                    }
                    i++;
                } while (i <= se);
                if (s && i <= 63) b[kZigzag[i]] = (int16_t)s;
            }
        }
        if (eobrun > 0) {
            for (; i <= se; i++) {
                int16_t *coef = b + kZigzag[i];
                if (*coef != 0 && bits(1) && (*coef & p1) == 0)
                    *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
            eobrun--;
        }
    }

    void decode_block(Comp &k, int bx, int by, int ss, int se, int ah, int al) {
        int16_t *b = k.coef.data() + ((size_t)by * k.bw + bx) * 64;
        if (!progressive) {
            block_baseline(k, b);
        } else if (ss == 0) {
            if (ah == 0) block_dc_first(k, b, al);
            else block_dc_refine(b, al);
        } else if (ah == 0) {
            block_ac_first(k, b, ss, se, al);
        } else {
            block_ac_refine(k, b, ss, se, al);
        }
    }

    int parse_sos(size_t off, int len) {
        if (!have_frame) return MALFORMED;
        int ns = p[off];
        if (ns < 1 || ns > nc || len < 4 + 2 * ns) return MALFORMED;
        Comp *sc[3];
        for (int i = 0; i < ns; i++) {
            int id = p[off + 1 + 2 * i];
            sc[i] = nullptr;
            for (int j = 0; j < nc; j++)
                if (c[j].id == id) sc[i] = &c[j];
            if (!sc[i]) return MALFORMED;
            sc[i]->td = p[off + 2 + 2 * i] >> 4 & 3;
            sc[i]->ta = p[off + 2 + 2 * i] & 3;
        }
        int ss = p[off + 1 + 2 * ns], se = p[off + 2 + 2 * ns];
        int ah = p[off + 3 + 2 * ns] >> 4, al = p[off + 3 + 2 * ns] & 15;
        if (!progressive) {
            ss = 0;
            se = 63;
            ah = al = 0;
        }
        if (ss > se || se > 63 || (progressive && ss == 0 && se != 0) || (progressive && ss > 0 && ns != 1))
            return MALFORMED;
        for (int i = 0; i < ns; i++) {
            bool need_dc = ss == 0 && ah == 0, need_ac = se > 0;
            if ((need_dc && !dc[sc[i]->td].present) || (need_ac && !ac[sc[i]->ta].present)) return MALFORMED;
            sc[i]->dc_pred = 0;
        }
        pos = off + len;
        reset_bits();
        marker_hit = false;
        eobrun = 0;
        int mcu = 0;
        if (ns == 1) {
            Comp &k = *sc[0];
            for (int by = 0; by < k.hib; by++)
                for (int bx = 0; bx < k.wib; bx++) {
                    if (restart && mcu && mcu % restart == 0) restart_marker();
                    decode_block(k, bx, by, ss, se, ah, al);
                    mcu++;
                }
        } else {
            for (int my = 0; my < mcuy; my++)
                for (int mx = 0; mx < mcux; mx++) {
                    if (restart && mcu && mcu % restart == 0) restart_marker();
                    for (int i = 0; i < ns; i++) {
                        Comp &k = *sc[i];
                        for (int v = 0; v < k.v; v++)
                            for (int h = 0; h < k.h; h++) decode_block(k, mx * k.h + h, my * k.v + v, ss, se, ah, al);
                    }
                    mcu++;
                }
        }
        // on to the next marker (not a restart marker)
        while (pos + 1 < n && !(p[pos] == 0xFF && p[pos + 1] != 0 && p[pos + 1] != 0xFF &&
                                !(p[pos + 1] >= 0xD0 && p[pos + 1] <= 0xD7)))
            pos++;
        return OK;
    }

    // headers_only: stop at the first scan (the frame and APPn come before it)
    int parse(bool headers_only = false) {
        if (n < 4 || p[0] != 0xFF || p[1] != 0xD8) return MALFORMED;
        pos = 2;
        bool scanned = false;
        while (true) {
            while (pos < n && p[pos] != 0xFF) pos++;  // tolerate junk between segments
            while (pos < n && p[pos] == 0xFF) pos++;  // fill bytes
            if (pos >= n) return scanned ? OK : MALFORMED;
            int m = p[pos++];
            if (m == 0xD9) return scanned ? OK : MALFORMED;
            if (m >= 0xD0 && m <= 0xD7) continue;
            if (pos + 2 > n) return scanned ? OK : MALFORMED;
            int len = u16(pos);
            if (len < 2 || pos + len > n) return scanned ? OK : MALFORMED;
            size_t off = pos + 2;
            int body = len - 2;
            int rc = OK;
            switch (m) {
                case 0xC0: case 0xC1: case 0xC2: rc = parse_sof(off, body, m); break;
                case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9: case 0xCA: case 0xCB:
                case 0xCD: case 0xCE: case 0xCF: return UNSUPPORTED;  // lossless, hierarchical, arithmetic
                case 0xC4: rc = parse_dht(off, body); break;
                case 0xDB: rc = parse_dqt(off, body); break;
                case 0xDD: if (body >= 2) restart = u16(off); break;
                case 0xE0: if (body >= 5 && memcmp(p + off, "JFIF\0", 5) == 0) jfif = true; break;
                case 0xE1: rc = parse_app1(off, body); break;
                case 0xEE:
                    if (body >= 12 && memcmp(p + off, "Adobe", 5) == 0) {
                        adobe = true;
                        adobe_transform = p[off + 11];
                    }
                    break;
                case 0xDA:
                    if (headers_only) return have_frame ? OK : MALFORMED;
                    rc = parse_sos(off, body);
                    if (rc != OK) return rc;
                    scanned = true;
                    continue;
                default: break;
            }
            if (rc != OK) return rc;
            pos += len;
        }
    }

    bool is_rgb() const {
        if (nc != 3) return false;
        if (jfif) return false;
        if (adobe) return adobe_transform == 0;
        return c[0].id == 'R' && c[1].id == 'G' && c[2].id == 'B';
    }
};

// jdsample.c's upsampling of one component to the frame's full size (W x H)
void upsample(const Decoder &d, const Comp &k, const uint8_t *in, int stride, uint8_t *out) {
    const int W = d.W, H = d.H, dsw = k.dsw, dsh = k.dsh;
    auto row = [&](int y) { return in + (size_t)(y < 0 ? 0 : (y >= dsh ? dsh - 1 : y)) * stride; };
    if (k.h == d.hmax && k.v == d.vmax) {
        for (int y = 0; y < H; y++) memcpy(out + (size_t)y * W, row(y), W);
    } else if (k.h * 2 == d.hmax && k.v == d.vmax) {
        std::vector<uint8_t> line(2 * dsw);
        for (int y = 0; y < H; y++) {
            const uint8_t *s = row(y);
            if (dsw > 2) {
                line[0] = s[0];
                line[1] = (uint8_t)((s[0] * 3 + s[1] + 2) >> 2);
                for (int i = 1; i < dsw - 1; i++) {
                    int v = s[i] * 3;
                    line[2 * i] = (uint8_t)((v + s[i - 1] + 1) >> 2);
                    line[2 * i + 1] = (uint8_t)((v + s[i + 1] + 2) >> 2);
                }
                line[2 * dsw - 2] = (uint8_t)((s[dsw - 1] * 3 + s[dsw - 2] + 1) >> 2);
                line[2 * dsw - 1] = s[dsw - 1];
            } else {
                for (int x = 0; x < 2 * dsw; x++) line[x] = s[x >> 1];
            }
            memcpy(out + (size_t)y * W, line.data(), W);
        }
    } else if (k.h == d.hmax && k.v * 2 == d.vmax) {
        for (int y = 0; y < H; y++) {
            int i = y >> 1, v = y & 1;
            const uint8_t *s0 = row(i), *s1 = row(v ? i + 1 : i - 1);
            int bias = v ? 2 : 1;
            uint8_t *o = out + (size_t)y * W;
            for (int x = 0; x < W; x++) o[x] = (uint8_t)((s0[x] * 3 + s1[x] + bias) >> 2);
        }
    } else if (k.h * 2 == d.hmax && k.v * 2 == d.vmax) {
        std::vector<int> cs(dsw);
        std::vector<uint8_t> line(2 * dsw);
        for (int y = 0; y < H; y++) {
            int i = y >> 1, v = y & 1;
            if (dsw > 2) {
                const uint8_t *s0 = row(i), *s1 = row(v ? i + 1 : i - 1);
                for (int x = 0; x < dsw; x++) cs[x] = s0[x] * 3 + s1[x];
                line[0] = (uint8_t)((cs[0] * 4 + 8) >> 4);
                line[1] = (uint8_t)((cs[0] * 3 + cs[1] + 7) >> 4);
                for (int j = 1; j < dsw - 1; j++) {
                    line[2 * j] = (uint8_t)((cs[j] * 3 + cs[j - 1] + 8) >> 4);
                    line[2 * j + 1] = (uint8_t)((cs[j] * 3 + cs[j + 1] + 7) >> 4);
                }
                line[2 * dsw - 2] = (uint8_t)((cs[dsw - 1] * 3 + cs[dsw - 2] + 8) >> 4);
                line[2 * dsw - 1] = (uint8_t)((cs[dsw - 1] * 4 + 7) >> 4);
            } else {
                const uint8_t *s = row(i);
                for (int x = 0; x < 2 * dsw; x++) line[x] = s[x >> 1];
            }
            memcpy(out + (size_t)y * W, line.data(), W);
        }
    } else {  // integral factors: replication
        int fh = d.hmax / k.h, fv = d.vmax / k.v;
        for (int y = 0; y < H; y++) {
            const uint8_t *s = row(y / fv);
            for (int x = 0; x < W; x++) out[(size_t)y * W + x] = s[x / fh];
        }
    }
}

// jdcolor.c's YCbCr -> RGB tables
struct YccTables {
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    YccTables() {
        const int SCALEBITS = 16;
        const int32_t ONE_HALF = 1 << (SCALEBITS - 1);
        auto fix = [](double x) { return (int32_t)(x * (1 << 16) + 0.5); };
        for (int i = 0, x = -128; i < 256; i++, x++) {
            cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
            cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + ONE_HALF;
        }
    }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// EXIF orientation as OpenCV applies it; (w, h) are the decoded size
void orient(const uint8_t *src, int w, int h, int ch, int o, uint8_t *dst) {
    bool swap = o >= 5;
    int ow = swap ? h : w;
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
            int X = x, Y = y;  // destination coordinates
            switch (o) {
                case 2: X = w - 1 - x; break;
                case 3: X = w - 1 - x; Y = h - 1 - y; break;
                case 4: Y = h - 1 - y; break;
                case 5: X = y; Y = x; break;
                case 6: X = h - 1 - y; Y = x; break;
                case 7: X = h - 1 - y; Y = w - 1 - x; break;
                case 8: X = y; Y = w - 1 - x; break;
                default: break;
            }
            memcpy(dst + ((size_t)Y * ow + X) * ch, src + ((size_t)y * w + x) * ch, ch);
        }
}

int decode_all(Decoder &d, uint8_t *out) {
    const int W = d.W, H = d.H;
    std::vector<std::vector<uint8_t>> full(d.nc);
    for (int ci = 0; ci < d.nc; ci++) {
        Comp &k = d.c[ci];
        int stride = k.wib * 8;
        std::vector<uint8_t> plane((size_t)stride * k.hib * 8);
        for (int by = 0; by < k.hib; by++)
            for (int bx = 0; bx < k.wib; bx++)
                idct_islow(k.coef.data() + ((size_t)by * k.bw + bx) * 64, d.q[k.tq],
                           plane.data() + (size_t)by * 8 * stride + bx * 8, stride);
        full[ci].resize((size_t)W * H);
        upsample(d, k, plane.data(), stride, full[ci].data());
    }
    int ch = d.nc == 1 ? 1 : 3;
    bool direct = d.orientation <= 1;
    std::vector<uint8_t> tmp;
    uint8_t *dst = out;
    if (!direct) {
        tmp.resize((size_t)W * H * ch);
        dst = tmp.data();
    }
    if (ch == 1) {
        memcpy(dst, full[0].data(), (size_t)W * H);
    } else if (d.is_rgb()) {
        for (size_t i = 0; i < (size_t)W * H; i++) {
            dst[3 * i] = full[2][i];
            dst[3 * i + 1] = full[1][i];
            dst[3 * i + 2] = full[0][i];
        }
    } else {
        for (size_t i = 0; i < (size_t)W * H; i++) {
            int y = full[0][i], cb = full[1][i], cr = full[2][i];
            dst[3 * i + 2] = clamp255(y + kYcc.cr_r[cr]);
            dst[3 * i + 1] = clamp255(y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
            dst[3 * i] = clamp255(y + kYcc.cb_b[cb]);
        }
    }
    if (!direct) orient(dst, W, H, ch, d.orientation, out);
    return OK;
}

// ------------------------------------------------------------- encoder ----
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChrBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
    0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChrBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const int kStdLum[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                         14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                         18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                         49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChr[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                         24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                         99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                         99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

struct EncHuff {
    uint16_t code[256];
    uint8_t size[256];
    EncHuff(const uint8_t *bits, const uint8_t *vals) {
        memset(size, 0, sizeof(size));
        int c = 0, k = 0;
        for (int l = 1; l <= 16; l++) {
            for (int i = 0; i < bits[l - 1]; i++, k++) {
                code[vals[k]] = (uint16_t)c++;
                size[vals[k]] = (uint8_t)l;
            }
            c <<= 1;
        }
    }
};

struct BitWriter {
    std::vector<uint8_t> &out;
    uint32_t acc = 0;
    int cnt = 0;
    explicit BitWriter(std::vector<uint8_t> &o) : out(o) {}
    void put(uint32_t v, int n) {
        acc = (acc << n) | (v & ((1u << n) - 1));
        cnt += n;
        while (cnt >= 8) {
            uint8_t b = (uint8_t)(acc >> (cnt - 8));
            out.push_back(b);
            if (b == 0xFF) out.push_back(0);
            cnt -= 8;
        }
    }
    void flush() {
        if (cnt) put(0x7F, 8 - cnt);  // pad with ones
    }
};

// jcdctmgr.c's reciprocal quantiser for 16-bit DCT elements
struct Divisor {
    uint32_t recip, corr;
    int shift;
    explicit Divisor(uint32_t d = 8) {
        int b = 31 - __builtin_clz(d);
        int r = 16 + b;
        uint32_t fq = (1u << r) / d, fr = (1u << r) % d;
        uint32_t c = d / 2;
        if (fr == 0) {
            fq >>= 1;
            r--;
        } else if (fr <= d / 2) {
            c++;
        } else {
            fq++;
        }
        recip = fq & 0xFFFF;
        corr = c & 0xFFFF;
        shift = r;
    }
    int16_t apply(int32_t x) const {
        uint32_t t = (uint32_t)(x < 0 ? -x : x);
        uint32_t q = (uint32_t)(((t + corr) & 0xFFFF) * recip) >> shift;
        return (int16_t)(x < 0 ? -(int32_t)q : (int32_t)q);
    }
};

void fdct_islow(int32_t *d) {
    for (int r = 0; r < 8; r++) {
        int32_t *p = d + 8 * r;
        int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
        int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
        int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = (tmp10 + tmp11) * (1 << PASS1_BITS);
        p[4] = (tmp10 - tmp11) * (1 << PASS1_BITS);
        int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
        p[2] = descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
        p[6] = descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS - PASS1_BITS);
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
        p[7] = descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
        p[5] = descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
        p[3] = descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
        p[1] = descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
    }
    for (int c = 0; c < 8; c++) {
        int32_t *p = d + c;
        int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
        int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
        int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = descale(tmp10 + tmp11, PASS1_BITS);
        p[32] = descale(tmp10 - tmp11, PASS1_BITS);
        int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
        p[16] = descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
        p[48] = descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS + PASS1_BITS);
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
        p[56] = descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
        p[40] = descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
        p[24] = descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
        p[8] = descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
    }
}

struct EncPlane {
    int h, v, wib, hib, stride, rows, tq;
    std::vector<uint8_t> px;  // stride x rows, edges replicated
};

void put_u16(std::vector<uint8_t> &o, int v) {
    o.push_back((uint8_t)(v >> 8));
    o.push_back((uint8_t)v);
}

void put_dht(std::vector<uint8_t> &o, int cls_id, const uint8_t *bits, const uint8_t *vals, int nvals) {
    o.push_back(0xFF);
    o.push_back(0xC4);
    put_u16(o, 2 + 1 + 16 + nvals);
    o.push_back((uint8_t)cls_id);
    o.insert(o.end(), bits, bits + 16);
    o.insert(o.end(), vals, vals + nvals);
}

void encode(const uint8_t *img, int W, int H, int ch, int quality, std::vector<uint8_t> &out) {
    if (quality <= 0) quality = 1;
    if (quality > 100) quality = 100;
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    uint16_t qt[2][64];
    for (int i = 0; i < 64; i++) {
        for (int t = 0; t < 2; t++) {
            long v = ((long)(t ? kStdChr[i] : kStdLum[i]) * scale + 50L) / 100L;
            qt[t][i] = (uint16_t)(v < 1 ? 1 : (v > 255 ? 255 : v));
        }
    }
    const int nc = ch == 1 ? 1 : 3;
    const int hmax = nc == 1 ? 1 : 2, vmax = hmax;
    const int mcux = (W + 8 * hmax - 1) / (8 * hmax), mcuy = (H + 8 * vmax - 1) / (8 * vmax);

    // colour conversion (jccolor.c) into full-size planes
    std::vector<std::vector<uint8_t>> full(nc, std::vector<uint8_t>((size_t)W * H));
    if (nc == 1) {
        memcpy(full[0].data(), img, (size_t)W * H);
    } else {
        const int32_t ONE_HALF = 1 << 15, CBCR_OFFSET = 128 << 16;
        auto fix = [](double x) { return (int32_t)(x * (1 << 16) + 0.5); };
        const int32_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400), rcb = fix(0.16874),
                      gcb = fix(0.33126), half = fix(0.5), gcr = fix(0.41869), bcr = fix(0.08131);
        for (size_t i = 0; i < (size_t)W * H; i++) {
            int32_t b = img[3 * i], g = img[3 * i + 1], r = img[3 * i + 2];
            full[0][i] = (uint8_t)((ry * r + gy * g + by * b + ONE_HALF) >> 16);
            full[1][i] = (uint8_t)((-rcb * r - gcb * g + half * b + CBCR_OFFSET + ONE_HALF - 1) >> 16);
            full[2][i] = (uint8_t)((half * r - gcr * g - bcr * b + CBCR_OFFSET + ONE_HALF - 1) >> 16);
        }
    }
    // planes padded by edge replication (jcprepct.c, jcsample.c)
    std::vector<EncPlane> planes(nc);
    for (int ci = 0; ci < nc; ci++) {
        EncPlane &pl = planes[ci];
        pl.h = pl.v = ci == 0 ? hmax : 1;
        pl.tq = ci == 0 ? 0 : 1;
        int dsw = (W * pl.h + hmax - 1) / hmax, dsh = (H * pl.v + vmax - 1) / vmax;
        pl.wib = (dsw + 7) / 8;
        pl.hib = (dsh + 7) / 8;
        pl.stride = mcux * pl.h * 8;
        pl.rows = mcuy * pl.v * 8;
        pl.px.assign((size_t)pl.stride * pl.rows, 0);
        const int fw = pl.wib * 8 * (hmax / pl.h);  // width of the expanded full-size rows
        auto src = [&](int x, int y) {
            x = x < W ? x : W - 1;
            y = y < H ? y : H - 1;
            return (int)full[ci][(size_t)y * W + x];
        };
        int out_rows = ((H + vmax - 1) / vmax) * pl.v;  // rows the downsampler produces
        for (int y = 0; y < pl.rows; y++) {
            uint8_t *o = pl.px.data() + (size_t)y * pl.stride;
            int yy = y < out_rows ? y : out_rows - 1;
            if (pl.h == hmax && pl.v == vmax) {
                for (int x = 0; x < pl.wib * 8; x++) o[x] = (uint8_t)src(x, yy);
            } else {  // h2v2 with the alternating bias 1, 2
                int bias = 1;
                for (int x = 0; x < fw / 2; x++) {
                    o[x] = (uint8_t)((src(2 * x, 2 * yy) + src(2 * x + 1, 2 * yy) + src(2 * x, 2 * yy + 1) +
                                      src(2 * x + 1, 2 * yy + 1) + bias) >> 2);
                    bias ^= 3;
                }
            }
        }
    }

    // markers
    out.clear();
    const uint8_t soi_app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                                0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
    out.insert(out.end(), soi_app0, soi_app0 + sizeof(soi_app0));
    for (int t = 0; t < (nc == 1 ? 1 : 2); t++) {
        out.push_back(0xFF);
        out.push_back(0xDB);
        put_u16(out, 67);
        out.push_back((uint8_t)t);
        for (int i = 0; i < 64; i++) out.push_back((uint8_t)qt[t][kZigzag[i]]);
    }
    out.push_back(0xFF);
    out.push_back(0xC0);
    put_u16(out, 8 + 3 * nc);
    out.push_back(8);
    put_u16(out, H);
    put_u16(out, W);
    out.push_back((uint8_t)nc);
    for (int ci = 0; ci < nc; ci++) {
        out.push_back((uint8_t)(ci + 1));
        out.push_back((uint8_t)(planes[ci].h << 4 | planes[ci].v));
        out.push_back((uint8_t)planes[ci].tq);
    }
    put_dht(out, 0x00, kDcLumBits, kDcVals, 12);
    put_dht(out, 0x10, kAcLumBits, kAcLumVals, 162);
    if (nc == 3) {
        put_dht(out, 0x01, kDcChrBits, kDcVals, 12);
        put_dht(out, 0x11, kAcChrBits, kAcChrVals, 162);
    }
    out.push_back(0xFF);
    out.push_back(0xDA);
    put_u16(out, 6 + 2 * nc);
    out.push_back((uint8_t)nc);
    for (int ci = 0; ci < nc; ci++) {
        out.push_back((uint8_t)(ci + 1));
        out.push_back(ci == 0 ? 0x00 : 0x11);
    }
    out.push_back(0);
    out.push_back(63);
    out.push_back(0);

    // entropy-coded data (jccoefct.c, jchuff.c)
    const EncHuff hdc[2] = {EncHuff(kDcLumBits, kDcVals), EncHuff(kDcChrBits, kDcVals)};
    const EncHuff hac[2] = {EncHuff(kAcLumBits, kAcLumVals), EncHuff(kAcChrBits, kAcChrVals)};
    Divisor div[2][64];
    for (int t = 0; t < 2; t++)
        for (int i = 0; i < 64; i++) div[t][i] = Divisor((uint32_t)qt[t][i] << 3);
    BitWriter bw(out);
    int last_dc[3] = {0, 0, 0};
    int16_t blocks[4][64];
    int32_t work[64];
    for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++) {
            for (int ci = 0; ci < nc; ci++) {
                const EncPlane &pl = planes[ci];
                const int t = pl.tq;
                int last_col_width = pl.wib % pl.h ? pl.wib % pl.h : pl.h;
                int last_row_height = pl.hib % pl.v ? pl.hib % pl.v : pl.v;
                int blockcnt = mx < mcux - 1 ? pl.h : last_col_width;
                int nb = 0;
                for (int yi = 0; yi < pl.v; yi++) {
                    if (my < mcuy - 1 || yi < last_row_height) {
                        for (int xi = 0; xi < blockcnt; xi++) {
                            int bx = mx * pl.h + xi, by = my * pl.v + yi;
                            for (int r = 0; r < 8; r++) {
                                const uint8_t *s = pl.px.data() + (size_t)(by * 8 + r) * pl.stride + bx * 8;
                                for (int k = 0; k < 8; k++) work[8 * r + k] = (int32_t)s[k] - 128;
                            }
                            fdct_islow(work);
                            for (int i = 0; i < 64; i++) blocks[nb + xi][i] = div[t][i].apply(work[i]);
                        }
                        for (int xi = blockcnt; xi < pl.h; xi++) {
                            memset(blocks[nb + xi], 0, sizeof(blocks[0]));
                            blocks[nb + xi][0] = blocks[nb + xi - 1][0];
                        }
                    } else {
                        for (int xi = 0; xi < pl.h; xi++) {
                            memset(blocks[nb + xi], 0, sizeof(blocks[0]));
                            blocks[nb + xi][0] = blocks[nb - 1][0];
                        }
                    }
                    nb += pl.h;
                }
                for (int b = 0; b < nb; b++) {
                    const int16_t *blk = blocks[b];
                    int temp = blk[0] - last_dc[ci], temp2 = temp;
                    last_dc[ci] = blk[0];
                    if (temp < 0) {
                        temp = -temp;
                        temp2--;
                    }
                    int nbits = 0;
                    while (temp) {
                        nbits++;
                        temp >>= 1;
                    }
                    bw.put(hdc[t].code[nbits], hdc[t].size[nbits]);
                    if (nbits) bw.put((uint32_t)temp2, nbits);
                    int r = 0;
                    for (int k = 1; k < 64; k++) {
                        temp = blk[kZigzag[k]];
                        if (temp == 0) {
                            r++;
                            continue;
                        }
                        while (r > 15) {
                            bw.put(hac[t].code[0xF0], hac[t].size[0xF0]);
                            r -= 16;
                        }
                        temp2 = temp;
                        if (temp < 0) {
                            temp = -temp;
                            temp2--;
                        }
                        nbits = 1;
                        while ((temp >>= 1)) nbits++;
                        int sym = (r << 4) + nbits;
                        bw.put(hac[t].code[sym], hac[t].size[sym]);
                        bw.put((uint32_t)temp2, nbits);
                        r = 0;
                    }
                    if (r > 0) bw.put(hac[t].code[0], hac[t].size[0]);
                }
            }
        }
    }
    bw.flush();
    out.push_back(0xFF);
    out.push_back(0xD9);
}

}  // namespace

extern "C" {

// Header of a JPEG: the decoded size after the EXIF orientation and the
// channel count (1 gray, 3 BGR). Returns 0, 1 (malformed) or 2 (unsupported).
int oc_jpeg_header(const uint8_t *data, size_t size, int *width, int *height, int *channels) {
    Decoder d;
    d.p = data;
    d.n = size;
    int rc = d.parse(true);
    if (rc != OK) return rc;
    if (!d.have_frame) return MALFORMED;
    bool swap = d.orientation >= 5;
    *width = swap ? d.H : d.W;
    *height = swap ? d.W : d.H;
    *channels = d.nc == 1 ? 1 : 3;
    return OK;
}

// Decode into ``out`` (height x width x channels bytes, as the header gives).
int oc_jpeg_decode(const uint8_t *data, size_t size, uint8_t *out, size_t out_size) {
    Decoder d;
    d.p = data;
    d.n = size;
    int rc = d.parse();
    if (rc != OK) return rc;
    if (!d.have_frame) return MALFORMED;
    if ((size_t)d.W * d.H * (d.nc == 1 ? 1 : 3) != out_size) return MALFORMED;
    return decode_all(d, out);
}

// Encode a height x width x channels (1 gray, 3 BGR) image. The bytes are
// returned in *out, to be released with oc_jpeg_free.
int oc_jpeg_encode(const uint8_t *img, int width, int height, int channels, int quality, uint8_t **out,
                   size_t *out_size) {
    if (width <= 0 || height <= 0 || width > 65535 || height > 65535 || (channels != 1 && channels != 3))
        return UNSUPPORTED;
    std::vector<uint8_t> buf;
    encode(img, width, height, channels, quality, buf);
    *out = (uint8_t *)malloc(buf.size());
    if (!*out) return MALFORMED;
    memcpy(*out, buf.data(), buf.size());
    *out_size = buf.size();
    return OK;
}

void oc_jpeg_free(uint8_t *p) { free(p); }

}  // extern "C"
