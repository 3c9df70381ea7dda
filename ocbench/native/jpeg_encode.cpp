// Baseline JPEG encoder for 8-bit images, with a plain C interface for
// ctypes: the benchmark's frozen copy of the encoder half of the port's
// opencalibration_tpu_torch/native/jpeg.cpp at commit
// 3a365f3897db20a853d4aa1c09f57b88461614aa (its decoder left out), so the
// surveys the benchmark writes do not change when the program's codec does.
//
// It writes a baseline file as OpenCV's imencode(".jpg") does at its
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

const int CONST_BITS = 13, PASS1_BITS = 2;
const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

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
