// Native EXIF/XMP metadata parser.
//
// C++ replacement for the role of the reference's vendored TinyEXIF
// (reference external/TinyEXIF, used by src/extract/extract_metadata.cpp):
// walks the JPEG APP1 TIFF structure directly (both endiannesses), pulls
// the camera/GPS fields the pipeline needs, and scans the XMP packet for
// DJI-style drone tags. Exposed through a plain C ABI for ctypes.
//
// Build: g++ -O2 -shared -fPIC exif_parser.cpp -o libocexif.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>

namespace {

struct Reader {
    const uint8_t *data;
    size_t size;
    bool little_endian = true;

    uint16_t u16(size_t off) const {
        if (off + 2 > size) return 0;
        return little_endian ? (uint16_t)(data[off] | data[off + 1] << 8)
                             : (uint16_t)(data[off] << 8 | data[off + 1]);
    }
    uint32_t u32(size_t off) const {
        if (off + 4 > size) return 0;
        return little_endian
                   ? (uint32_t)data[off] | (uint32_t)data[off + 1] << 8 |
                         (uint32_t)data[off + 2] << 16 | (uint32_t)data[off + 3] << 24
                   : (uint32_t)data[off] << 24 | (uint32_t)data[off + 1] << 16 |
                         (uint32_t)data[off + 2] << 8 | (uint32_t)data[off + 3];
    }
    double rational(size_t off) const {
        uint32_t num = u32(off), den = u32(off + 4);
        return den == 0 ? 0.0 : (double)num / (double)den;
    }
};

struct Entry {
    uint16_t tag;
    uint16_t type;
    uint32_t count;
    size_t value_off;  // offset of the value bytes within the TIFF block
};

size_t type_size(uint16_t type) {
    switch (type) {
        case 1: case 2: case 7: return 1;
        case 3: return 2;
        case 4: case 9: return 4;
        case 5: case 10: return 8;
        default: return 1;
    }
}

std::vector<Entry> parse_ifd(const Reader &r, size_t off, size_t *next_ifd) {
    std::vector<Entry> out;
    if (next_ifd) *next_ifd = 0;
    if (off + 2 > r.size) return out;
    uint16_t n = r.u16(off);
    if (n > 512) return out;
    for (uint16_t i = 0; i < n; i++) {
        size_t e = off + 2 + (size_t)i * 12;
        if (e + 12 > r.size) break;
        Entry ent;
        ent.tag = r.u16(e);
        ent.type = r.u16(e + 2);
        ent.count = r.u32(e + 4);
        size_t total = type_size(ent.type) * (size_t)ent.count;
        ent.value_off = total <= 4 ? e + 8 : r.u32(e + 8);
        out.push_back(ent);
    }
    if (next_ifd) {
        size_t p = off + 2 + (size_t)n * 12;
        if (p + 4 <= r.size) *next_ifd = r.u32(p);
    }
    return out;
}

void read_string(const Reader &r, const Entry &e, char *dst, size_t cap) {
    size_t n = e.count < cap - 1 ? e.count : cap - 1;
    if (e.value_off + n > r.size) n = e.value_off < r.size ? r.size - e.value_off : 0;
    memcpy(dst, r.data + e.value_off, n);
    dst[n] = 0;
    // trim trailing whitespace/nulls
    for (size_t i = n; i > 0 && (dst[i - 1] == ' ' || dst[i - 1] == 0); i--) dst[i - 1] = 0;
}

double read_scalar(const Reader &r, const Entry &e) {
    switch (e.type) {
        case 3: return r.u16(e.value_off);
        case 4: return r.u32(e.value_off);
        case 5: return r.rational(e.value_off);
        case 10: {  // signed rational
            int32_t num = (int32_t)r.u32(e.value_off);
            int32_t den = (int32_t)r.u32(e.value_off + 4);
            return den == 0 ? 0.0 : (double)num / (double)den;
        }
        default: return 0.0;
    }
}

double read_dms(const Reader &r, const Entry &e) {
    if (e.count < 3 || e.type != 5) return NAN;
    return r.rational(e.value_off) + r.rational(e.value_off + 8) / 60.0 +
           r.rational(e.value_off + 16) / 3600.0;
}

bool find_xmp_double(const std::string &xmp, const char *key, double *out) {
    size_t pos = xmp.find(key);
    if (pos == std::string::npos) return false;
    pos += strlen(key);
    // skip ="  or  >  or  =
    while (pos < xmp.size() && (xmp[pos] == '=' || xmp[pos] == '"' || xmp[pos] == '\'' ||
                                xmp[pos] == '>' || xmp[pos] == ' '))
        pos++;
    char *end = nullptr;
    double v = strtod(xmp.c_str() + pos, &end);
    if (end == xmp.c_str() + pos) return false;
    *out = v;
    return true;
}

}  // namespace

extern "C" {

struct OcExifResult {
    // validity flags
    int32_t has_exif;
    int32_t has_gps;
    int32_t has_altitude;
    int32_t has_relative_altitude;
    int32_t has_orientation;
    // camera
    char make[64];
    char model[64];
    char lens_model[64];
    char datetime[32];
    int32_t width_px;
    int32_t height_px;
    double focal_length_mm;
    double focal_length_35mm;
    double focal_plane_x_res;
    int32_t focal_plane_unit;  // 2=inch, 3=cm
    // gps
    double latitude;
    double longitude;
    double altitude;
    double dop;
    // xmp (DJI)
    double relative_altitude;
    double gimbal_roll_deg;
    double gimbal_pitch_deg;
    double gimbal_yaw_deg;
    double rtk_std_lon;
    double rtk_std_lat;
    double rtk_std_hgt;
};

int oc_parse_exif(const char *path, OcExifResult *res) {
    memset(res, 0, sizeof(*res));
    res->latitude = res->longitude = res->altitude = NAN;
    res->relative_altitude = NAN;
    res->gimbal_roll_deg = res->gimbal_pitch_deg = res->gimbal_yaw_deg = NAN;
    res->rtk_std_lat = res->rtk_std_lon = res->rtk_std_hgt = NAN;
    res->focal_length_mm = res->focal_length_35mm = res->focal_plane_x_res = 0;
    res->dop = NAN;

    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    // read up to 1MB head: APP1 segments live before image data
    std::vector<uint8_t> buf(1 << 20);
    size_t n = fread(buf.data(), 1, buf.size(), f);
    fclose(f);
    buf.resize(n);
    if (n < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return -2;  // not a JPEG

    std::string xmp;
    size_t pos = 2;
    while (pos + 4 <= n) {
        if (buf[pos] != 0xFF) break;
        uint8_t marker = buf[pos + 1];
        if (marker == 0xDA || marker == 0xD9) break;  // image data / end
        size_t seg_len = ((size_t)buf[pos + 2] << 8) | buf[pos + 3];
        if (seg_len < 2 || pos + 2 + seg_len > n) break;
        const uint8_t *seg = buf.data() + pos + 4;
        size_t seg_size = seg_len - 2;

        if (marker == 0xE1 && seg_size > 14 && memcmp(seg, "Exif\0\0", 6) == 0) {
            Reader r{seg + 6, seg_size - 6};
            if (r.size >= 8) {
                r.little_endian = (r.data[0] == 'I');
                size_t ifd0 = r.u32(4);
                size_t exif_ifd = 0, gps_ifd = 0;
                for (const Entry &e : parse_ifd(r, ifd0, nullptr)) {
                    switch (e.tag) {
                        case 271: read_string(r, e, res->make, sizeof(res->make)); break;
                        case 272: read_string(r, e, res->model, sizeof(res->model)); break;
                        case 306: read_string(r, e, res->datetime, sizeof(res->datetime)); break;
                        case 34665: exif_ifd = (size_t)read_scalar(r, e); break;
                        case 34853: gps_ifd = (size_t)read_scalar(r, e); break;
                    }
                }
                if (exif_ifd) {
                    for (const Entry &e : parse_ifd(r, exif_ifd, nullptr)) {
                        switch (e.tag) {
                            case 36867: read_string(r, e, res->datetime, sizeof(res->datetime)); break;
                            case 37386: res->focal_length_mm = read_scalar(r, e); break;
                            case 40962: res->width_px = (int32_t)read_scalar(r, e); break;
                            case 40963: res->height_px = (int32_t)read_scalar(r, e); break;
                            case 41486: res->focal_plane_x_res = read_scalar(r, e); break;
                            case 41488: res->focal_plane_unit = (int32_t)read_scalar(r, e); break;
                            case 41989: res->focal_length_35mm = read_scalar(r, e); break;
                            case 42036: read_string(r, e, res->lens_model, sizeof(res->lens_model)); break;
                        }
                    }
                }
                if (gps_ifd) {
                    char lat_ref = 0, lon_ref = 0;
                    uint8_t alt_ref = 0;
                    double lat = NAN, lon = NAN;
                    for (const Entry &e : parse_ifd(r, gps_ifd, nullptr)) {
                        switch (e.tag) {
                            case 1: lat_ref = (char)r.data[e.value_off]; break;
                            case 2: lat = read_dms(r, e); break;
                            case 3: lon_ref = (char)r.data[e.value_off]; break;
                            case 4: lon = read_dms(r, e); break;
                            case 5: alt_ref = r.data[e.value_off]; break;
                            case 6: res->altitude = read_scalar(r, e); res->has_altitude = 1; break;
                            case 11: res->dop = read_scalar(r, e); break;
                        }
                    }
                    if (std::isfinite(lat) && std::isfinite(lon)) {
                        res->latitude = (lat_ref == 'S') ? -lat : lat;
                        res->longitude = (lon_ref == 'W') ? -lon : lon;
                        res->has_gps = 1;
                    }
                    if (res->has_altitude && alt_ref == 1) res->altitude = -res->altitude;
                }
                res->has_exif = 1;
            }
        } else if (marker == 0xE1 && seg_size > 29 &&
                   memcmp(seg, "http://ns.adobe.com/xap/1.0/", 28) == 0) {
            xmp.assign((const char *)seg + 29, seg_size - 29);
        }
        pos += 2 + seg_len;
    }

    if (!xmp.empty()) {
        if (find_xmp_double(xmp, "RelativeAltitude", &res->relative_altitude))
            res->has_relative_altitude = 1;
        bool r1 = find_xmp_double(xmp, "GimbalRollDegree", &res->gimbal_roll_deg) ||
                  find_xmp_double(xmp, "FlightRollDegree", &res->gimbal_roll_deg);
        bool r2 = find_xmp_double(xmp, "GimbalPitchDegree", &res->gimbal_pitch_deg) ||
                  find_xmp_double(xmp, "FlightPitchDegree", &res->gimbal_pitch_deg);
        bool r3 = find_xmp_double(xmp, "GimbalYawDegree", &res->gimbal_yaw_deg) ||
                  find_xmp_double(xmp, "FlightYawDegree", &res->gimbal_yaw_deg);
        if (r1 && r2 && r3) res->has_orientation = 1;
        find_xmp_double(xmp, "RtkStdLon", &res->rtk_std_lon);
        find_xmp_double(xmp, "RtkStdLat", &res->rtk_std_lat);
        find_xmp_double(xmp, "RtkStdHgt", &res->rtk_std_hgt);
    }
    return res->has_exif || !xmp.empty() ? 0 : 1;
}

}  // extern "C"
