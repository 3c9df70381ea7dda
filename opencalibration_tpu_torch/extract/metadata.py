"""EXIF / XMP metadata extraction.

Re-implements the behavior of reference src/extract/extract_metadata.cpp:
47-148 (which uses the vendored TinyEXIF): GPS position + accuracies,
DJI-style XMP relative altitude and gimbal roll/pitch/yaw, and the
three-tier focal-length fallback:
  1. calibrated focal length tag,
  2. 35mm-equivalent scaled by the sensor diagonal (43.27mm full-frame
     diagonal),
  3. physical focal length / focal-plane resolution.

EXIF parsing uses PIL (native libjpeg/libtiff under the hood); the XMP
packet (where DJI writes RelativeAltitude etc.) is located by scanning the
file head for the x:xmpmeta block, exactly the data TinyEXIF pulls.
"""

from __future__ import annotations

import math
import re

import numpy as np

from opencalibration_tpu_torch.types.graph import ImageMetadata

_XMP_FIELDS = {
    "relative_altitude": rb"(?:drone-dji:)?RelativeAltitude\s*=?\s*\"?([-+]?\d+\.?\d*)",
    "roll": rb"(?:drone-dji:)?(?:Gimbal|Flight)RollDegree\s*=?\s*\"?([-+]?\d+\.?\d*)",
    "pitch": rb"(?:drone-dji:)?(?:Gimbal|Flight)PitchDegree\s*=?\s*\"?([-+]?\d+\.?\d*)",
    "yaw": rb"(?:drone-dji:)?(?:Gimbal|Flight)YawDegree\s*=?\s*\"?([-+]?\d+\.?\d*)",
    "rtk_std_lon": rb"(?:drone-dji:)?RtkStdLon\s*=?\s*\"?(\d+\.?\d*)",
    "rtk_std_lat": rb"(?:drone-dji:)?RtkStdLat\s*=?\s*\"?(\d+\.?\d*)",
    "rtk_std_hgt": rb"(?:drone-dji:)?RtkStdHgt\s*=?\s*\"?(\d+\.?\d*)",
}

FULL_FRAME_DIAGONAL_MM = 43.27  # reference extract_metadata.cpp:117-124


def _ratio(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


def _dms_to_deg(dms, ref):
    try:
        deg = _ratio(dms[0]) + _ratio(dms[1]) / 60.0 + _ratio(dms[2]) / 3600.0
        if ref in ("S", "W", b"S", b"W"):
            deg = -deg
        return deg
    except (TypeError, IndexError):
        return float("nan")


def parse_xmp(path: str) -> dict:
    """Scan the file head for the XMP packet and pull DJI-style fields."""
    out = {}
    try:
        with open(path, "rb") as f:
            head = f.read(256 * 1024)
    except OSError:
        return out
    start = head.find(b"<x:xmpmeta")
    if start < 0:
        return out
    end = head.find(b"</x:xmpmeta>", start)
    packet = head[start : end if end > 0 else len(head)]
    for key, pattern in _XMP_FIELDS.items():
        m = re.search(pattern, packet)
        if m:
            out[key] = float(m.group(1))
    return out


def _orientation_quat(roll_deg, pitch_deg, yaw_deg):
    r, p, y = (math.radians(v) for v in (roll_deg, pitch_deg, yaw_deg))
    cy, sy = math.cos(y / 2), math.sin(y / 2)
    cp, sp = math.cos(p / 2), math.sin(p / 2)
    cr, sr = math.cos(r / 2), math.sin(r / 2)
    return np.array(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ]
    )


def extract_metadata_native(path: str):
    """Primary path: the C++ parser (opencalibration_tpu_torch/native/
    exif_parser.cpp). Returns None when the native library is unavailable
    or the file has no parseable metadata."""
    from opencalibration_tpu_torch.native import parse_exif_native

    res = parse_exif_native(path)
    if res is None:
        return None
    md = ImageMetadata()
    md.camera_make = res.make.decode("ascii", "replace")
    md.camera_model = res.model.decode("ascii", "replace")
    md.lens_model = res.lens_model.decode("ascii", "replace")
    md.capture_time = res.datetime.decode("ascii", "replace")
    md.width_px = res.width_px
    md.height_px = res.height_px
    if res.has_gps:
        md.latitude = res.latitude
        md.longitude = res.longitude
    if res.has_altitude:
        md.altitude = res.altitude
    if math.isfinite(res.dop) and res.dop > 0:
        md.gps_accuracy_xy = res.dop
    # 3-tier focal fallback (reference extract_metadata.cpp:110-138)
    if res.focal_length_35mm > 0 and md.width_px:
        md.focal_length_px = (
            res.focal_length_35mm / FULL_FRAME_DIAGONAL_MM
            * math.hypot(md.width_px, md.height_px)
        )
    elif res.focal_length_mm > 0 and res.focal_plane_x_res > 0:
        scale = 10.0 if res.focal_plane_unit == 3 else 25.4
        md.focal_length_px = res.focal_length_mm / (scale / res.focal_plane_x_res)
    if res.has_relative_altitude:
        md.relative_altitude = res.relative_altitude
        md.altitude = res.relative_altitude
    if math.isfinite(res.rtk_std_lat) and math.isfinite(res.rtk_std_lon):
        md.gps_accuracy_xy = max(res.rtk_std_lat, res.rtk_std_lon)
    if math.isfinite(res.rtk_std_hgt):
        md.gps_accuracy_z = res.rtk_std_hgt
    if res.has_orientation:
        md.rotation_offset = 0.0
        md.abs_orientation = _orientation_quat(
            res.gimbal_roll_deg, res.gimbal_pitch_deg, res.gimbal_yaw_deg
        )
    if md.width_px == 0:
        # EXIF lacked pixel dims: let the caller fill from the decode
        pass
    return md


def extract_metadata(path: str) -> ImageMetadata:
    native = extract_metadata_native(path)
    if native is not None:
        if native.width_px == 0:
            try:
                from PIL import Image as PILImage

                with PILImage.open(path) as im:
                    native.width_px, native.height_px = im.size
            except Exception:
                pass
        return native
    return _extract_metadata_pil(path)


def _extract_metadata_pil(path: str) -> ImageMetadata:
    """Fallback path: PIL-based parsing (no compiler available)."""
    md = ImageMetadata()
    try:
        from PIL import Image as PILImage
        from PIL.ExifTags import IFD

        with PILImage.open(path) as im:
            md.width_px, md.height_px = im.size
            exif = im.getexif()
            if len(exif) == 0:
                return md
            md.camera_make = str(exif.get(271, "")).strip("\x00 ")  # Make
            md.camera_model = str(exif.get(272, "")).strip("\x00 ")  # Model
            md.capture_time = str(exif.get(306, ""))  # DateTime

            try:
                ifd_exif = exif.get_ifd(IFD.Exif)
            except Exception:
                ifd_exif = {}
            if 36867 in ifd_exif:  # DateTimeOriginal
                md.capture_time = str(ifd_exif[36867])
            md.lens_model = str(ifd_exif.get(42036, "")).strip("\x00 ")
            exif_w = ifd_exif.get(40962)
            exif_h = ifd_exif.get(40963)
            if exif_w and exif_h:
                md.width_px, md.height_px = int(exif_w), int(exif_h)

            # focal fallbacks, reference extract_metadata.cpp:110-138
            focal_35mm = _ratio(ifd_exif.get(41989))  # FocalLengthIn35mmFilm
            focal_mm = _ratio(ifd_exif.get(37386))  # FocalLength
            fp_x_res = _ratio(ifd_exif.get(41486))  # FocalPlaneXResolution
            fp_unit = ifd_exif.get(41488, 2)  # 2=inch, 3=cm
            if focal_35mm and focal_35mm > 0 and md.width_px:
                md.focal_length_px = (
                    focal_35mm
                    / FULL_FRAME_DIAGONAL_MM
                    * math.hypot(md.width_px, md.height_px)
                )
            elif focal_mm and focal_mm > 0 and fp_x_res and fp_x_res > 0:
                scale = 10.0 if fp_unit == 3 else 25.4
                pixel_size_mm = scale / fp_x_res
                md.focal_length_px = focal_mm / pixel_size_mm

            try:
                gps = exif.get_ifd(IFD.GPSInfo)
            except Exception:
                gps = {}
            if gps:
                lat = _dms_to_deg(gps.get(2), gps.get(1))
                lon = _dms_to_deg(gps.get(4), gps.get(3))
                if not (math.isnan(lat) or math.isnan(lon)):
                    md.latitude, md.longitude = lat, lon
                alt = _ratio(gps.get(6))
                if not math.isnan(alt):
                    if gps.get(5, 0) in (1, b"\x01"):
                        alt = -alt
                    md.altitude = alt
                dop = _ratio(gps.get(11))  # GPSDOP
                if not math.isnan(dop) and dop > 0:
                    md.gps_accuracy_xy = dop
    except Exception:
        return md

    xmp = parse_xmp(path)
    if "relative_altitude" in xmp:
        # reference prefers relative altitude when present (:88-92)
        md.relative_altitude = xmp["relative_altitude"]
        md.altitude = xmp["relative_altitude"]
    if "rtk_std_lon" in xmp and "rtk_std_lat" in xmp:
        md.gps_accuracy_xy = max(xmp["rtk_std_lon"], xmp["rtk_std_lat"])
    if "rtk_std_hgt" in xmp:
        md.gps_accuracy_z = xmp["rtk_std_hgt"]
    if all(k in xmp for k in ("roll", "pitch", "yaw")):
        md.rotation_offset = 0.0
        # store gimbal angles as a quaternion prior (z-down yaw/pitch/roll)
        r, p, y = (math.radians(xmp[k]) for k in ("roll", "pitch", "yaw"))
        cy, sy = math.cos(y / 2), math.sin(y / 2)
        cp, sp = math.cos(p / 2), math.sin(p / 2)
        cr, sr = math.cos(r / 2), math.sin(r / 2)
        md.abs_orientation = np.array(
            [
                cr * cp * cy + sr * sp * sy,
                sr * cp * cy - cr * sp * sy,
                cr * sp * cy + sr * cp * sy,
                cr * cp * sy - sr * sp * cy,
            ]
        )
    return md
