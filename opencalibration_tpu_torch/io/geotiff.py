"""Minimal GeoTIFF writer/reader (pure Python, no GDAL).

The reference writes orthomosaic/DSM rasters through GDAL
(reference src/ortho/ortho.cpp:745-963 createDSMGeoTIFF etc.); this
environment has no GDAL, so this module implements the subset of
TIFF 6.0 + GeoTIFF 1.1 the pipeline needs:

* strip-organized little-endian TIFF, one IFD;
* uint8 multi-band (RGBA orthomosaic, camera-id sidecars) and float32
  single-band (DSM) pixel types, optional deflate compression;
* georeferencing via ModelPixelScaleTag (33550) + ModelTiepointTag
  (33922) and a GeoKeyDirectory declaring a user-defined projected CS,
  with the full WKT carried in the PCSCitation geokey and GDAL's
  GDAL_METADATA ascii tag — the same custom-TM WKT the reference puts in
  its GeoTIFFs (geo_coord.cpp getWKT).

Readers: numpy round-trip of the files this module writes (for tests and
the tile-streaming blend pass).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

# TIFF tags
T_NEW_SUBFILE_TYPE = 254
T_IMAGE_WIDTH = 256
T_IMAGE_LENGTH = 257
T_BITS_PER_SAMPLE = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_STRIP_OFFSETS = 273
T_SAMPLES_PER_PIXEL = 277
T_ROWS_PER_STRIP = 278
T_STRIP_BYTE_COUNTS = 279
T_PLANAR_CONFIG = 284
T_TILE_WIDTH = 322
T_TILE_LENGTH = 323
T_TILE_OFFSETS = 324
T_TILE_BYTE_COUNTS = 325
T_EXTRA_SAMPLES = 338
T_SAMPLE_FORMAT = 339
T_MODEL_PIXEL_SCALE = 33550
T_MODEL_TIEPOINT = 33922
T_GEO_KEY_DIRECTORY = 34735
T_GEO_ASCII_PARAMS = 34737
T_GDAL_NODATA = 42113

TYPE_SHORT = 3
TYPE_LONG = 4
TYPE_DOUBLE = 12
TYPE_ASCII = 2

_TYPE_SIZE = {TYPE_SHORT: 2, TYPE_LONG: 4, TYPE_DOUBLE: 8, TYPE_ASCII: 1}


def _pack_value(ttype, values):
    fmt = {TYPE_SHORT: "H", TYPE_LONG: "I", TYPE_DOUBLE: "d"}[ttype]
    return struct.pack("<" + fmt * len(values), *values)


class _IFD:
    def __init__(self):
        self.entries = []  # (tag, type, count, payload_bytes)

    def add(self, tag, ttype, values):
        if ttype == TYPE_ASCII:
            payload = values.encode("ascii") + b"\x00"
            count = len(payload)
        else:
            if not isinstance(values, (list, tuple)):
                values = [values]
            payload = _pack_value(ttype, values)
            count = len(values)
        self.entries.append((tag, ttype, count, payload))

    def serialize(self, data_start: int) -> Tuple[bytes, bytes]:
        """Returns (ifd_bytes, out_of_line_data). data_start = file offset
        where out-of-line data will be written."""
        self.entries.sort(key=lambda e: e[0])
        out_of_line = b""
        entry_bytes = b""
        for tag, ttype, count, payload in self.entries:
            if len(payload) <= 4:
                value_field = payload + b"\x00" * (4 - len(payload))
            else:
                offset = data_start + len(out_of_line)
                value_field = struct.pack("<I", offset)
                out_of_line += payload
                if len(out_of_line) % 2:
                    out_of_line += b"\x00"
            entry_bytes += struct.pack("<HHI", tag, ttype, count) + value_field
        ifd = struct.pack("<H", len(self.entries)) + entry_bytes + struct.pack("<I", 0)
        return ifd, out_of_line


def _geo_keys(wkt: Optional[str]):
    """GeoKeyDirectory for a user-defined projected CS + citation."""
    ascii_params = (wkt or "unknown") + "|"
    # key entries: (KeyID, TIFFTagLocation, Count, Value/Offset)
    keys = [
        (1024, 0, 1, 1),  # GTModelTypeGeoKey = Projected
        (1025, 0, 1, 1),  # GTRasterTypeGeoKey = PixelIsArea
        (3072, 0, 1, 32767),  # ProjectedCSTypeGeoKey = user-defined
        (3073, T_GEO_ASCII_PARAMS, len(ascii_params) - 1, 0),  # PCSCitation
        (3076, 0, 1, 9001),  # ProjLinearUnitsGeoKey = metre
    ]
    header = (1, 1, 1, len(keys))
    flat = list(header)
    for k in keys:
        flat.extend(k)
    return flat, ascii_params


def _average_downsample(image: np.ndarray) -> np.ndarray:
    """2x AVERAGE overview (the resampling the reference requests from
    GDAL, ortho.cpp BuildOverviews 'AVERAGE')."""
    H, W, C = image.shape
    h2, w2 = H // 2 * 2, W // 2 * 2
    img = image[:h2, :w2].astype(np.float64)
    down = 0.25 * (
        img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2] + img[1::2, 1::2]
    )
    return down.astype(image.dtype)


def write_geotiff(
    path: str,
    image: np.ndarray,
    origin_xy: Tuple[float, float],
    pixel_size: Tuple[float, float],
    wkt: Optional[str] = None,
    nodata: Optional[float] = None,
    compress: bool = True,
    overviews: int = 0,
):
    """Write [H, W] float32 or [H, W, C] uint8 raster.

    origin_xy: world (x, y) of the TOP-LEFT corner of pixel (0, 0);
    pixel_size: (sx, sy) with sy > 0 (north-up rasters store y flipped,
    i.e. world_y = origin_y - row * sy), matching GDAL conventions.
    overviews: number of 2x AVERAGE reduced-resolution IFDs to append
    (GDAL-style internal overviews; readers see them as subfile IFDs).
    """
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[:, :, None]
    if overviews > 0:
        # write the base IFD + chained overview IFDs
        levels = [image]
        for _ in range(overviews):
            if min(levels[-1].shape[0], levels[-1].shape[1]) < 2:
                break
            levels.append(_average_downsample(levels[-1]))
        _write_multi_ifd(
            path, levels, origin_xy, pixel_size, wkt, nodata, compress
        )
        return
    H, W, C = image.shape
    is_float = image.dtype.kind == "f"
    if is_float:
        image = image.astype("<f4")
        bits = [32] * C
        sample_format = [3] * C
    else:
        image = image.astype(np.uint8)
        bits = [8] * C
        sample_format = [1] * C

    rows_per_strip = max(1, min(H, (1 << 20) // max(1, W * C * (4 if is_float else 1))))
    strips = []
    for r0 in range(0, H, rows_per_strip):
        raw = image[r0 : r0 + rows_per_strip].tobytes()
        strips.append(zlib.compress(raw, 6) if compress else raw)

    ifd = _IFD()
    ifd.add(T_IMAGE_WIDTH, TYPE_LONG, W)
    ifd.add(T_IMAGE_LENGTH, TYPE_LONG, H)
    ifd.add(T_BITS_PER_SAMPLE, TYPE_SHORT, bits)
    ifd.add(T_COMPRESSION, TYPE_SHORT, 8 if compress else 1)  # 8 = deflate
    ifd.add(T_PHOTOMETRIC, TYPE_SHORT, 2 if (C >= 3 and not is_float) else 1)
    ifd.add(T_SAMPLES_PER_PIXEL, TYPE_SHORT, C)
    ifd.add(T_ROWS_PER_STRIP, TYPE_LONG, rows_per_strip)
    ifd.add(T_PLANAR_CONFIG, TYPE_SHORT, 1)
    ifd.add(T_SAMPLE_FORMAT, TYPE_SHORT, sample_format)
    if C == 4 and not is_float:
        ifd.add(T_EXTRA_SAMPLES, TYPE_SHORT, [2])  # unassociated alpha
    ifd.add(T_MODEL_PIXEL_SCALE, TYPE_DOUBLE, [pixel_size[0], pixel_size[1], 0.0])
    ifd.add(
        T_MODEL_TIEPOINT, TYPE_DOUBLE,
        [0.0, 0.0, 0.0, origin_xy[0], origin_xy[1], 0.0],
    )
    geo_dir, ascii_params = _geo_keys(wkt)
    ifd.add(T_GEO_KEY_DIRECTORY, TYPE_SHORT, geo_dir)
    ifd.add(T_GEO_ASCII_PARAMS, TYPE_ASCII, ascii_params)
    if nodata is not None:
        ifd.add(T_GDAL_NODATA, TYPE_ASCII, repr(float(nodata)))

    # layout: header(8) | strips | strip tables resolved into IFD | IFD | data
    header = struct.pack("<2sHI", b"II", 42, 0)  # IFD offset patched later
    strip_offsets = []
    pos = 8
    for s in strips:
        strip_offsets.append(pos)
        pos += len(s)
        if pos % 2:
            pos += 1
    ifd.add(T_STRIP_OFFSETS, TYPE_LONG, strip_offsets)
    ifd.add(T_STRIP_BYTE_COUNTS, TYPE_LONG, [len(s) for s in strips])

    ifd_offset = pos
    # out-of-line data goes after the IFD; IFD size depends only on entry count
    n_entries = len(ifd.entries)
    ifd_size = 2 + n_entries * 12 + 4
    ifd_bytes, out_of_line = ifd.serialize(ifd_offset + ifd_size)

    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, ifd_offset))
        p = 8
        for s, off in zip(strips, strip_offsets):
            assert p == off
            f.write(s)
            p += len(s)
            if p % 2:
                f.write(b"\x00")
                p += 1
        f.write(ifd_bytes)
        f.write(out_of_line)


def _prepare_level(image, origin_xy, pixel_size, wkt, nodata, compress, is_overview):
    """Strips + IFD entries (without strip tables) for one resolution level."""
    H, W, C = image.shape
    is_float = image.dtype.kind == "f"
    img = image.astype("<f4") if is_float else image.astype(np.uint8)
    bits = [32] * C if is_float else [8] * C
    sample_format = [3] * C if is_float else [1] * C

    rows_per_strip = max(1, min(H, (1 << 20) // max(1, W * C * (4 if is_float else 1))))
    strips = []
    for r0 in range(0, H, rows_per_strip):
        raw = img[r0 : r0 + rows_per_strip].tobytes()
        strips.append(zlib.compress(raw, 6) if compress else raw)

    ifd = _IFD()
    if is_overview:
        ifd.add(254, TYPE_LONG, 1)  # NewSubfileType = reduced-resolution
    ifd.add(T_IMAGE_WIDTH, TYPE_LONG, W)
    ifd.add(T_IMAGE_LENGTH, TYPE_LONG, H)
    ifd.add(T_BITS_PER_SAMPLE, TYPE_SHORT, bits)
    ifd.add(T_COMPRESSION, TYPE_SHORT, 8 if compress else 1)
    ifd.add(T_PHOTOMETRIC, TYPE_SHORT, 2 if (C >= 3 and not is_float) else 1)
    ifd.add(T_SAMPLES_PER_PIXEL, TYPE_SHORT, C)
    ifd.add(T_ROWS_PER_STRIP, TYPE_LONG, rows_per_strip)
    ifd.add(T_PLANAR_CONFIG, TYPE_SHORT, 1)
    ifd.add(T_SAMPLE_FORMAT, TYPE_SHORT, sample_format)
    if C == 4 and not is_float:
        ifd.add(T_EXTRA_SAMPLES, TYPE_SHORT, [2])
    if not is_overview:
        ifd.add(T_MODEL_PIXEL_SCALE, TYPE_DOUBLE, [pixel_size[0], pixel_size[1], 0.0])
        ifd.add(
            T_MODEL_TIEPOINT, TYPE_DOUBLE,
            [0.0, 0.0, 0.0, origin_xy[0], origin_xy[1], 0.0],
        )
        geo_dir, ascii_params = _geo_keys(wkt)
        ifd.add(T_GEO_KEY_DIRECTORY, TYPE_SHORT, geo_dir)
        ifd.add(T_GEO_ASCII_PARAMS, TYPE_ASCII, ascii_params)
        if nodata is not None:
            ifd.add(T_GDAL_NODATA, TYPE_ASCII, repr(float(nodata)))
    return strips, ifd


def _write_multi_ifd(path, levels, origin_xy, pixel_size, wkt, nodata, compress):
    """Chain of IFDs: full-resolution first, then overview subfiles."""
    prepared = [
        _prepare_level(
            lvl, origin_xy, pixel_size, wkt, nodata, compress, is_overview=i > 0
        )
        for i, lvl in enumerate(levels)
    ]
    # data layout: header | all strips | per-level (ifd + out-of-line)
    pos = 8
    strip_offsets_all = []
    for strips, _ in prepared:
        offs = []
        for s in strips:
            offs.append(pos)
            pos += len(s)
            if pos % 2:
                pos += 1
        strip_offsets_all.append(offs)
    for i, ((strips, ifd), offs) in enumerate(zip(prepared, strip_offsets_all)):
        ifd.add(T_STRIP_OFFSETS, TYPE_LONG, offs)
        ifd.add(T_STRIP_BYTE_COUNTS, TYPE_LONG, [len(s) for s in strips])

    # serialize IFDs sequentially, patching next-IFD pointers
    ifd_blobs = []
    ifd_offsets = []
    for strips, ifd in prepared:
        ifd_offsets.append(pos)
        n_entries = len(ifd.entries)
        ifd_size = 2 + n_entries * 12 + 4
        ifd_bytes, out_of_line = ifd.serialize(pos + ifd_size)
        blob = ifd_bytes + out_of_line
        if len(blob) % 2:
            blob += b"\x00"
        ifd_blobs.append(blob)
        pos += len(blob)
    # patch next pointers (last 4 bytes of the entry table region)
    patched = []
    for i, blob in enumerate(ifd_blobs):
        n_entries = struct.unpack_from("<H", blob, 0)[0]
        next_off = ifd_offsets[i + 1] if i + 1 < len(ifd_blobs) else 0
        head = 2 + n_entries * 12
        blob = blob[:head] + struct.pack("<I", next_off) + blob[head + 4 :]
        patched.append(blob)

    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, ifd_offsets[0]))
        p = 8
        for strips, _ in prepared:
            for s in strips:
                f.write(s)
                p += len(s)
                if p % 2:
                    f.write(b"\x00")
                    p += 1
        for blob in patched:
            f.write(blob)


def read_geotiff_overviews(path: str):
    """Count + shapes of reduced-resolution IFDs chained after the base."""
    with open(path, "rb") as f:
        data = f.read()
    _, _, ifd_off = struct.unpack_from("<2sHI", data, 0)
    shapes = []
    # skip base IFD, then walk the chain
    while ifd_off:
        (n,) = struct.unpack_from("<H", data, ifd_off)
        w = h = None
        for i in range(n):
            tag, ttype, count = struct.unpack_from("<HHI", data, ifd_off + 2 + i * 12)
            voff = ifd_off + 2 + i * 12 + 8
            if tag == T_IMAGE_WIDTH:
                w = struct.unpack_from("<I" if ttype == TYPE_LONG else "<H", data, voff)[0]
            if tag == T_IMAGE_LENGTH:
                h = struct.unpack_from("<I" if ttype == TYPE_LONG else "<H", data, voff)[0]
        shapes.append((h, w))
        (ifd_off,) = struct.unpack_from("<I", data, ifd_off + 2 + n * 12)
    return shapes


class GeoTiffTileWriter:
    """Streaming tiled-GeoTIFF writer: tiles are deflated and appended to
    the file the moment they are produced (any arrival order), the IFD is
    written at close and the header's IFD pointer back-patched — so peak
    memory is one tile plus the (quarter-res-and-smaller) overview
    accumulation buffers, independent of output size.

    This is the stand-in for the reference's incremental GDAL
    tile writes with async flush (reference src/ortho/ortho.cpp:1465-1640
    creates tiled GeoTIFFs and RasterIO-writes each tile as rendered).

    Supported pixel types: uint8 multi-band, float32, uint32 (used for the
    camera-id sidecar rasters, reference ortho.cpp camera-uuid layers).
    """

    def __init__(
        self,
        path: str,
        width: int,
        height: int,
        channels: int,
        dtype,
        origin_xy: Tuple[float, float],
        pixel_size: Tuple[float, float],
        tile_size: int = 256,
        wkt: Optional[str] = None,
        nodata: Optional[float] = None,
        compress: bool = True,
        overviews: int = 0,
    ):
        if tile_size % 16:
            raise ValueError("TIFF tile size must be a multiple of 16")
        self.width, self.height, self.channels = width, height, channels
        self.dtype = np.dtype(dtype)
        if self.dtype == np.uint8:
            self._bits, self._sample_format = 8, 1
        elif self.dtype == np.dtype("<f4") or self.dtype == np.float32:
            self.dtype = np.dtype("<f4")
            self._bits, self._sample_format = 32, 3
        elif self.dtype == np.uint32:
            self.dtype = np.dtype("<u4")
            self._bits, self._sample_format = 32, 1
        elif self.dtype == np.uint64:
            # one uint64 band: the reference's camera-id raster is uint64
            # camera ids round-tripped whole (test_ortho_functional)
            self.dtype = np.dtype("<u8")
            self._bits, self._sample_format = 64, 1
        else:
            raise ValueError(f"unsupported dtype {dtype}")
        self.tile_size = tile_size
        self.origin_xy = origin_xy
        self.pixel_size = pixel_size
        self.wkt = wkt
        self.nodata = nodata
        self.compress = compress
        self.tiles_x = (width + tile_size - 1) // tile_size
        self.tiles_y = (height + tile_size - 1) // tile_size
        n_tiles = self.tiles_x * self.tiles_y
        self._offsets = [0] * n_tiles
        self._counts = [0] * n_tiles
        self._written = set()
        # 2x-downsampled overview accumulators (quarter-area and smaller)
        self._n_overviews = overviews
        self._ov = []
        h, w = height, width
        for _ in range(overviews):
            h, w = max(1, h // 2), max(1, w // 2)
            self._ov.append(np.zeros((h, w, channels), self.dtype))
            if min(h, w) < 2:
                break
        self._f = open(path, "wb")
        self._f.write(struct.pack("<2sHI", b"II", 42, 0))  # IFD ptr patched at close
        self._pos = 8
        self._closed = False

    def write_tile(self, tx: int, ty: int, data: np.ndarray):
        """data: [th, tw, C] (edge tiles may be smaller; padded to full)."""
        idx = ty * self.tiles_x + tx
        if idx in self._written:
            raise ValueError(f"tile ({tx},{ty}) written twice")
        self._written.add(idx)
        data = np.asarray(data)
        if data.ndim == 2:
            data = data[:, :, None]
        th, tw = data.shape[:2]
        ts = self.tile_size
        full = np.zeros((ts, ts, self.channels), self.dtype)
        full[:th, :tw] = data.astype(self.dtype)
        raw = full.tobytes()
        blob = zlib.compress(raw, 6) if self.compress else raw
        self._offsets[idx] = self._pos
        self._counts[idx] = len(blob)
        self._f.write(blob)
        self._pos += len(blob)
        if self._pos % 2:
            self._f.write(b"\x00")
            self._pos += 1
        # accumulate overviews (2x AVERAGE per level)
        lvl_data = full[:th, :tw]
        x0, y0 = tx * ts, ty * ts
        for ov in self._ov:
            h2, w2 = lvl_data.shape[0] // 2 * 2, lvl_data.shape[1] // 2 * 2
            if h2 < 2 or w2 < 2:
                break
            d = lvl_data[:h2, :w2].astype(np.float64)
            down = 0.25 * (d[0::2, 0::2] + d[1::2, 0::2] + d[0::2, 1::2] + d[1::2, 1::2])
            x0, y0 = x0 // 2, y0 // 2
            oh, ow = ov.shape[:2]
            ph = min(down.shape[0], oh - y0)
            pw = min(down.shape[1], ow - x0)
            if ph <= 0 or pw <= 0:
                break
            ov[y0 : y0 + ph, x0 : x0 + pw] = down[:ph, :pw].astype(self.dtype)
            lvl_data = down[:ph, :pw]

    def _base_ifd(self) -> "_IFD":
        ifd = _IFD()
        ifd.add(T_IMAGE_WIDTH, TYPE_LONG, self.width)
        ifd.add(T_IMAGE_LENGTH, TYPE_LONG, self.height)
        ifd.add(T_BITS_PER_SAMPLE, TYPE_SHORT, [self._bits] * self.channels)
        ifd.add(T_COMPRESSION, TYPE_SHORT, 8 if self.compress else 1)
        is_rgb = self.channels >= 3 and self.dtype == np.uint8
        ifd.add(T_PHOTOMETRIC, TYPE_SHORT, 2 if is_rgb else 1)
        ifd.add(T_SAMPLES_PER_PIXEL, TYPE_SHORT, self.channels)
        ifd.add(T_PLANAR_CONFIG, TYPE_SHORT, 1)
        ifd.add(T_SAMPLE_FORMAT, TYPE_SHORT, [self._sample_format] * self.channels)
        if self.channels == 4 and self.dtype == np.uint8:
            ifd.add(T_EXTRA_SAMPLES, TYPE_SHORT, [2])
        return ifd

    def close(self):
        if self._closed:
            return
        self._closed = True
        # unwritten tiles -> one shared zero tile
        missing = [i for i in range(len(self._offsets)) if i not in self._written]
        if missing:
            zero = np.zeros((self.tile_size, self.tile_size, self.channels), self.dtype)
            raw = zero.tobytes()
            blob = zlib.compress(raw, 6) if self.compress else raw
            off = self._pos
            self._f.write(blob)
            self._pos += len(blob)
            if self._pos % 2:
                self._f.write(b"\x00")
                self._pos += 1
            for i in missing:
                self._offsets[i] = off
                self._counts[i] = len(blob)

        ifds = []
        base = self._base_ifd()
        base.add(T_TILE_WIDTH, TYPE_SHORT, self.tile_size)
        base.add(T_TILE_LENGTH, TYPE_SHORT, self.tile_size)
        base.add(T_TILE_OFFSETS, TYPE_LONG, self._offsets)
        base.add(T_TILE_BYTE_COUNTS, TYPE_LONG, self._counts)
        base.add(
            T_MODEL_PIXEL_SCALE, TYPE_DOUBLE,
            [self.pixel_size[0], self.pixel_size[1], 0.0],
        )
        base.add(
            T_MODEL_TIEPOINT, TYPE_DOUBLE,
            [0.0, 0.0, 0.0, self.origin_xy[0], self.origin_xy[1], 0.0],
        )
        geo_dir, ascii_params = _geo_keys(self.wkt)
        base.add(T_GEO_KEY_DIRECTORY, TYPE_SHORT, geo_dir)
        base.add(T_GEO_ASCII_PARAMS, TYPE_ASCII, ascii_params)
        if self.nodata is not None:
            base.add(T_GDAL_NODATA, TYPE_ASCII, repr(float(self.nodata)))
        ifds.append(base)

        # overview IFDs: strip-organized reduced-resolution subfiles
        ov_strip_info = []
        for ov in self._ov:
            H, W, C = ov.shape
            strips = []
            item = self.dtype.itemsize
            rows_per_strip = max(1, min(H, (1 << 20) // max(1, W * C * item)))
            offs, cnts = [], []
            for r0 in range(0, H, rows_per_strip):
                raw = np.ascontiguousarray(ov[r0 : r0 + rows_per_strip]).tobytes()
                blob = zlib.compress(raw, 6) if self.compress else raw
                offs.append(self._pos)
                cnts.append(len(blob))
                self._f.write(blob)
                self._pos += len(blob)
                if self._pos % 2:
                    self._f.write(b"\x00")
                    self._pos += 1
            ifd = _IFD()
            ifd.add(T_NEW_SUBFILE_TYPE, TYPE_LONG, 1)
            ifd.add(T_IMAGE_WIDTH, TYPE_LONG, W)
            ifd.add(T_IMAGE_LENGTH, TYPE_LONG, H)
            ifd.add(T_BITS_PER_SAMPLE, TYPE_SHORT, [self._bits] * C)
            ifd.add(T_COMPRESSION, TYPE_SHORT, 8 if self.compress else 1)
            is_rgb = C >= 3 and self.dtype == np.uint8
            ifd.add(T_PHOTOMETRIC, TYPE_SHORT, 2 if is_rgb else 1)
            ifd.add(T_SAMPLES_PER_PIXEL, TYPE_SHORT, C)
            ifd.add(T_ROWS_PER_STRIP, TYPE_LONG, rows_per_strip)
            ifd.add(T_PLANAR_CONFIG, TYPE_SHORT, 1)
            ifd.add(T_SAMPLE_FORMAT, TYPE_SHORT, [self._sample_format] * C)
            if C == 4 and self.dtype == np.uint8:
                ifd.add(T_EXTRA_SAMPLES, TYPE_SHORT, [2])
            ifd.add(T_STRIP_OFFSETS, TYPE_LONG, offs)
            ifd.add(T_STRIP_BYTE_COUNTS, TYPE_LONG, cnts)
            ifds.append(ifd)
            ov_strip_info.append((offs, cnts))

        # serialize the IFD chain after the pixel data
        pos = self._pos
        blobs, offsets = [], []
        for ifd in ifds:
            offsets.append(pos)
            n_entries = len(ifd.entries)
            ifd_size = 2 + n_entries * 12 + 4
            ifd_bytes, out_of_line = ifd.serialize(pos + ifd_size)
            blob = ifd_bytes + out_of_line
            if len(blob) % 2:
                blob += b"\x00"
            blobs.append(blob)
            pos += len(blob)
        for i, blob in enumerate(blobs):
            n_entries = struct.unpack_from("<H", blob, 0)[0]
            next_off = offsets[i + 1] if i + 1 < len(blobs) else 0
            head = 2 + n_entries * 12
            self._f.write(blob[:head] + struct.pack("<I", next_off) + blob[head + 4 :])
        self._f.seek(4)
        self._f.write(struct.pack("<I", offsets[0]))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_geotiff(path: str):
    """Read a (this-module or compatible strip- or tile-based) GeoTIFF.

    Returns (image [H, W, C], origin_xy, pixel_size, wkt_or_None).
    """
    with open(path, "rb") as f:
        data = f.read()
    order, magic, ifd_off = struct.unpack_from("<2sHI", data, 0)
    if order != b"II" or magic != 42:
        raise ValueError("not a little-endian TIFF")
    (n,) = struct.unpack_from("<H", data, ifd_off)
    tags = {}
    for i in range(n):
        tag, ttype, count = struct.unpack_from("<HHI", data, ifd_off + 2 + i * 12)
        value_off = ifd_off + 2 + i * 12 + 8
        size = _TYPE_SIZE[ttype] * count
        if size <= 4:
            payload = data[value_off : value_off + size]
        else:
            (off,) = struct.unpack_from("<I", data, value_off)
            payload = data[off : off + size]
        if ttype == TYPE_ASCII:
            tags[tag] = payload.rstrip(b"\x00").decode("ascii", "replace")
        else:
            fmt = {TYPE_SHORT: "H", TYPE_LONG: "I", TYPE_DOUBLE: "d"}[ttype]
            tags[tag] = list(struct.unpack("<" + fmt * count, payload))

    W = tags[T_IMAGE_WIDTH][0]
    H = tags[T_IMAGE_LENGTH][0]
    C = tags.get(T_SAMPLES_PER_PIXEL, [1])[0]
    bits = tags[T_BITS_PER_SAMPLE][0]
    sf = tags.get(T_SAMPLE_FORMAT, [1])[0]
    compression = tags.get(T_COMPRESSION, [1])[0]
    rps = tags.get(T_ROWS_PER_STRIP, [H])[0]
    dtype = np.dtype("<f4") if (sf == 3 and bits == 32) else np.uint8

    if T_SAMPLE_FORMAT in tags and sf == 1 and bits == 32:
        dtype = np.dtype("<u4")
    if sf == 1 and bits == 64:
        dtype = np.dtype("<u8")

    def _decode(off, cnt):
        raw = data[off : off + cnt]
        if compression == 8:
            raw = zlib.decompress(raw)
        elif compression != 1:
            raise ValueError(f"unsupported compression {compression}")
        return raw

    if T_TILE_OFFSETS in tags:
        tw_ = tags[T_TILE_WIDTH][0]
        tl_ = tags[T_TILE_LENGTH][0]
        tiles_x = (W + tw_ - 1) // tw_
        img = np.zeros((H, W, C), dtype)
        for idx, (off, cnt) in enumerate(
            zip(tags[T_TILE_OFFSETS], tags[T_TILE_BYTE_COUNTS])
        ):
            tile = np.frombuffer(_decode(off, cnt), dtype=dtype).reshape(tl_, tw_, C)
            ty, tx = divmod(idx, tiles_x)
            y0, x0 = ty * tl_, tx * tw_
            img[y0 : y0 + tl_, x0 : x0 + tw_] = tile[
                : min(tl_, H - y0), : min(tw_, W - x0)
            ]
    else:
        flat = b"".join(
            _decode(off, cnt)
            for off, cnt in zip(tags[T_STRIP_OFFSETS], tags[T_STRIP_BYTE_COUNTS])
        )
        img = np.frombuffer(flat, dtype=dtype, count=H * W * C).reshape(H, W, C).copy()

    scale = tags.get(T_MODEL_PIXEL_SCALE)
    tie = tags.get(T_MODEL_TIEPOINT)
    origin = (tie[3], tie[4]) if tie else (0.0, 0.0)
    px = (scale[0], scale[1]) if scale else (1.0, 1.0)
    wkt = None
    if T_GEO_ASCII_PARAMS in tags:
        wkt = tags[T_GEO_ASCII_PARAMS].split("|")[0]
        if wkt == "unknown":
            wkt = None
    return img, origin, px, wkt
