"""Synthetic aerial survey: a textured ground, flat or with sinusoidal relief,
seen by a nadir camera grid, with exact ground truth (twin of ``make_texture``, ``camera_grid``,
``render_views`` and ``write_survey`` in tests/synthetic_survey.py, without
JAX).

Image size, focal length and texture size are parameters; the defaults are
the JAX fixture's. Scaling all three together keeps the ground footprint and
the overlap of every image. ``write_survey`` writes 8-bit binary PGM files,
or with ``color=True`` binary PPM files, or with ``fmt="jpg"`` JPEG files
(quality 95), all of which the port decodes without OpenCV, each with the JSON sidecar geotag the pipeline reads. A colour
survey keeps the gray survey's luminance and tints it with a low-frequency
chroma texture; an optional per-image exposure gain gives the orthomosaic's
colour balance something to flatten. ``write_survey(..., fmt="jpg",
jpeg_quality=BENCH_JPEG_QUALITY)`` with the other defaults is the survey the
JAX package's bench_e2e.py writes (gray, 320 x 240, quality 98).
"""

from __future__ import annotations

import functools
import json
import math
import os

import numpy as np
import torch

from opencalibration_tpu_torch.geo.geo_coord import GeoCoord
from opencalibration_tpu_torch.io.jpeg import encode_jpeg
from opencalibration_tpu_torch.ops import distort as D
from opencalibration_tpu_torch.ops.features import _bilinear
from opencalibration_tpu_torch.ops.quaternion import (
    quat_from_axis_angle,
    quat_multiply,
    quat_rotate,
)
from opencalibration_tpu_torch.types.camera import CameraModel
from opencalibration_tpu_torch.utils.device import resolve_device

ORIGIN_LAT, ORIGIN_LON = 47.4, 8.5
IMG_W, IMG_H = 320, 240
FOCAL = 400.0
ALTITUDE = 60.0
TEXTURE_SIZE = 512
JPEG_QUALITY = 95
BENCH_JPEG_QUALITY = 98  # the JAX package's bench survey (tests/synthetic_survey.py)
RENDER_CHUNK = 64  # cameras rendered, encoded and dropped at a time


def make_texture(seed=0, size=TEXTURE_SIZE):
    """[size, size] float32 texture in [0, 1]: smoothed blocks plus sparse
    bright dots for strong features."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    tex = gaussian_filter(np.kron(rng.normal(size=(size // 8, size // 8)), np.ones((8, 8))), 2.0)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    tex += 0.15 * (rng.random(tex.shape) > 0.995)
    return np.clip(tex, 0, 1).astype(np.float32)


def make_chroma(seed=0, size=TEXTURE_SIZE):
    """[size, size, 2] float32 in [0, 1]: two fields that tint red and blue,
    each a smooth low-frequency part (blobs of about an eighth of the
    texture) plus a fifth of finer block detail, so neighbouring pixels
    rarely share a chroma value."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed + 7919)
    out = []
    for _ in range(2):
        c = gaussian_filter(np.kron(rng.normal(size=(8, 8)), np.ones((size // 8, size // 8))), size / 16.0)
        c = (c - c.min()) / (c.max() - c.min())
        fine = gaussian_filter(np.kron(rng.normal(size=(size // 8, size // 8)), np.ones((8, 8))), 2.0)
        fine = (fine - fine.min()) / (fine.max() - fine.min())
        out.append(0.8 * c + 0.2 * fine)
    return np.stack(out, axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=2)
def color_texture(seed=0, size=TEXTURE_SIZE):
    """[size, size, 3] float32: ``make_texture`` and the two ``make_chroma``
    fields, the colour survey's ground texture. Kept for the next caller
    (the chroma's wide blur takes seconds at full size): callers share the
    array and must not write to it."""
    return np.concatenate([make_texture(seed, size)[..., None], make_chroma(seed, size)], axis=-1)


def colorize(lum, chroma):
    """Luminance [...] and chroma [..., 2] in [0, 1] -> RGB [..., 3] in
    [0, 1]: green carries the luminance, red and blue are scaled by
    0.75 .. 1.25 with the chroma fields. numpy arrays or tensors."""
    r = lum * (0.75 + 0.5 * chroma[..., 0])
    b = lum * (0.75 + 0.5 * chroma[..., 1])
    stack = torch.stack if isinstance(lum, torch.Tensor) else np.stack
    return stack([r, lum, b], -1).clip(0, 1)


def survey_gains(count, seed=0, spread=0.1):
    """Seeded per-image exposure gains in [1 - spread, 1 + spread]."""
    return np.random.default_rng(seed + 104729).uniform(1.0 - spread, 1.0 + spread, size=count)


def survey_extent(positions):
    """Side of the textured ground square that ``write_survey`` renders."""
    return max(150.0, float(np.asarray(positions)[:, :2].max()) + 60.0)


def sample_ground(tex, xy, ground_extent):
    """Bilinear sample of a [size, size] or [size, size, C] texture at ground
    points xy [P, 2] (numpy), as ``render_views`` samples it."""
    t = torch.as_tensor(tex, dtype=torch.float32)
    size = t.shape[0]
    xy = torch.as_tensor(np.asarray(xy), dtype=torch.float32)
    u = torch.clamp(xy[:, 0] / ground_extent * (size - 1), 0, size - 1)
    v = torch.clamp(xy[:, 1] / ground_extent * (size - 1), 0, size - 1)
    if t.ndim == 2:
        return _bilinear(t, u, v).numpy()
    return torch.stack([_bilinear(t[..., c], u, v) for c in range(t.shape[-1])], -1).numpy()


def camera_grid(rows, cols, spacing=15.0, seed=1, alt_pattern="row"):
    """Ground-truth poses (numpy, float64): nadir plus a small random yaw,
    positions on a grid, altitude alternating between two levels per row
    ('row') or per image ('checker')."""
    rng = np.random.default_rng(seed)
    down = torch.tensor([0.0, 1.0, 0.0, 0.0], dtype=torch.float64)
    z_axis = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)
    positions, quats = [], []
    for r in range(rows):
        for c in range(cols):
            alt_bit = (r + c) % 2 if alt_pattern == "checker" else r % 2
            positions.append([30.0 + c * spacing, 30.0 + r * spacing, ALTITUDE + alt_bit * 25.0])
            yaw = torch.tensor(rng.uniform(-0.15, 0.15), dtype=torch.float64)
            quats.append(quat_multiply(quat_from_axis_angle(z_axis, yaw), down).numpy())
    return np.asarray(positions), np.stack(quats)


def knn_pairs(positions, neighbours=3):
    """Sorted unique (a < b) pairs linking each camera to its nearest
    ``neighbours`` in the ground plane, as ``bench.py::build_workload``
    builds them. Returns (pa, pb) int32 arrays."""
    pairs = set()
    for i in range(len(positions)):
        d2 = np.sum((positions[:, :2] - positions[i, :2]) ** 2, axis=1)
        for j in np.argsort(d2)[1 : neighbours + 1]:
            pairs.add((min(i, int(j)), max(i, int(j))))
    pairs = sorted(pairs)
    return (np.asarray([p[0] for p in pairs], np.int32), np.asarray([p[1] for p in pairs], np.int32))


def relief_height(xy, amplitude, wavelength):
    """Terrain height at ground points xy [..., 2]:
    amplitude * sin(2 pi x / wavelength) * cos(2 pi y / wavelength)."""
    k = 2.0 * math.pi / wavelength
    return amplitude * (torch.sin(k * xy[..., 0]) * torch.cos(k * xy[..., 1]))


def render_views(tex, positions, quats, *, width=IMG_W, height=IMG_H, focal=FOCAL,
                 ground_extent=150.0, relief_amplitude=0.0, relief_wavelength=70.0, device):
    """Render [C, height, width] float32 views of the textured ground
    spanning [0, ground_extent]^2, one camera at a time on ``device``
    ([C, height, width, K] for a texture of K channels). The
    ground is the plane z = 0, or with ``relief_amplitude`` the height field
    ``relief_height``, reached by six fixed-point steps along each ray."""
    device = resolve_device(device)
    model = CameraModel.create(
        focal, (width / 2, height / 2), pixels_cols=width, pixels_rows=height, device=device
    )
    texj = torch.as_tensor(tex, dtype=torch.float32, device=device)
    size = texj.shape[0]
    channels = [texj] if texj.ndim == 2 else list(texj.unbind(-1))
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    dirs = D.image_to_3d(torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1), model)
    views = []
    for q, t in zip(quats, positions):
        q = torch.as_tensor(q, dtype=torch.float32, device=device)
        t = torch.as_tensor(t, dtype=torch.float32, device=device)
        wd = quat_rotate(q, dirs)
        s = -t[2] / wd[:, 2]
        if relief_amplitude:
            for _ in range(6):
                xy = t[None, :2] + s[:, None] * wd[:, :2]
                s = (relief_height(xy, relief_amplitude, relief_wavelength) - t[2]) / wd[:, 2]
        ground = t[None] + s[:, None] * wd
        u = torch.clamp(ground[:, 0] / ground_extent * (size - 1), 0, size - 1)
        v = torch.clamp(ground[:, 1] / ground_extent * (size - 1), 0, size - 1)
        view = [_bilinear(c, u, v).reshape(height, width) for c in channels]
        views.append(view[0] if texj.ndim == 2 else torch.stack(view, -1))
    return torch.stack(views)


def write_pgm(path, gray: np.ndarray):
    """[H, W] uint8 -> binary 8-bit PGM."""
    h, w = gray.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(gray, np.uint8).tobytes())


def write_ppm(path, rgb: np.ndarray):
    """[H, W, 3] uint8 RGB -> binary 8-bit PPM."""
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgb, np.uint8).tobytes())


def write_survey(directory, rows=2, cols=3, spacing=15.0, seed=0, *, width=IMG_W, height=IMG_H,
                 focal=FOCAL, focal_px_tag=None, texture=None, relief_amplitude=0.0, relief_wavelength=70.0,
                 alt_pattern="row", color=False, gains=None, fmt="netpbm", jpeg_quality=JPEG_QUALITY, device):
    """Render the survey and write ``IMG_<i>.pgm`` files with JSON sidecars
    (latitude, longitude, altitude, focal_length_px, camera make and model)
    into ``directory``. The texture spans the survey's footprint plus 60 m;
    its size defaults to the reference fixture's (512 px per 150 m, at most
    4096). ``relief_amplitude`` and ``relief_wavelength`` (metres) shape the
    terrain, as in ``render_views``. ``focal_px_tag`` is the focal length
    written into the geotags (default: the render's true ``focal``); a wrong
    one gives the intrinsics calibration something to recover. ``color=True``
    writes ``IMG_<i>.ppm`` instead: the same luminance tinted by
    ``make_chroma(seed)`` through ``colorize``, each image multiplied by its
    entry of ``gains`` (e.g. ``survey_gains``) where given. ``fmt="jpg"``
    writes ``IMG_<i>.jpg`` through the port's JPEG encoder at
    ``jpeg_quality`` (one component for gray, 4:2:0 colour) instead of
    Netpbm. Cameras are rendered and written ``RENDER_CHUNK`` at a time, so a
    survey of thousands of images is never in memory whole. Returns (paths,
    positions, quats)."""
    if fmt not in ("netpbm", "jpg"):
        raise ValueError(f"write_survey writes fmt 'netpbm' or 'jpg', not {fmt!r}")
    positions, quats = camera_grid(rows, cols, spacing, seed + 1, alt_pattern)
    extent = survey_extent(positions)
    if texture is None:
        texture = min(4096, max(512, int(extent / 150.0 * 512)))
    tex = color_texture(seed, texture) if color else make_texture(seed, size=texture)
    geo = GeoCoord()
    geo.set_origin(ORIGIN_LAT, ORIGIN_LON)
    paths = []
    for c0 in range(0, len(positions), RENDER_CHUNK):
        views = render_views(tex, positions[c0:c0 + RENDER_CHUNK], quats[c0:c0 + RENDER_CHUNK], width=width,
                             height=height, focal=focal, ground_extent=extent, relief_amplitude=relief_amplitude,
                             relief_wavelength=relief_wavelength, device=device).cpu().numpy()
        if color:
            views = colorize(views[..., 0], views[..., 1:])
            if gains is not None:
                chunk_gains = np.asarray(gains, np.float32)[c0:c0 + len(views)]
                views = np.clip(views * chunk_gains[:, None, None, None], 0, 1)
        for i, img in enumerate((views * 255).astype(np.uint8), start=c0):
            if fmt == "jpg":
                path = os.path.join(directory, f"IMG_{i:04d}.jpg")
                with open(path, "wb") as f:
                    f.write(encode_jpeg(img[..., ::-1] if color else img, jpeg_quality))
            else:
                path = os.path.join(directory, f"IMG_{i:04d}." + ("ppm" if color else "pgm"))
                (write_ppm if color else write_pgm)(path, img)
            lat, lon, _ = geo.to_wgs84(positions[i])
            with open(os.path.splitext(path)[0] + ".json", "w") as f:
                json.dump(dict(
                    latitude=float(lat), longitude=float(lon), altitude=float(positions[i][2]),
                    focal_length_px=float(focal if focal_px_tag is None else focal_px_tag), camera_make="Synthetic",
                    camera_model="TestCam",
                ), f)
            paths.append(path)
    return paths, positions, quats
