"""Synthetic drone surveys for the benchmark, made from a seed.

A frozen rewrite, in plain torch and numpy, of ``make_texture``,
``make_chroma``, ``colorize``, ``camera_grid``, ``render_views`` and the
sidecar writer of ``write_survey`` in opencalibration_tpu_torch/testing/survey.py
at commit 3a365f3897db20a853d4aa1c09f57b88461614aa, and of the transverse
Mercator inverse of opencalibration_tpu_torch/geo/geo_coord.py at the same
commit. It imports nothing of the program, so the yardstick does not move
when the program changes. What it adds: the texture made on the device from
a ``torch.Generator``, flight lines in serpentine order with separate
along-track and across-track spacings, one flight height, trigger positions
off the plan by a drawn amount (``position_jitter_m``, none by default), a
geotag origin at the first image of the flight, placed anywhere on the
globe, JPEG through the benchmark's own encoder, and a cache of a whole
survey's JPEGs inside the checkout (``cached_survey``).

World frame: x east, y north, z up, metres; the ground is z = 0, or the relief
``relief_height``. Cameras look down (the quaternion ``[0, 1, 0, 0]`` turned by
a small heading); image x runs across track (east), image y along track. The
pipeline's local frame has its origin at the first image of the flight, so a
camera's local position is its world position less that image's x and y.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import math
import os
import shutil
import tempfile
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ocbench.jpeg import SOURCE as JPEG_SOURCE
from ocbench.jpeg import encode_jpeg

ORIGIN_LAT, ORIGIN_LON = 47.4, 8.5
MARGIN_M = 30.0  # from the texture's edge to the first flight line and image
RENDER_CHUNK = 8  # cameras rendered at a time
ENCODE_THREADS = 8


@dataclasses.dataclass
class SurveySpec:
    """A survey deployment, as a configuration file states it."""

    width: int
    height: int
    focal_px: float
    altitude_m: float
    along_track_m: float
    across_track_m: float
    lines: int
    per_line: int
    texture_px_per_150m: int
    jpeg_quality: int
    relief_amplitude_m: float = 0.0
    relief_wavelength_m: float = 70.0
    focal_tag_scale: float = 1.0
    gain_spread: float = 0.0
    yaw_jitter_rad: float = 0.15
    position_jitter_m: float = 0.0

    @classmethod
    def from_config(cls, cfg: dict) -> "SurveySpec":
        return cls(**cfg["survey"])


@dataclasses.dataclass
class Survey:
    """The written survey and its truth: image paths in flight order, world
    positions [N, 3], orientations [N, 4] (w, x, y, z; camera to world) and
    exposure gains [N], all float64."""

    spec: SurveySpec
    paths: List[str]
    positions: np.ndarray
    quats: np.ndarray
    gains: np.ndarray
    index: np.ndarray  # (line, position along the line) of each image

    @property
    def origin_xy(self) -> np.ndarray:
        return self.positions[0, :2]

    def local_positions(self) -> np.ndarray:
        out = self.positions.copy()
        out[:, :2] -= self.origin_xy
        return out


# --- flight plan -------------------------------------------------------------

def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw])


def flight_plan(spec: SurveySpec, seed: int, lines=None, per_line=None):
    """Every image of the survey in flight order: line by line across track,
    each line flown the other way from the last (serpentine). ``lines`` and
    ``per_line`` (ranges) pick a block of it, flown in the same order. Each
    trigger position is off the plan by up to ``position_jitter_m`` east and
    north (uniform), so that no two distances between neighbours tie: on an
    exact grid the geotags' rounding, which moves with their origin, decides
    which of several equally near images are a camera's nearest. Returns
    (positions [N, 3], quats [N, 4], index [N, 2])."""
    rng = np.random.default_rng(seed)
    yaws = rng.uniform(-spec.yaw_jitter_rad, spec.yaw_jitter_rad, size=(spec.lines, spec.per_line))
    off = np.zeros((spec.lines, spec.per_line, 2))
    if spec.position_jitter_m:
        off = rng.uniform(-spec.position_jitter_m, spec.position_jitter_m, size=off.shape)
    down = np.array([0.0, 1.0, 0.0, 0.0])
    positions, quats, index = [], [], []
    for line in (range(spec.lines) if lines is None else lines):
        along = range(spec.per_line) if per_line is None else per_line
        for j in (along if line % 2 == 0 else reversed(along)):
            positions.append([MARGIN_M + line * spec.across_track_m + off[line, j, 0],
                              MARGIN_M + j * spec.along_track_m + off[line, j, 1], spec.altitude_m])
            half = 0.5 * yaws[line, j]
            quats.append(_quat_mul(np.array([math.cos(half), 0.0, 0.0, math.sin(half)]), down))
            index.append((line, j))
    return np.asarray(positions, np.float64), np.asarray(quats, np.float64), np.asarray(index, np.int64)


def pick_block(spec: SurveySpec, seed: int, lines: int, per_line: int):
    """A block of ``lines`` x ``per_line`` images drawn from the seed:
    (line range, along-track range)."""
    rng = np.random.default_rng(seed + 15485863)
    l0 = int(rng.integers(0, spec.lines - lines + 1))
    j0 = int(rng.integers(0, spec.per_line - per_line + 1))
    return range(l0, l0 + lines), range(j0, j0 + per_line)


def draw_origin(seed: int, max_latitude: float):
    """The first image's geotag (latitude, longitude in degrees) drawn from
    the seed: latitude within +-``max_latitude``, any longitude."""
    rng = np.random.default_rng(seed + 7919)
    return float(rng.uniform(-max_latitude, max_latitude)), float(rng.uniform(-180.0, 180.0))


def survey_extent(spec: SurveySpec) -> float:
    """Side of the textured square [0, extent]^2 that holds the whole survey
    and its footprints."""
    far = MARGIN_M + max((spec.lines - 1) * spec.across_track_m, (spec.per_line - 1) * spec.along_track_m)
    return max(150.0, far + 2.0 * MARGIN_M)


# --- ground texture ------------------------------------------------------------

def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [H, W] with reflected borders, 4 sigma wide."""
    r = int(math.ceil(4.0 * sigma))
    x = torch.arange(-r, r + 1, dtype=img.dtype, device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    out = F.pad(img[None, None], (r, r, 0, 0), mode="reflect")
    out = F.conv2d(out, k.view(1, 1, 1, -1))
    out = F.pad(out, (0, 0, r, r), mode="reflect")
    return F.conv2d(out, k.view(1, 1, -1, 1))[0, 0]


def _unit(t: torch.Tensor) -> torch.Tensor:
    return (t - t.min()) / (t.max() - t.min())


def _blocks(gen, n: int, block: int, device) -> torch.Tensor:
    """An [n, n] field of normal values, constant over block x block cells."""
    cells = torch.randn((n // block, n // block), generator=gen, device=device)
    return cells.repeat_interleave(block, 0).repeat_interleave(block, 1)


def make_texture(seed: int, size: int, device) -> torch.Tensor:
    """[size, size, 3] float32 in [0, 1] on ``device``: luminance (blocks of
    8 px blurred, plus sparse bright dots for strong features) and two
    chroma fields (blobs of an eighth of the texture, plus a fifth of the
    block detail), as the program's test renderer makes them."""
    size -= size % 8
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lum = _unit(_blur(_blocks(gen, size, 8, device), 2.0))
    lum = (lum + 0.15 * (torch.rand((size, size), generator=gen, device=device) > 0.995)).clamp(0, 1)
    chroma = []
    for _ in range(2):
        coarse = _unit(_blur(_blocks(gen, 128, 16, device), 8.0))
        coarse = F.interpolate(coarse[None, None], size=(size, size), mode="bilinear", align_corners=False)[0, 0]
        fine = _unit(_blur(_blocks(gen, size, 8, device), 2.0))
        chroma.append(0.8 * coarse + 0.2 * fine)
    return torch.stack([lum] + chroma, -1)


def relief_height(xy: torch.Tensor, amplitude: float, wavelength: float) -> torch.Tensor:
    """Terrain height at ground points xy [..., 2]:
    amplitude * sin(2 pi x / wavelength) * cos(2 pi y / wavelength)."""
    k = 2.0 * math.pi / wavelength
    return amplitude * (torch.sin(k * xy[..., 0]) * torch.cos(k * xy[..., 1]))


# --- rendering -----------------------------------------------------------------

def _rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v [..., 3] by unit quaternions q [..., 4]."""
    u, v = torch.broadcast_tensors(q[..., 1:], v)
    uv = torch.cross(u, v, dim=-1)
    return v + 2.0 * (q[..., :1] * uv + torch.cross(u, uv, dim=-1))


def _sample(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear samples [..., C] of tex [S, S, C] at texel coordinates."""
    S = tex.shape[0]
    u = u.clamp(0.0, S - 1.001)
    v = v.clamp(0.0, S - 1.001)
    u0, v0 = u.floor().long(), v.floor().long()
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    flat = tex.reshape(S * S, -1)

    def at(dv, du):
        return flat[(v0 + dv) * S + (u0 + du)]

    return at(0, 0) * (1 - fu) * (1 - fv) + at(0, 1) * fu * (1 - fv) + at(1, 0) * (1 - fu) * fv + at(1, 1) * fu * fv


def render_views(tex: torch.Tensor, positions: np.ndarray, quats: np.ndarray, spec: SurveySpec,
                 extent: float) -> torch.Tensor:
    """[C, H, W, 3] float32 RGB in [0, 1] of the cameras, on the texture's
    device: each pixel's ray meets the ground (six fixed-point steps onto
    the relief), which is sampled bilinearly; green carries the luminance,
    red and blue are scaled by 0.75 .. 1.25 with the chroma."""
    dev = tex.device
    ys, xs = torch.meshgrid(torch.arange(spec.height, dtype=torch.float32, device=dev),
                            torch.arange(spec.width, dtype=torch.float32, device=dev), indexing="ij")
    rays = torch.stack([(xs - spec.width / 2) / spec.focal_px, (ys - spec.height / 2) / spec.focal_px,
                        torch.ones_like(xs)], -1).reshape(-1, 3)
    rays = rays / rays.norm(dim=-1, keepdim=True)
    q = torch.as_tensor(quats, dtype=torch.float32, device=dev)[:, None]
    t = torch.as_tensor(positions, dtype=torch.float32, device=dev)[:, None]
    wd = _rotate(q, rays[None])
    s = -t[..., 2] / wd[..., 2]
    if spec.relief_amplitude_m:
        for _ in range(6):
            xy = t[..., :2] + s[..., None] * wd[..., :2]
            s = (relief_height(xy, spec.relief_amplitude_m, spec.relief_wavelength_m) - t[..., 2]) / wd[..., 2]
    ground = t[..., :2] + s[..., None] * wd[..., :2]
    scale = (tex.shape[0] - 1) / extent
    lcc = _sample(tex, ground[..., 0] * scale, ground[..., 1] * scale)
    lum = lcc[..., 0]
    rgb = torch.stack([lum * (0.75 + 0.5 * lcc[..., 1]), lum, lum * (0.75 + 0.5 * lcc[..., 2])], -1).clamp(0, 1)
    return rgb.reshape(len(positions), spec.height, spec.width, 3)


# --- geotags -------------------------------------------------------------------

class TransverseMercator:
    """Local transverse-Mercator metres -> WGS84 degrees about an origin
    (Karney's 6th-order Krueger series), as the program's GeoCoord."""

    def __init__(self, lat0: float, lon0: float):
        f = 1.0 / 298.257223563
        n = f / (2.0 - f)
        self.A = 6378137.0 / (1 + n) * (1 + n**2 / 4 + n**4 / 64 + n**6 / 256)
        alpha = np.array([
            n / 2 - 2 * n**2 / 3 + 5 * n**3 / 16 + 41 * n**4 / 180 - 127 * n**5 / 288 + 7891 * n**6 / 37800,
            13 * n**2 / 48 - 3 * n**3 / 5 + 557 * n**4 / 1440 + 281 * n**5 / 630 - 1983433 * n**6 / 1935360,
            61 * n**3 / 240 - 103 * n**4 / 140 + 15061 * n**5 / 26880 + 167603 * n**6 / 181440,
            49561 * n**4 / 161280 - 179 * n**5 / 168 + 6601661 * n**6 / 7257600,
            34729 * n**5 / 80640 - 3418889 * n**6 / 1995840,
            212378941 * n**6 / 319334400,
        ])
        self.beta = np.array([
            n / 2 - 2 * n**2 / 3 + 37 * n**3 / 96 - n**4 / 360 - 81 * n**5 / 512 + 96199 * n**6 / 604800,
            n**2 / 48 + n**3 / 15 - 437 * n**4 / 1440 + 46 * n**5 / 105 - 1118711 * n**6 / 3870720,
            17 * n**3 / 480 - 37 * n**4 / 840 - 209 * n**5 / 4480 + 5569 * n**6 / 90720,
            4397 * n**4 / 161280 - 11 * n**5 / 504 - 830251 * n**6 / 7257600,
            4583 * n**5 / 161280 - 108847 * n**6 / 3991680,
            20648693 * n**6 / 638668800,
        ])
        self.e = math.sqrt(f * (2 - f))
        self.lon0 = lon0
        # northing of the origin on its own central meridian
        phi = math.radians(lat0)
        t = math.sinh(math.atanh(math.sin(phi)) - self.e * math.atanh(self.e * math.sin(phi)))
        xi_p = math.atan2(t, 1.0)
        j = np.arange(1, 7)
        self.m0 = self.A * (xi_p + float(np.sum(alpha * np.sin(2 * j * xi_p))))

    def to_wgs84(self, local: np.ndarray) -> np.ndarray:
        """local [..., 3] -> [..., 3] (latitude, longitude, altitude)."""
        local = np.asarray(local, np.float64)
        eta = local[..., 0] / self.A
        xi = (local[..., 1] + self.m0) / self.A
        j = np.arange(1, 7)
        xi_p = xi - np.sum(self.beta * np.sin(2 * j * xi[..., None]) * np.cosh(2 * j * eta[..., None]), axis=-1)
        eta_p = eta - np.sum(self.beta * np.cos(2 * j * xi[..., None]) * np.sinh(2 * j * eta[..., None]), axis=-1)
        chi = np.arcsin(np.sin(xi_p) / np.cosh(eta_p))
        e, phi = self.e, chi
        for _ in range(5):
            sphi = np.sin(phi)
            t = np.sinh(np.arctanh(sphi) - e * np.arctanh(e * sphi))
            dt = np.sqrt(1 + t * t) * (1 - e * e) / ((1 - (e * sphi) ** 2) * np.cos(phi))
            phi = phi - (t - np.tan(chi)) / dt
        lon = np.degrees(np.arctan2(np.sinh(eta_p), np.cos(xi_p))) + self.lon0
        return np.stack([np.degrees(phi), lon, local[..., 2]], axis=-1)


# --- the survey on disk ----------------------------------------------------------

def plan_survey(directory: str, spec: SurveySpec, seed: int, lines=None, per_line=None) -> Survey:
    """The survey's truth drawn from ``seed``, its images ``IMG_<k>.jpg`` in
    flight order in ``directory``; nothing is written."""
    positions, quats, index = flight_plan(spec, seed, lines, per_line)
    gains = np.random.default_rng(seed + 104729).uniform(
        1.0 - spec.gain_spread, 1.0 + spec.gain_spread, size=(spec.lines, spec.per_line))[index[:, 0], index[:, 1]]
    paths = [os.path.join(directory, f"IMG_{k:04d}.jpg") for k in range(len(positions))]
    return Survey(spec=spec, paths=paths, positions=positions, quats=quats, gains=gains, index=index)


def _sidecar(survey: Survey, tags: np.ndarray, k: int):
    spec = survey.spec
    with open(survey.paths[k][:-4] + ".json", "w") as f:
        json.dump(dict(latitude=float(tags[k, 0]), longitude=float(tags[k, 1]), altitude=float(tags[k, 2]),
                       focal_length_px=spec.focal_px * spec.focal_tag_scale, camera_make="Synthetic",
                       camera_model="TestCam"), f)


def _geotags(survey: Survey, origin_latlon) -> np.ndarray:
    return TransverseMercator(*origin_latlon).to_wgs84(survey.local_positions())


def _render_jpegs(survey: Survey, seed: int, paths: List[str], device, then=None):
    """Render the survey's views on ``device`` and encode each into its path
    of ``paths`` on host threads; ``then(k)`` runs after image k is written."""
    spec = survey.spec
    extent = survey_extent(spec)
    tex = make_texture(seed, int(round(extent / 150.0 * spec.texture_px_per_150m)), device)

    def write(k: int, bgr: np.ndarray):
        with open(paths[k], "wb") as f:
            f.write(encode_jpeg(bgr, spec.jpeg_quality))
        if then is not None:
            then(k)

    gain_t = torch.as_tensor(survey.gains, dtype=torch.float32, device=tex.device)
    with concurrent.futures.ThreadPoolExecutor(ENCODE_THREADS) as pool:
        futures = []
        for c0 in range(0, len(paths), RENDER_CHUNK):
            c1 = min(c0 + RENDER_CHUNK, len(paths))
            rgb = render_views(tex, survey.positions[c0:c1], survey.quats[c0:c1], spec, extent)
            u8 = (rgb * gain_t[c0:c1, None, None, None]).clamp(0, 1).mul(255).to(torch.uint8)
            bgr = u8.flip(-1).cpu().numpy()
            futures += [pool.submit(write, k, bgr[k - c0]) for k in range(c0, c1)]
        for fut in futures:
            fut.result()


def write_survey(directory: str, spec: SurveySpec, seed: int, *, device, lines=None, per_line=None,
                 origin_latlon=(ORIGIN_LAT, ORIGIN_LON)) -> Survey:
    """Render the survey (or the block ``lines`` x ``per_line`` of it) from
    ``seed`` and write ``IMG_<k>.jpg`` in flight order with a JSON sidecar
    each (latitude, longitude, altitude, the focal tag, camera make and
    model) into ``directory``; the first image is geotagged at
    ``origin_latlon`` (degrees). Rendering runs on ``device``, JPEG encoding
    on host threads."""
    survey = plan_survey(directory, spec, seed, lines, per_line)
    tags = _geotags(survey, origin_latlon)
    _render_jpegs(survey, seed, survey.paths, device, then=lambda k: _sidecar(survey, tags, k))
    return survey


def _cache_key(spec: SurveySpec, seed: int) -> str:
    """What decides the JPEGs' bytes: the survey, its seed, and the sources
    of the renderer and the encoder."""
    h = hashlib.sha256(json.dumps([dataclasses.asdict(spec), seed], sort_keys=True).encode())
    for path in (os.path.abspath(__file__), JPEG_SOURCE):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def cached_survey(directory: str, spec: SurveySpec, seed: int, cache: str, *, device,
                  origin_latlon=(ORIGIN_LAT, ORIGIN_LON)) -> Survey:
    """``write_survey`` of the whole survey, with its JPEGs rendered once
    into ``cache/<key>`` and linked into ``directory``: they are the same for
    every origin. The sidecars, which carry the origin, are written anew."""
    survey = plan_survey(directory, spec, seed)
    done = os.path.join(cache, _cache_key(spec, seed))
    names = [os.path.basename(p) for p in survey.paths]
    if not os.path.isdir(done):
        os.makedirs(cache, exist_ok=True)
        part = tempfile.mkdtemp(prefix=".partial-", dir=cache)
        _render_jpegs(survey, seed, [os.path.join(part, n) for n in names], device)
        try:
            os.rename(part, done)
        except OSError:  # another process filled it first
            shutil.rmtree(part, ignore_errors=True)
    tags = _geotags(survey, origin_latlon)
    for k, name in enumerate(names):
        os.symlink(os.path.join(done, name), survey.paths[k])
        _sidecar(survey, tags, k)
    return survey
