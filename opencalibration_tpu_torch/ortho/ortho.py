"""Orthomosaic generation: thumbnail mosaic, DSM, full-resolution layered
rendering, color balance, blending, textured OBJ export (twin of
opencalibration_tpu/ortho/ortho.py).

Re-design of reference src/ortho/ortho.cpp for a batch device:

* the per-pixel triangle-walk ray trace (ortho.cpp:560-580) becomes a
  batched barycentric mesh-z interpolation over whole pixel grids (numpy,
  on the host);
* per-pixel 5-NN camera projection + sampling (:1206-1429) becomes one
  batched project / gather over [K, tile pixels] per tile, with the per-tile
  candidate camera set chosen on the host;
* the two GeoTIFF passes (layers then blend, :1431-2050) keep the
  reference's structure (cache-aware tile order, full-resolution LRU image
  cache with prefetch, Lab color correspondences at layer overlaps,
  color-balance solve, pull-push fill + Laplacian blending) with the pixel
  math on the device and GDAL replaced by io.geotiff.

The ``_*_kernel`` functions are plain torch programs (their names are the
JAX package's). Every entry point takes ``device="cuda"`` and runs there
unless the caller asks for ``"cpu"``. Colour conversion, area resize and PNG
writing are the port's own (ops/color.py, io/png.py), so nothing here needs
OpenCV.

Coordinate convention: world x = east, y = north; raster row 0 = max_y.
"""

from __future__ import annotations

import base64
import collections
import concurrent.futures
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from opencalibration_tpu_torch.io.geotiff import GeoTiffTileWriter, write_geotiff
from opencalibration_tpu_torch.io.jpeg import encode_jpeg
from opencalibration_tpu_torch.io.png import encode_png
from opencalibration_tpu_torch.ops.color import bgr_to_lab_u8, lab_u8_to_bgr, resize_area
from opencalibration_tpu_torch.ops.distort import _per_point, image_from_3d, image_to_3d
from opencalibration_tpu_torch.ops.quaternion import quat_rotate, quat_rotate_inverse
from opencalibration_tpu_torch.ortho.blending import (
    compute_blend_weight,
    laplacian_blend,
    pull_push_fill,
)
from opencalibration_tpu_torch.ortho.color_balance import (
    ColorCorrespondence,
    solve_color_balance,
)
from opencalibration_tpu_torch.ortho.image_cache import FullResolutionImageCache
from opencalibration_tpu_torch.ortho.tile_ordering import compute_cache_aware_tile_order
from opencalibration_tpu_torch.types.camera import CameraModel, stack_cameras, take_camera
from opencalibration_tpu_torch.types.graph import MeasurementGraph, SurfaceModel
from opencalibration_tpu_torch.utils.device import resolve_device
from opencalibration_tpu_torch.utils.performance import PerformanceMeasure

MAX_CAMERAS_PER_PIXEL = 5  # reference ortho.cpp closest5
DEFAULT_TILE = 256
CORR_STRIDE = 97  # every 97th overlap pixel feeds color balance
DEVICE_CACHE_MB = 1024.0  # byte budget of the device-resident image cache


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class OrthoBounds:
    min_x: float
    max_x: float
    min_y: float
    max_y: float
    mean_surface_z: float


@dataclasses.dataclass
class OrthoContext:
    bounds: OrthoBounds
    gsd: float
    involved_nodes: List[int]
    mean_camera_z: float
    average_camera_elevation: float
    mesh: object  # TriMesh


@dataclasses.dataclass
class OrthoMosaic:
    """reference ortho.hpp OrthoMosaic."""

    rgba: np.ndarray  # [H, W, 4] uint8
    dsm: np.ndarray  # [H, W] float32
    overlap: np.ndarray  # [H, W] uint16
    camera_index: np.ndarray  # [H, W] int64 node id or -1
    gsd: float = 0.0
    origin_xy: Tuple[float, float] = (0.0, 0.0)


def calculate_bounds(surfaces: Sequence[SurfaceModel]) -> Optional[OrthoBounds]:
    """reference ortho.cpp:283-342."""
    xs, ys, zs = [], [], []
    for s in surfaces:
        if s.mesh is not None and s.mesh.num_vertices > 0:
            v = s.mesh.vertices
            xs += [v[:, 0].min(), v[:, 0].max()]
            ys += [v[:, 1].min(), v[:, 1].max()]
            zs += list(v[np.isfinite(v[:, 2]), 2])
        elif s.cloud:
            pts = np.concatenate(s.cloud)
            xs += [pts[:, 0].min(), pts[:, 0].max()]
            ys += [pts[:, 1].min(), pts[:, 1].max()]
            zs += list(pts[:, 2])
    if not xs:
        return None
    return OrthoBounds(
        min(xs), max(xs), min(ys), max(ys),
        float(np.mean(zs)) if zs else 0.0,
    )


def calculate_gsd(
    graph: MeasurementGraph,
    model_store: Dict[int, CameraModel],
    involved_nodes: Sequence[int],
    mean_surface_z: float,
    thumbnail: bool,
) -> float:
    """reference ortho.cpp:344-377: angular resolution of the central
    pixel x average height above ground. Runs on the host models, in
    float64."""
    arc = 0.0
    mean_z = 0.0
    count = 0
    h = 1e-3
    for nid in involved_nodes:
        node = graph.get_node(nid)
        model = model_store[node.payload.model_id].astype(torch.float64)
        rays = torch.tensor([[0.0, 0.0, 1.0], [h, 0.0, 1.0]], dtype=torch.float64,
                            device=model.focal_length_pixels.device)
        p = image_from_3d(rays, model).cpu().numpy()
        arc_pixel = h / max(np.linalg.norm(p[0] - p[1]), 1e-12)
        if thumbnail and node.payload.thumbnail is not None:
            tscale = node.payload.thumbnail.shape[0] / max(float(model.pixels_rows), 1.0)
            arc_pixel /= tscale
        arc = (arc * count + arc_pixel) / (count + 1)
        mean_z = (mean_z * count + node.payload.position[2]) / (count + 1)
        count += 1
    elevation = mean_z - mean_surface_z
    return max(abs(elevation * arc), 0.001)


def prepare_context(surfaces, graph, model_store, thumbnail: bool) -> Optional[OrthoContext]:
    bounds = calculate_bounds(surfaces)
    if bounds is None:
        return None
    involved = [
        nid
        for nid, node in sorted(graph.nodes())
        if np.isfinite(np.asarray(node.payload.orientation)).all()
        and np.isfinite(np.asarray(node.payload.position)).all()
    ]
    if not involved:
        return None
    gsd = calculate_gsd(graph, model_store, involved, bounds.mean_surface_z, thumbnail)
    mean_cam_z = float(np.mean([graph.get_node(n).payload.position[2] for n in involved]))
    mesh = None
    for s in surfaces:
        if s.mesh is not None and s.mesh.num_vertices > 0:
            mesh = s.mesh
            break
    if mesh is None:
        return None
    return OrthoContext(
        bounds=bounds, gsd=gsd, involved_nodes=involved,
        mean_camera_z=mean_cam_z,
        average_camera_elevation=mean_cam_z - bounds.mean_surface_z,
        mesh=mesh,
    )


def _clamp_resolution(width, height, max_megapixels: float):
    if max_megapixels and max_megapixels > 0:
        mp = width * height / 1e6
        if mp > max_megapixels:
            scale = math.sqrt(max_megapixels / mp)
            return max(1, int(width * scale)), max(1, int(height * scale)), 1.0 / scale
    return width, height, 1.0


def _raster_grid(b: OrthoBounds, gsd: float, x0: int, y0: int, width: int, height: int):
    """World xy [height * width, 2] of the raster pixels from (x0, y0) on."""
    xs = b.min_x + gsd * (x0 + np.arange(width))
    ys = b.max_y - gsd * (y0 + np.arange(height))
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


def _bilinear(img, ipx):
    """[K, H, W, C] images, [K, P, 2] positions -> [K, P, C] float32 bilinear
    samples, each camera from its own image. The texels are read in the
    images' own type and lifted to float16 before they are weighted, which
    gives the values of a float16 image stack without building one."""
    K, H, W, _ = img.shape
    x0 = torch.clamp(torch.floor(ipx[..., 0]).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(ipx[..., 1]).to(torch.int64), 0, H - 2)
    fx = torch.clamp(ipx[..., 0] - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(ipx[..., 1] - y0, 0.0, 1.0)[..., None]
    k = torch.arange(K, device=img.device)[:, None]

    def texel(y, x):
        return img[k, y, x].to(torch.float16)

    c00 = texel(y0, x0)
    c01 = texel(y0, x0 + 1)
    c10 = texel(y0 + 1, x0)
    c11 = texel(y0 + 1, x0 + 1)
    return (
        c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy + c11 * fx * fy
    )


def _sample_cameras_kernel(
    points,  # [P, 3] world sample points
    cam_quats,  # [K, 4]
    cam_pos,  # [K, 3]
    models,  # batched CameraModel [K]
    images,  # [K, Hmax, Wmax, C] uint8 (or float16) Lab
    img_hw,  # [K, 2] actual sizes
    img_scale,  # [K] image px per model px (thumbnail scale)
    cam_valid,  # [K]
    avg_elevation,
    gsd,  # output ground sample distance (world units per output pixel)
    taps: int = 1,
):
    """Project P points into K cameras; sample colors + weights + geometry.

    With taps > 1, each output pixel's world footprint (gsd x gsd) is
    supersampled with a taps x taps grid mapped through the local
    world->pixel projection Jacobian, the fixed-cost equivalent of the
    reference's adaptive Jacobian-ellipse PatchSampler (reference
    ortho.cpp:69-222, jacobian :81-115): when the footprint spans many source
    pixels the taps spread anisotropically across them, when it is subpixel
    they collapse onto the bilinear neighborhood. The Jacobian is taken in
    forward mode, one derivative along world x and one along world y.

    Returns colors [K, P, C], weights [K, P] (0 where invalid), and
    geom [K, P, 4] = (normalized_radius, view_angle, normalized_x,
    normalized_y) per sample, the radiometric coordinates the color-balance
    model is parameterized in (reference ortho.cpp:1324-1418 +
    radiometric_cost.hpp:21-200). 8-bit Lab is the working convention
    throughout, sampled in float16."""
    pmodels = _per_point(models)
    q = cam_quats[:, None, :]
    t = cam_pos[:, None, :]

    def project(pts):  # [K, P, 3] world -> ([K, P, 3] camera rays, [K, P, 2] model px)
        rays = quat_rotate_inverse(q, pts - t)
        return rays, image_from_3d(rays, pmodels)

    K = cam_quats.shape[0]
    pts = points[None].repeat(K, 1, 1)  # a dual number needs its own memory
    rays, px = project(pts)
    in_front = rays[..., 2] > 0
    scale = img_scale[:, None, None]
    ipx = px * scale
    h = img_hw[:, 0:1].to(px.dtype)
    w = img_hw[:, 1:2].to(px.dtype)
    inside = (ipx[..., 0] > 0) & (ipx[..., 0] < w - 1) & (ipx[..., 1] > 0) & (ipx[..., 1] < h - 1)
    if taps <= 1:
        color = _bilinear(images, ipx)
    else:
        def proj_px(p):
            return project(p)[1]

        ex = torch.zeros_like(pts)
        ex[..., 0] = 1.0
        ey = torch.zeros_like(pts)
        ey[..., 1] = 1.0
        _, jx = torch.func.jvp(proj_px, (pts,), (ex,))  # d(model px)/d(world x) [K, P, 2]
        _, jy = torch.func.jvp(proj_px, (pts,), (ey,))
        u = (torch.arange(taps, dtype=points.dtype, device=points.device) + 0.5) / taps - 0.5
        color = None
        for v_off in u:  # rows of the tap grid: world y offsets
            for u_off in u:
                tap_px = px + (jx * (u_off * gsd) + jy * (v_off * gsd))
                c = _bilinear(images, tap_px * scale)
                color = c if color is None else color + c
        color = color / float(taps * taps)
    horiz = torch.linalg.vector_norm(points[None, :, :2] - t[..., :2], dim=-1)
    wgt = compute_blend_weight(
        ipx[..., 0], ipx[..., 1], w, h, horiz / torch.clamp_min(avg_elevation, 1e-6)
    )
    wgt = torch.where(in_front & inside & cam_valid[:, None], wgt, 0.0)
    pr = px - models.principal_point[:, None, :]
    half_diag = 0.5 * torch.sqrt(models.pixels_cols ** 2 + models.pixels_rows ** 2)
    radius = torch.linalg.vector_norm(pr, dim=-1) / torch.clamp_min(half_diag, 1e-6)[:, None]
    angle = torch.atan2(torch.linalg.vector_norm(rays[..., :2], dim=-1), rays[..., 2])
    nx = pr[..., 0] / torch.clamp_min(models.pixels_cols, 1.0)[:, None]
    ny = pr[..., 1] / torch.clamp_min(models.pixels_rows, 1.0)[:, None]
    geom = torch.stack([radius, angle, nx, ny], dim=-1)
    return color, wgt, geom


def _sample_select_kernel(
    points, cam_quats, cam_pos, models, images, img_hw, img_scale,
    cam_valid, avg_elevation, gsd, taps: int = 1, kmax: int = 5,
):
    """Sample + per-pixel top-kmax layer selection on the device.

    ``images`` is the [K, Hmax, Wmax, C] stack assembled from the
    device-resident image cache: the pixels never leave the device between
    upload and sampling, and only the selected kmax layers (float16) are
    kept, so per-tile traffic is O(kmax * tile_pixels) instead of
    O(K * image_pixels). The top-k matches the reference's per-pixel
    closest-5 selection (reference ortho.cpp:1206-1300). Equal weights keep
    the order of their candidate slots (a stable descending sort): padded
    slots all weigh 0, so ties are the rule at tile edges, and the first
    selected camera is written to the camera-id raster."""
    colors, weights, geom = _sample_cameras_kernel(
        points, cam_quats, cam_pos, models, images, img_hw, img_scale,
        cam_valid, avg_elevation, gsd, taps=taps,
    )
    w_sorted, order = torch.sort(weights, dim=0, descending=True, stable=True)
    sel = order[:kmax]  # [kmax, P]
    lcolors = torch.gather(colors, 0, sel[..., None].expand(-1, -1, colors.shape[-1]))
    lgeom = torch.gather(geom, 0, sel[..., None].expand(-1, -1, geom.shape[-1]))
    return (
        lcolors.to(torch.float16),
        w_sorted[:kmax].to(torch.float16),
        lgeom.to(torch.float16),
        # uint8 quarters the selection map's share of a pull (guarded:
        # huge-survey tiles can exceed 255 candidates)
        sel.to(torch.uint8) if weights.shape[0] <= 255 else sel.to(torch.int32),
    )


def _correct_blend_kernel(colors, weights, geom, cam, off, brdf, slope, vig, transition, ts, levels):
    """BLEND_LAYERS device chain: radiometric correction (offsets +
    vignetting + BRDF + slope, reference ortho.cpp:1839-1875) -> sigmoid
    transition weights -> pull-push hole fill -> Laplacian blend. ``cam`` is
    the int64 node-list index of every sample."""
    colors = colors.to(torch.float32)
    raw = weights.to(torch.float32)
    geom = geom.to(torch.float32)
    r2 = geom[..., 0] ** 2
    theta = geom[..., 1]
    colors = colors - off[cam]
    v = vig[cam]
    corr = (
        v[..., 0] * r2 + v[..., 1] * r2 ** 2 + v[..., 2] * r2 ** 3
        + brdf[cam] * theta * theta
        + slope[cam][..., 0] * geom[..., 2]
        + slope[cam][..., 1] * geom[..., 3]
    )
    colors = torch.cat([colors[..., :1] - corr[..., None], colors[..., 1:]], dim=-1)
    trans = torch.sigmoid((raw - raw[0:1]) / torch.clamp_min(transition, 1e-6) * 6.0)
    w = raw * trans
    K = colors.shape[0]
    colors = colors.reshape(K, ts, ts, 3)
    w4 = w.reshape(K, ts, ts, 1)
    filled = pull_push_fill(colors, w4)
    blended = laplacian_blend(filled, w4, levels=levels)
    alpha = raw.reshape(K, ts, ts).max(dim=0).values > 0
    # the cast truncates, as the reference's does
    return torch.clamp(blended, 0, 255).to(torch.uint8), alpha


def _corr_sample_kernel(lcolors, lweights, lgeom, sel, cam_ids, valid_z, stride: int, s_max: int):
    """Device-side strided color-correspondence sampling.

    Picks every ``stride``-th pixel, in raster order, where the two
    strongest layers overlap (reference ortho.cpp:1324-1418) and scatters
    each sample's (camera pair, Lab pair, radiometric geometry pair) into a
    fixed ``s_max``-slot output, so the layer pass pulls a few KB per tile
    instead of the whole layer stack. Each taken pixel owns its slot; all
    others target one overflow slot, which is cut off, so the scatter's
    order among duplicates never shows."""
    w = lweights.to(torch.float32) * valid_z[None].to(torch.float32)
    both = (w[0] > 0) & (w[1] > 0)  # [P]
    cnt = torch.cumsum(both.to(torch.int64), dim=0)
    take = both & (((cnt - 1) % stride) == 0)
    slot = torch.where(take, torch.clamp_max(torch.div(cnt - 1, stride, rounding_mode="floor"), s_max), s_max)
    cam = cam_ids[sel.to(torch.int64)]  # [kmax, P] node-list indices

    def gather(x):
        out = torch.zeros((s_max + 1,) + x.shape[1:], dtype=x.dtype, device=x.device)
        out[slot] = x
        return out[:s_max]

    lab = lcolors.to(torch.float32)
    geo = lgeom.to(torch.float32)
    return dict(
        cam_a=gather(cam[0]), cam_b=gather(cam[1]),
        lab_a=gather(lab[0]), lab_b=gather(lab[1]),
        geom_a=gather(geo[0]), geom_b=gather(geo[1]),
        valid=gather(take),
    )


def _render_blend_kernel(
    lcolors, lweights, lgeom, sel, cam_ids, valid_z,
    off, brdf, slope, vig, transition, ts: int, levels: int,
):
    """Adapter from a freshly rendered layer stack (still on the device) to
    the correction + transition + fill + blend chain: maps selection slots to
    node-list camera indices and applies the mesh-validity mask, so
    BLEND_LAYERS needs no host-side layer store. Also returns the strongest
    layer's camera index per pixel for the camera-id raster."""
    cam = cam_ids[sel.to(torch.int64)]
    w = lweights * valid_z[None].to(lweights.dtype)
    lab8, alpha = _correct_blend_kernel(
        lcolors, w, lgeom, cam, off, brdf, slope, vig, transition, ts=ts, levels=levels,
    )
    return lab8, alpha, cam[0]


def _corner_world_rays(corner_px, quats, models):
    """[N, 4, 2] image-corner pixels -> [N, 4, 3] world ray directions."""
    return quat_rotate(quats[:, None, :], image_to_3d(corner_px, _per_point(models)))


def camera_ground_footprints(quats, poss, models_list, ground_z: float, max_reach_factor: float = 4.0):
    """Each camera's ground-footprint bounding box [N, 4] =
    (min_x, max_x, min_y, max_y): the image corners projected onto the
    z = ground_z plane, reach clamped to max_reach_factor x elevation for
    grazing rays, camera nadir always included (the geometric version of
    the reference's findTileCameras tile/camera assignment,
    reference ortho.cpp:1104-1160). Runs on the host models, in float32."""
    N = len(models_list)
    corner_px = np.zeros((N, 4, 2), np.float32)
    for i, m in enumerate(models_list):
        w = float(m.pixels_cols)
        h = float(m.pixels_rows)
        corner_px[i] = [[0, 0], [w, 0], [0, h], [w, h]]
    rays = _corner_world_rays(
        torch.from_numpy(corner_px),
        torch.from_numpy(np.asarray(quats, np.float32)),
        stack_cameras([m.astype(torch.float32).map(lambda x: x.cpu()) for m in models_list]),
    ).numpy()  # [N, 4, 3]
    out = np.zeros((N, 4))
    for i in range(N):
        t = np.asarray(poss[i], np.float64)
        elev = max(t[2] - ground_z, 1.0)
        reach = max_reach_factor * elev
        pts = [t[:2]]
        for r in rays[i]:
            rz = r[2]
            if not np.isfinite(r).all():
                continue
            if rz < -1e-6:
                s = min((ground_z - t[2]) / rz, reach / max(np.linalg.norm(r), 1e-9))
            else:
                # horizontal/up ray: clamp to max reach along its xy heading
                s = reach / max(np.linalg.norm(r[:2]), 1e-9)
            pts.append(t[:2] + s * r[:2])
        pts = np.stack(pts)
        out[i] = [pts[:, 0].min(), pts[:, 0].max(), pts[:, 1].min(), pts[:, 1].max()]
    return out


def _sample_knn_kernel(
    points,  # [P, 3] world sample points
    knn,  # [P, K] per-pixel candidate camera indices (into the stacks), int64
    cam_quats,  # [N, 4]
    cam_pos,  # [N, 3]
    models,  # batched CameraModel [N]
    images,  # [N, Hmax, Wmax, C]
    img_hw,  # [N, 2]
    img_scale,  # [N]
    avg_elevation,
):
    """Gather-then-sample: each pixel projects into only its K candidate
    cameras (batched gathers of pose / model / texels over [P, K]), so memory
    and compute are O(P * K), independent of the camera count N; the
    reference is per-pixel best-of-5-NN too (reference ortho.cpp:474-653).
    Returns colors [P, K, C], weights [P, K] (0 where the candidate does not
    see the pixel)."""
    q = cam_quats[knn]  # [P, K, 4]
    t = cam_pos[knn]
    model = take_camera(models, knn)
    ray = quat_rotate_inverse(q, points[:, None, :] - t)
    px = image_from_3d(ray, model)
    ipx = px * img_scale[knn][..., None]
    h = img_hw[knn][..., 0].to(px.dtype)
    w = img_hw[knn][..., 1].to(px.dtype)
    ok = (
        (ray[..., 2] > 0)
        & torch.isfinite(ipx).all(dim=-1)
        & (ipx[..., 0] > 0) & (ipx[..., 0] < w - 1)
        & (ipx[..., 1] > 0) & (ipx[..., 1] < h - 1)
    )
    sx = torch.where(ok, ipx[..., 0], 0.0)
    sy = torch.where(ok, ipx[..., 1], 0.0)
    x0 = torch.clamp(torch.floor(sx).to(torch.int64), 0, images.shape[2] - 2)
    y0 = torch.clamp(torch.floor(sy).to(torch.int64), 0, images.shape[1] - 2)
    fx = torch.clamp(sx - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(sy - y0, 0.0, 1.0)[..., None]
    c00 = images[knn, y0, x0]
    c01 = images[knn, y0, x0 + 1]
    c10 = images[knn, y0 + 1, x0]
    c11 = images[knn, y0 + 1, x0 + 1]
    color = (
        c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy + c11 * fx * fy
    )
    horiz = torch.linalg.vector_norm(points[:, None, :2] - t[..., :2], dim=-1)
    wgt = compute_blend_weight(sx, sy, w, h, horiz / torch.clamp_min(avg_elevation, 1e-6))
    return color, torch.where(ok, wgt, 0.0)


_KNN_PIXEL_CHUNK = 1 << 18  # pixels per device dispatch (bounds memory)


def _sample_knn_chunked(points, knn, cam_quats, cam_pos, models, thumbs, thumb_hw, scales,
                        avg_elevation, device):
    """Host loop over pixel chunks; returns numpy colors [P, K, 3] and
    weights [P, K]."""
    P, K = knn.shape
    colors = np.zeros((P, K, 3), np.float32)
    weights = np.zeros((P, K), np.float32)

    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    quats_d, pos_d = dev(cam_quats, torch.float32), dev(cam_pos, torch.float32)
    thumbs_d, hw_d = dev(thumbs, torch.float32), dev(thumb_hw, torch.int32)
    scales_d, elev_d = dev(scales, torch.float32), dev(avg_elevation, torch.float32)
    for s0 in range(0, P, _KNN_PIXEL_CHUNK):
        s1 = min(s0 + _KNN_PIXEL_CHUNK, P)
        c, w = _sample_knn_kernel(
            dev(points[s0:s1], torch.float32), dev(knn[s0:s1], torch.int64),
            quats_d, pos_d, models, thumbs_d, hw_d, scales_d, elev_d,
        )
        colors[s0:s1] = c.cpu().numpy()
        weights[s0:s1] = w.cpu().numpy()
    return colors, weights


def _stack_thumbnails(graph, nodes):
    """Pad thumbnails to a common size; Lab uint8 -> float32."""
    thumbs = []
    hw = []
    for nid in nodes:
        t = graph.get_node(nid).payload.thumbnail
        if t is None:
            t = np.zeros((2, 2, 3), np.uint8)
        thumbs.append(t.astype(np.float32))
        hw.append(t.shape[:2])
    H = max(t.shape[0] for t in thumbs)
    W = max(t.shape[1] for t in thumbs)
    out = np.zeros((len(thumbs), H, W, 3), np.float32)
    for i, t in enumerate(thumbs):
        out[i, : t.shape[0], : t.shape[1]] = t
    return out, np.asarray(hw, np.int32)


def _device_models(graph, model_store, nodes, device) -> CameraModel:
    """The nodes' camera models stacked as one float32 model on ``device``."""
    return stack_cameras([
        model_store[graph.get_node(n).payload.model_id].astype(torch.float32) for n in nodes
    ]).map(lambda x: x.to(device))


def generate_orthomosaic(surfaces, graph, model_store, max_megapixels: float = 4.0, *,
                         device="cuda") -> Optional[OrthoMosaic]:
    """Thumbnail orthomosaic (reference generateOrthomosaic,
    ortho.cpp:474-653): best-weight thumbnail pixel per output pixel,
    plus DSM / overlap / camera-index rasters."""
    device = resolve_device(device)
    ctx = prepare_context(surfaces, graph, model_store, thumbnail=True)
    if ctx is None:
        return None
    b = ctx.bounds
    width = max(int((b.max_x - b.min_x) / ctx.gsd), 1)
    height = max(int((b.max_y - b.min_y) / ctx.gsd), 1)
    width, height, gsd_scale = _clamp_resolution(width, height, max_megapixels)
    gsd = ctx.gsd * gsd_scale

    flat_xy = _raster_grid(b, gsd, 0, 0, width, height)
    z = ctx.mesh.interpolate_z(flat_xy)  # [P]
    valid_z = np.isfinite(z)
    points = np.concatenate([flat_xy, np.where(valid_z, z, 0.0)[:, None]], axis=1)

    nodes = ctx.involved_nodes
    import scipy.spatial

    cam_xy = np.stack([np.asarray(graph.get_node(n).payload.position[:2]) for n in nodes])
    tree = scipy.spatial.cKDTree(cam_xy)
    K = min(MAX_CAMERAS_PER_PIXEL, len(nodes))
    _, knn = tree.query(flat_xy, k=K)
    knn = np.atleast_2d(knn.T).T.reshape(len(flat_xy), K)

    thumbs, thumb_hw = _stack_thumbnails(graph, nodes)
    scales = np.asarray(
        [
            thumb_hw[i][0] / max(float(model_store[graph.get_node(n).payload.model_id].pixels_rows), 1.0)
            for i, n in enumerate(nodes)
        ],
        np.float32,
    )
    quats = np.stack([np.asarray(graph.get_node(n).payload.orientation) for n in nodes])
    poss = np.stack([np.asarray(graph.get_node(n).payload.position) for n in nodes])
    models = _device_models(graph, model_store, nodes, device)

    # per-pixel 5-NN gather-then-sample: cost O(P*K), never O(P*N)
    colors, knn_w = _sample_knn_chunked(
        points.astype(np.float32), knn, quats, poss, models, thumbs, thumb_hw, scales,
        ctx.average_camera_elevation, device,
    )  # [P, K, 3], [P, K]

    P = len(flat_xy)
    overlap = (knn_w > 0).sum(axis=1).astype(np.uint16)
    best_k = np.argmax(knn_w, axis=1)
    best_cam = knn[np.arange(P), best_k]
    best_w = knn_w[np.arange(P), best_k]
    got = (best_w > 0) & valid_z

    rgba = np.zeros((P, 4), np.uint8)
    lab = colors[np.arange(P), best_k]  # [P, 3] Lab
    rgba[:, :3] = lab_u8_to_bgr(np.clip(lab, 0, 255).astype(np.uint8))
    rgba[:, 3] = np.where(got, 255, 0)
    # background checkerboard (reference ortho.cpp:620-626)
    rows = np.arange(P) // width
    cols = np.arange(P) % width
    grey = np.where((rows + cols) % 2 == 0, 64, 128).astype(np.uint8)
    for c in range(3):
        rgba[:, c] = np.where(got, rgba[:, c], grey)

    cam_ids = np.asarray(nodes)[best_cam]
    camera_index = np.where(got, cam_ids, -1)

    return OrthoMosaic(
        rgba=rgba.reshape(height, width, 4),
        dsm=np.where(valid_z, z, np.nan).reshape(height, width).astype(np.float32),
        overlap=overlap.reshape(height, width),
        camera_index=camera_index.reshape(height, width),
        gsd=gsd,
        origin_xy=(b.min_x, b.max_y),
    )


def _wkt_of(geocoord):
    return geocoord.get_wkt() if geocoord is not None and geocoord.is_initialized() else None


def generate_dsm_geotiff(
    path: str, surfaces, graph, model_store, geocoord=None,
    max_megapixels: float = 16.0, *, device="cuda",
) -> bool:
    """Float32 DSM GeoTIFF (reference generateDSMGeoTIFF, ortho.cpp:745-963).
    The raster is interpolated from the mesh on the host; ``device`` is
    resolved like every entry point's and holds nothing."""
    resolve_device(device)
    ctx = prepare_context(surfaces, graph, model_store, thumbnail=False)
    if ctx is None:
        return False
    b = ctx.bounds
    width = max(int((b.max_x - b.min_x) / ctx.gsd), 1)
    height = max(int((b.max_y - b.min_y) / ctx.gsd), 1)
    width, height, gsd_scale = _clamp_resolution(width, height, max_megapixels)
    gsd = ctx.gsd * gsd_scale
    z = ctx.mesh.interpolate_z(_raster_grid(b, gsd, 0, 0, width, height))
    dsm = z.reshape(height, width).astype(np.float32)
    nodata = -32767.0
    dsm = np.where(np.isfinite(dsm), dsm, nodata)
    write_geotiff(path, dsm, (b.min_x, b.max_y), (gsd, gsd), wkt=_wkt_of(geocoord), nodata=nodata, overviews=3)
    return True


class OrthoJob:
    """Full-resolution orthomosaic render job, split into the pipeline's
    GENERATE_LAYERS / COLOR_BALANCE / BLEND_LAYERS phases
    (reference generateLayeredGeoTIFF + solveColorBalance +
    blendLayeredGeoTIFF, ortho.cpp:966-2050).

    GENERATE_LAYERS renders each tile: per-pixel top-5 cameras chosen by
    blend weight from the full tile candidate set (reference picks the
    per-pixel closest-5 from the tile candidates, ortho.cpp:1206-1300),
    with anisotropic footprint sampling and real per-sample radiometric
    geometry. Where the reference materializes the layer stacks as a
    layered GeoTIFF on disk (ortho.cpp:966-1460) and re-reads them to
    blend, this build recomputes them: pass 1 pulls only the strided
    color-balance correspondence samples, and BLEND_LAYERS re-renders each
    tile on the device, feeding the layers straight into the correction +
    transition + fill + Laplacian-blend chain. No layer store means
    per-tile memory at any survey size. The blended tiles stream straight
    into a tiled GeoTIFF (plus an optional uint64 camera-id sidecar raster).

    ``device_cache_mb`` is the byte budget of the device-resident image
    cache where the image size is not known from the camera models.

    Usage: job = OrthoJob(...); job.pass_layers(); job.solve_balance();
    job.pass_blend(path), or generate_ortho_geotiff() for all at once.
    """

    def __init__(
        self,
        surfaces,
        graph,
        model_store,
        geocoord=None,
        max_megapixels: float = 64.0,
        tile_size: int = DEFAULT_TILE,
        cache_images: int = 16,
        blend_levels: int = 4,
        taps: int = 3,
        blend_transition: float = 0.05,
        device_cache_mb: float = DEVICE_CACHE_MB,
        *,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.ok = False
        self.correspondences: List[ColorCorrespondence] = []
        self.balance = None
        # optional per-tile progress hook: called with dict(tile_x, tile_y,
        # num_tiles_x, num_tiles_y, fraction_done, png_base64) during the
        # blend pass (reference TileUpdate, progress.hpp:15-34)
        self.tile_callback = None
        self.taps = taps
        self.blend_transition = blend_transition
        self.device_cache_mb = device_cache_mb
        self.device_uploads = 0
        self._setup(surfaces, graph, model_store, geocoord, max_megapixels,
                    tile_size, cache_images, blend_levels)

    def _setup(self, surfaces, graph, model_store, geocoord, max_megapixels,
               tile_size, cache_images, blend_levels):
        self.graph = graph
        self.model_store = model_store
        self.geocoord = geocoord
        self.blend_levels = blend_levels
        self.tile_size = tile_size
        ctx = prepare_context(surfaces, graph, model_store, thumbnail=False)
        if ctx is None:
            return
        self._ctx = ctx
        b = ctx.bounds
        width = max(int((b.max_x - b.min_x) / ctx.gsd), 1)
        height = max(int((b.max_y - b.min_y) / ctx.gsd), 1)
        width, height, gsd_scale = _clamp_resolution(width, height, max_megapixels)
        gsd = ctx.gsd * gsd_scale

        nodes = ctx.involved_nodes
        import scipy.spatial

        cam_xy = np.stack([np.asarray(graph.get_node(n).payload.position[:2]) for n in nodes])
        tree = scipy.spatial.cKDTree(cam_xy)

        tiles_x = (width + tile_size - 1) // tile_size
        tiles_y = (height + tile_size - 1) // tile_size

        # per-tile candidate cameras selected by GEOMETRY: a camera joins a
        # tile when its projected ground footprint intersects the tile
        # rectangle (findTileCameras, reference ortho.cpp:1104-1160); a
        # center-distance query would drop a camera that only clips a tile
        # corner when tile extent ~ camera spacing. The per-pixel kernel
        # still keeps only the top-MAX_CAMERAS_PER_PIXEL by weight.
        quats_all = np.stack([np.asarray(graph.get_node(n).payload.orientation) for n in nodes])
        poss_all = np.stack([np.asarray(graph.get_node(n).payload.position) for n in nodes])
        fp = camera_ground_footprints(
            quats_all, poss_all,
            [model_store[graph.get_node(n).payload.model_id] for n in nodes],
            b.mean_surface_z,
        )  # [N, 4] min_x, max_x, min_y, max_y
        k_base = min(MAX_CAMERAS_PER_PIXEL + 3, len(nodes))
        tile_cams: Dict[int, set] = {}
        margin = gsd
        for ty in range(tiles_y):
            ty_max = b.max_y - gsd * ty * tile_size + margin
            ty_min = b.max_y - gsd * (ty + 1) * tile_size - margin
            for tx in range(tiles_x):
                tx_min = b.min_x + gsd * tx * tile_size - margin
                tx_max = b.min_x + gsd * (tx + 1) * tile_size + margin
                hit = np.flatnonzero(
                    (fp[:, 0] <= tx_max) & (fp[:, 1] >= tx_min)
                    & (fp[:, 2] <= ty_max) & (fp[:, 3] >= ty_min)
                )
                sel = {int(i) for i in hit}
                if len(sel) < k_base:
                    # sparse coverage fallback: nearest cameras by center
                    cx = 0.5 * (tx_min + tx_max)
                    cy = 0.5 * (ty_min + ty_max)
                    _, nn = tree.query([cx, cy], k=k_base)
                    sel |= {int(i) for i in np.atleast_1d(nn)}
                tile_cams[ty * tiles_x + tx] = sel

        # fixed kernel width: bucket the largest per-tile candidate count
        # so every tile has one shape (padded slots carry weight 0)
        kc_needed = max(len(s) for s in tile_cams.values())
        self._kc = min(len(nodes), _next_pow2(max(kc_needed, k_base)))
        # keep each tile's strongest kc candidates (closest footprint
        # centers) when a tile sees more cameras than the kernel width
        if kc_needed > self._kc:
            fp_cx = 0.5 * (fp[:, 0] + fp[:, 1])
            fp_cy = 0.5 * (fp[:, 2] + fp[:, 3])
            for idx, sel in tile_cams.items():
                if len(sel) <= self._kc:
                    continue
                ty, tx = divmod(idx, tiles_x)
                cx = b.min_x + gsd * (tx + 0.5) * tile_size
                cy = b.max_y - gsd * (ty + 0.5) * tile_size
                arr = np.asarray(sorted(sel))
                d = np.hypot(fp_cx[arr] - cx, fp_cy[arr] - cy)
                tile_cams[idx] = {int(i) for i in arr[np.argsort(d)[: self._kc]]}
        self._tile_cams = tile_cams
        self._order = compute_cache_aware_tile_order(tile_cams, tiles_x, tiles_y, cache_images)
        self._cache = FullResolutionImageCache(max_images=max(cache_images, self._kc))
        # device-resident image cache: each full-resolution Lab image is
        # uploaded once as uint8 and stacked on the device per tile; without
        # it every tile would re-ship its whole candidate stack
        self._dev_cache = collections.OrderedDict()  # cam idx -> (tensor, (h, w))
        self._dev_cache_max = max(2 * self._kc, cache_images, 8)
        hm = wm = 0
        for n in nodes:
            m = model_store.get(graph.get_node(n).payload.model_id)
            if m is not None:
                hm = max(hm, int(m.pixels_rows))
                wm = max(wm, int(m.pixels_cols))
        self._img_hm, self._img_wm = hm, wm
        self._quats_all = quats_all
        self._poss_all = poss_all
        self._nodes = nodes
        self._bounds = b
        self._gsd = gsd
        self._width = width
        self._height = height
        self._tiles_x = tiles_x
        self._tiles_y = tiles_y
        self.ok = True

    # -- pass 1: project + layer selection --------------------------------

    def _load_lab_u8(self, idx):
        node = self.graph.get_node(self._nodes[idx])
        img = self._cache.get(node.payload.path)
        if img is None:
            return None
        # 8-bit Lab is the working convention end to end, so uint8 on the
        # device is value-exact at half the float16 footprint
        return bgr_to_lab_u8(img)

    def _device_image(self, idx):
        """Device-resident uint8 Lab image, padded to the job-global
        (Hmax, Wmax); returns (tensor, (h, w)) or None. LRU-bounded: dense
        surveys assign dozens of candidate cameras per tile, and a small
        cache would re-upload nearly every image for every tile."""
        ent = self._dev_cache.get(idx)
        if ent is not None:
            self._dev_cache.move_to_end(idx)
            return ent
        lab = self._load_lab_u8(idx)
        if lab is None:
            return None
        h, w = lab.shape[:2]
        if self._img_hm <= 0 or self._img_wm <= 0:
            self._img_hm, self._img_wm = h, w
            per_img = self._img_hm * self._img_wm * 3
            self._dev_cache_max = max(
                self._dev_cache_max, int(self.device_cache_mb * 1e6 // max(per_img, 1))
            )
        hm, wm = self._img_hm, self._img_wm
        buf = np.zeros((hm, wm, 3), np.uint8)
        buf[: min(h, hm), : min(w, wm)] = lab[:hm, :wm]
        ent = (torch.from_numpy(buf).to(self.device), (min(h, hm), min(w, wm)))
        self.device_uploads += 1
        self._dev_cache[idx] = ent
        while len(self._dev_cache) > self._dev_cache_max:
            self._dev_cache.popitem(last=False)
        return ent

    def _tile_paths(self, idx: int) -> List[str]:
        return [
            self.graph.get_node(self._nodes[ci]).payload.path
            for ci in sorted(self._tile_cams[idx])
        ]

    def _project_tile(self, tx: int, ty: int) -> Optional[dict]:
        disp = self._project_tile_dispatch(tx, ty)
        return self._project_tile_finish(disp)

    def _project_tile_dispatch(self, tx: int, ty: int) -> Optional[dict]:
        """Render one tile's layer stack: per-pixel top-KMAX cameras.

        The world grid always spans a full tile (one shape for every tile);
        edge tiles are cropped at write time. Dispatch and finish are split
        so the caller can enqueue tile N+1's work before pulling tile N's
        results (one-deep pipeline: the pull hides behind the next tile's
        compute)."""
        ts = self.tile_size
        gsd = self._gsd
        graph, model_store, nodes = self.graph, self.model_store, self._nodes
        flat_xy = _raster_grid(self._bounds, gsd, tx * ts, ty * ts, ts, ts)
        z = self._ctx.mesh.interpolate_z(flat_xy)
        valid_z = np.isfinite(z)
        points = np.concatenate([flat_xy, np.where(valid_z, z, 0.0)[:, None]], axis=1)

        cams = sorted(self._tile_cams[ty * self._tiles_x + tx])
        devs, hws, idxs = [], [], []
        for ci in cams:
            ent = self._device_image(ci)
            if ent is None:
                continue
            devs.append(ent[0])
            hws.append(ent[1])
            idxs.append(ci)
        if not devs:
            return None
        # pad the candidate set to the fixed KC so every tile has one shape
        kc = self._kc
        while len(devs) < kc:
            devs.append(devs[0])
            hws.append((0, 0))
            idxs.append(idxs[0])
        valid_mask = np.asarray([h[0] > 0 for h in hws], bool)
        # device-side stack of the cached images: no pixel re-upload
        stack = torch.stack(devs)
        models = _device_models(graph, model_store, [nodes[i] for i in idxs], self.device)
        scales = np.asarray(
            [
                hws[i][0]
                / max(float(model_store[graph.get_node(nodes[idxs[i]]).payload.model_id].pixels_rows), 1.0)
                for i in range(kc)
            ],
            np.float32,
        )
        kmax = min(MAX_CAMERAS_PER_PIXEL, kc)

        def dev(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

        out = _sample_select_kernel(
            dev(points, torch.float32),
            dev(self._quats_all[idxs], torch.float32),
            dev(self._poss_all[idxs], torch.float32),
            models,
            stack,
            dev(np.asarray(hws, np.int32), torch.int32),
            dev(scales, torch.float32),
            dev(valid_mask, torch.bool),
            dev(self._ctx.average_camera_elevation, torch.float32),
            dev(gsd, torch.float32),
            taps=self.taps,
            kmax=kmax,
        )
        return dict(dev=out, idxs=idxs, valid_z=valid_z, z=z)

    def _project_tile_finish(self, disp: Optional[dict]) -> Optional[dict]:
        if disp is None:
            return None
        lcolors, lweights, lgeom, sel = (x.cpu().numpy() for x in disp["dev"])
        valid_z = disp["valid_z"]
        z = disp["z"]
        lweights = lweights * valid_z[None].astype(np.float16)
        # node-list index per sample
        lcam = np.asarray(disp["idxs"], np.int32)[sel]
        return dict(
            colors=lcolors,
            weights=lweights,
            geom=lgeom,
            cam=lcam,
            z=np.where(valid_z, z, np.nan).astype(np.float32),
        )

    def _tile_ids(self, disp: dict):
        """(node-list index of every candidate slot, mesh-validity mask), on
        the device."""
        return (
            torch.as_tensor(np.asarray(disp["idxs"], np.int64), device=self.device),
            torch.as_tensor(disp["valid_z"], device=self.device),
        )

    def _corr_dispatch(self, disp: Optional[dict]):
        """Enqueue the device-side correspondence sampler on a freshly
        rendered tile; returns a dict of tensors or None."""
        if disp is None:
            return None
        lcolors, lweights, lgeom, sel = disp["dev"]
        if lweights.shape[0] < 2:
            return None
        s_max = self.tile_size * self.tile_size // CORR_STRIDE + 1
        cam_ids, valid_z = self._tile_ids(disp)
        return _corr_sample_kernel(
            lcolors, lweights, lgeom, sel, cam_ids, valid_z, stride=CORR_STRIDE, s_max=s_max,
        )

    def pass_layers(self):
        """GENERATE_LAYERS: render every tile on the device and pull only its
        strided Lab correspondence samples (with real radiometric geometry)
        for the color-balance solve; the layer stacks stay on the device and
        are recomputed by the blend pass."""
        if not self.ok:
            return False
        self.correspondences = []
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)

        def _finish(corr_dev):
            if corr_dev is None:
                return
            with PerformanceMeasure("ortho: correspondences"):
                self._append_correspondences({k: v.cpu().numpy() for k, v in corr_dev.items()})

        # one-deep pipeline: tile N+1's work is enqueued on the device before
        # tile N's samples are pulled
        pending = None
        try:
            for i, (tx, ty) in enumerate(self._order):
                if i + 1 < len(self._order):
                    nx_, ny_ = self._order[i + 1]
                    self._cache.prefetch(self._tile_paths(ny_ * self._tiles_x + nx_), pool=pool)
                with PerformanceMeasure("ortho: project tile"):
                    disp = self._project_tile_dispatch(tx, ty)
                    corr_dev = self._corr_dispatch(disp)
                if pending is not None:
                    _finish(pending)
                pending = corr_dev
            if pending is not None:
                _finish(pending)
        finally:
            pool.shutdown(wait=False)
        return True

    def _append_correspondences(self, out: dict):
        """Append one tile's pulled correspondence samples (reference
        ortho.cpp:1324-1418 collects the same every-stride-th overlap
        sample, here chosen and gathered on the device)."""
        valid = np.asarray(out["valid"], bool)
        rows = np.flatnonzero(valid)
        if len(rows) == 0:
            return
        graph, nodes = self.graph, self._nodes
        cam_a, cam_b = out["cam_a"], out["cam_b"]
        lab_a, lab_b = out["lab_a"], out["lab_b"]
        geom_a, geom_b = out["geom_a"], out["geom_b"]
        for p in rows:
            ia, ib = int(cam_a[p]), int(cam_b[p])
            ga, gb = geom_a[p], geom_b[p]
            self.correspondences.append(
                ColorCorrespondence(
                    camera_id_a=nodes[ia], camera_id_b=nodes[ib],
                    model_id_a=graph.get_node(nodes[ia]).payload.model_id,
                    model_id_b=graph.get_node(nodes[ib]).payload.model_id,
                    lab_a=lab_a[p], lab_b=lab_b[p],
                    normalized_radius_a=float(ga[0]), normalized_radius_b=float(gb[0]),
                    view_angle_a=float(ga[1]), view_angle_b=float(gb[1]),
                    normalized_x_a=float(ga[2]), normalized_y_a=float(ga[3]),
                    normalized_x_b=float(gb[2]), normalized_y_b=float(gb[3]),
                )
            )

    def solve_balance(self):
        """COLOR_BALANCE: solve radiometric parameters."""
        if not self.ok:
            return False
        cam_positions = {
            nid: np.asarray(self.graph.get_node(nid).payload.position[:2])
            for nid in self._nodes
        }
        with PerformanceMeasure("ortho: balance solve"):
            self.balance = solve_color_balance(self.correspondences, cam_positions, device=self.device)
        return True

    # -- pass 2: correct + blend + stream-write ---------------------------

    def _correction_tables(self):
        """Per-node-index correction arrays for vectorized application."""
        n = len(self._nodes)
        off = np.zeros((n, 3))
        brdf = np.zeros(n)
        slope = np.zeros((n, 2))
        vig = np.zeros((n, 3))
        if self.balance is not None and self.balance.success:
            for i, nid in enumerate(self._nodes):
                p = self.balance.per_image_params.get(nid)
                if p is not None:
                    off[i] = p.lab_offset
                    brdf[i] = p.brdf_coeff
                    slope[i] = p.slope
                mid = self.graph.get_node(nid).payload.model_id
                v = self.balance.per_model_vignetting.get(mid)
                if v is not None:
                    vig[i] = v
        return off, brdf, slope, vig

    def _blend_tile_dispatch(self, disp: Optional[dict], tables_dev):
        """Enqueue one freshly rendered tile's correct + transition + fill +
        blend chain; returns device tensors (lab8, alpha, cam0). The layer
        stack never leaves the device."""
        if disp is None:
            return None
        off, brdf, slope, vig = tables_dev
        lcolors, lweights, lgeom, sel = disp["dev"]
        cam_ids, valid_z = self._tile_ids(disp)
        return _render_blend_kernel(
            lcolors, lweights, lgeom, sel, cam_ids, valid_z,
            off, brdf, slope, vig,
            torch.as_tensor(self.blend_transition, dtype=torch.float32, device=self.device),
            ts=self.tile_size,
            levels=min(self.blend_levels, max(1, int(math.log2(self.tile_size)) - 1)),
        )

    def _blend_tile_finish(self, dev, th: int, tw: int, want_cam: bool):
        """Lab->BGR convert on the device + pull + alpha + crop; returns
        (RGBA [th, tw, 4], cam0 [th, tw] node-list index or None)."""
        lab8, alpha, cam0 = dev
        bgr = lab_u8_to_bgr(lab8).cpu().numpy()
        alpha = alpha.cpu().numpy()
        rgba = np.concatenate([bgr, np.where(alpha, 255, 0).astype(np.uint8)[..., None]], axis=2)
        ts = self.tile_size
        cam0 = cam0.cpu().numpy().reshape(ts, ts)[:th, :tw] if want_cam else None
        return rgba[:th, :tw], cam0

    def _device_tables(self):
        return tuple(
            torch.as_tensor(t, dtype=torch.float32, device=self.device)
            for t in self._correction_tables()
        )

    def pass_blend(self, path: str, camera_id_path: Optional[str] = None) -> bool:
        """BLEND_LAYERS: re-render each tile on the device, correct + blend
        it there, stream finished tiles into a tiled GeoTIFF (+ optional
        camera-id sidecar). Peak memory is one tile + overview accumulators,
        never the full mosaic (reference streams tiles through GDAL,
        ortho.cpp:1665-2050)."""
        if not self.ok:
            return False
        b = self._bounds
        wkt = _wkt_of(self.geocoord)
        tables = self._device_tables()
        writer = GeoTiffTileWriter(
            path, self._width, self._height, 4, np.uint8,
            (b.min_x, b.max_y), (self._gsd, self._gsd),
            tile_size=self.tile_size, wkt=wkt, overviews=3,
        )
        cam_writer = None
        if camera_id_path:
            # single uint64 band: the reference round-trips whole uint64
            # camera ids through this raster (test_ortho_functional.cpp)
            cam_writer = GeoTiffTileWriter(
                camera_id_path, self._width, self._height, 1, np.uint64,
                (b.min_x, b.max_y), (self._gsd, self._gsd),
                tile_size=self.tile_size, wkt=wkt,
            )
        ts = self.tile_size

        def _finish(pending):
            k, tx, ty, dev, th, tw = pending
            cam0 = None
            if dev is None:
                rgba = np.zeros((th, tw, 4), np.uint8)
            else:
                with PerformanceMeasure("ortho: blend finish"):
                    rgba, cam0 = self._blend_tile_finish(dev, th, tw, want_cam=cam_writer is not None)
            if cam_writer is not None:
                if cam0 is None:
                    ids = np.zeros((th, tw), np.uint64)
                else:
                    covered = rgba[:, :, 3] == 255
                    ids = np.where(covered, np.asarray(self._nodes, np.uint64)[cam0], np.uint64(0))
                cam_writer.write_tile(tx, ty, ids[..., None])
            with PerformanceMeasure("ortho: write tiles"):
                writer.write_tile(tx, ty, rgba)
            if self.tile_callback is not None:
                small = resize_area(rgba, (64, 64))
                self.tile_callback(
                    dict(
                        tile_x=tx, tile_y=ty,
                        num_tiles_x=self._tiles_x,
                        num_tiles_y=self._tiles_y,
                        fraction_done=(k + 1) / max(len(self._order), 1),
                        png_base64=base64.b64encode(encode_png(small)).decode("ascii"),
                    )
                )

        # same one-deep pipeline as pass_layers: tile N+1's render + blend
        # are enqueued before tile N's pixels are pulled
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
        pending = None
        try:
            for k, (tx, ty) in enumerate(self._order):
                if k + 1 < len(self._order):
                    nx_, ny_ = self._order[k + 1]
                    self._cache.prefetch(self._tile_paths(ny_ * self._tiles_x + nx_), pool=pool)
                tw = min(ts, self._width - tx * ts)
                th = min(ts, self._height - ty * ts)
                with PerformanceMeasure("ortho: blend dispatch"):
                    disp = self._project_tile_dispatch(tx, ty)
                    dev = self._blend_tile_dispatch(disp, tables)
                if pending is not None:
                    _finish(pending)
                pending = (k, tx, ty, dev, th, tw)
            if pending is not None:
                _finish(pending)
        finally:
            pool.shutdown(wait=False)
            writer.close()
            if cam_writer is not None:
                cam_writer.close()
        return True


def generate_ortho_geotiff(
    path: str, surfaces, graph, model_store, geocoord=None,
    max_megapixels: float = 64.0, tile_size: int = DEFAULT_TILE,
    cache_images: int = 16, blend_levels: int = 4,
    camera_id_path: Optional[str] = None, *, device="cuda",
) -> bool:
    job = OrthoJob(
        surfaces, graph, model_store, geocoord, max_megapixels,
        tile_size, cache_images, blend_levels, device=device,
    )
    if not job.ok:
        return False
    job.pass_layers()
    job.solve_balance()
    return job.pass_blend(path, camera_id_path=camera_id_path)


def generate_textured_obj(
    path_prefix: str, surfaces, ortho_rgba: np.ndarray,
    origin_xy: Tuple[float, float], gsd: float,
) -> bool:
    """OBJ + MTL + JPG textured mesh export (reference generateTexturedOBJ,
    ortho.cpp:2052-2260): UVs from the orthomosaic georeference. The texture
    is the mosaic's first three channels written as ``cv2.imwrite`` writes
    them, through the port's JPEG encoder."""
    mesh = None
    for s in surfaces:
        if s.mesh is not None and s.mesh.num_vertices > 0:
            mesh = s.mesh
            break
    if mesh is None:
        return False
    h, w = ortho_rgba.shape[:2]
    with open(path_prefix + ".jpg", "wb") as f:
        f.write(encode_jpeg(ortho_rgba[..., :3]))
    name = path_prefix.split("/")[-1]
    with open(path_prefix + ".mtl", "w") as f:
        f.write(f"newmtl ortho\nKa 1 1 1\nKd 1 1 1\nmap_Kd {name}.jpg\n")
    with open(path_prefix + ".obj", "w") as f:
        f.write(f"mtllib {name}.mtl\nusemtl ortho\n")
        for v in mesh.vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for v in mesh.vertices:
            u = (v[0] - origin_xy[0]) / (gsd * w)
            vv = 1.0 - (origin_xy[1] - v[1]) / (gsd * h)
            f.write(f"vt {u:.6f} {vv:.6f}\n")
        for t in mesh.triangles:
            a, bb, c = t[0] + 1, t[1] + 1, t[2] + 1
            f.write(f"f {a}/{a} {bb}/{bb} {c}/{c}\n")
    return True
