"""Orthomosaic test scenes and checks shared by the CPU tests, the card-only
tests and ``chip_smoke.py``: a ground-truth entry state of the ortho tail on
a synthetic colour survey, the scene's own colour at a raster's georeference,
and the comparison of two runs of the tail from one state (the card against
the CPU).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from opencalibration_tpu_torch.extract.image_loader import load_and_decode
from opencalibration_tpu_torch.io import geotiff
from opencalibration_tpu_torch.ops.color import bgr_to_lab_u8
from opencalibration_tpu_torch.ortho.ortho import OrthoJob
from opencalibration_tpu_torch.surface.mesh import TriMesh
from opencalibration_tpu_torch.testing import survey
from opencalibration_tpu_torch.types.camera import CameraModel
from opencalibration_tpu_torch.types.graph import MeasurementGraph, SurfaceModel

# two runs of the tail from one state, float32 on both devices
RGBA_EQUAL_SHARE = 0.99  # of the RGBA bytes
RGBA_MAX_LEVELS = 2
BALANCE_ABS = 0.05  # Lab levels and coefficients


def flat_mesh(x=(0.0, 45.0, 90.0), y=(5.0, 37.5, 70.0), z=0.0) -> TriMesh:
    """A 3 x 3-vertex, 8-triangle mesh at height z over the ground a 2 x 3
    survey of ``survey.camera_grid`` sees."""
    gx, gy = np.meshgrid(x, y)
    tris = [[a, a + 1, a + 4] for a in (0, 1, 3, 4)] + [[a, a + 4, a + 3] for a in (0, 1, 3, 4)]
    return TriMesh(np.stack([gx.ravel(), gy.ravel(), np.full(9, z)], 1), np.asarray(tris, np.int32))


def ground_truth_state(directory, rows=2, cols=3, seed=0, gains=True):
    """Write the colour survey (PPM, per-image exposure gains) and build the
    ortho tail's entry state from ground truth: every node decoded by the
    port's loader (thumbnail included) at its true pose, one float64 camera
    model, the flat mesh. Returns a dict with ``surfaces``, ``graph``,
    ``model_store`` (the entry points' first three arguments), ``paths``,
    ``positions`` and ``quats``."""
    g = survey.survey_gains(rows * cols, seed) if gains else None
    paths, positions, quats = survey.write_survey(directory, rows, cols, seed=seed, color=True, gains=g, device="cpu")
    graph = MeasurementGraph()
    for path, pos, q in zip(paths, positions, quats):
        node = load_and_decode(path).node
        node.model_id, node.position, node.orientation = 0, np.array(pos), np.array(q)
        graph.add_node(node)
    model = CameraModel.create(survey.FOCAL, (survey.IMG_W / 2, survey.IMG_H / 2), pixels_cols=survey.IMG_W,
                               pixels_rows=survey.IMG_H, dtype=torch.float64, device="cpu")
    return dict(surfaces=[SurfaceModel(cloud=[], mesh=flat_mesh())], graph=graph, model_store={0: model},
                paths=paths, positions=positions, quats=quats)


def scene_lab_l(origin_xy, pixel_size, shape_hw, positions, seed=0, texture=None, offset_xy=(0.0, 0.0)):
    """L (0..255, as float64) of the scene's own colour, without any exposure
    gain, at every pixel of a raster with this georeference: the survey's
    texture sampled as ``write_survey(..., color=True)`` renders it.
    ``positions`` are the survey's camera positions (they fix the textured
    extent); ``offset_xy`` is added to the raster's coordinates to reach the
    survey's frame (a pipeline's local frame starts at its first camera)."""
    h, w = shape_hw
    gx, gy = np.meshgrid(origin_xy[0] + offset_xy[0] + pixel_size[0] * np.arange(w),
                         origin_xy[1] + offset_xy[1] - pixel_size[1] * np.arange(h))
    extent = survey.survey_extent(positions)
    if texture is None:
        texture = min(4096, max(512, int(extent / 150.0 * 512)))
    s = survey.sample_ground(survey.color_texture(seed, texture), np.stack([gx.ravel(), gy.ravel()], 1), extent)
    rgb = (survey.colorize(s[:, 0], s[:, 1:]) * 255).astype(np.uint8)
    return bgr_to_lab_u8(rgb[:, ::-1].reshape(h, w, 3))[..., 0].astype(np.float64)


def median_l_error(ortho, positions, seed=0, texture=None, offset_xy=(0.0, 0.0), window=None, smooth_m=0.0):
    """(median absolute L error against the scene over covered pixels,
    covered share) of an orthomosaic: a GeoTIFF's path or what
    ``read_geotiff`` returned for it. ``window`` = (row0, row1, col0, col1)
    restricts both numbers to that part of the raster. With ``smooth_m`` the
    signed error is first averaged over the covered pixels of a box of that
    many metres: a mosaic from calibrated (not true) poses sits a few pixels
    off the scene, which on a fine texture costs more levels than any
    exposure error, while a box average keeps only the exposure's part."""
    img, origin, px, _ = geotiff.read_geotiff(ortho) if isinstance(ortho, str) else ortho
    if window is not None:
        r0, r1, c0, c1 = window
        img = img[r0:r1, c0:c1]
        origin = (origin[0] + c0 * px[0], origin[1] - r0 * px[1])
    covered = img[..., 3] == 255
    got = bgr_to_lab_u8(img[..., :3])[..., 0].astype(np.float64)
    err = got - scene_lab_l(origin, px, img.shape[:2], positions, seed, texture, offset_xy)
    keep = covered
    if smooth_m > 0.0:
        from scipy.ndimage import uniform_filter

        box = max(1, int(round(smooth_m / px[0])))
        weight = uniform_filter(covered.astype(np.float64), box, mode="constant")
        keep = covered & (weight > 0.5)
        err = uniform_filter(np.where(covered, err, 0.0), box, mode="constant") / np.maximum(weight, 1e-9)
    return float(np.median(np.abs(err[keep]))), float(covered.mean())


def balance_vector(balance) -> np.ndarray:
    """Every solved parameter in a fixed order: per image (by id) offsets,
    BRDF, slope; then per model vignetting."""
    parts = []
    for cid in sorted(balance.per_image_params):
        p = balance.per_image_params[cid]
        parts += [np.asarray(p.lab_offset, np.float64), [p.brdf_coeff], np.asarray(p.slope, np.float64)]
    parts += [np.asarray(balance.per_model_vignetting[m], np.float64) for m in sorted(balance.per_model_vignetting)]
    return np.concatenate(parts)


def run_ortho_tail(state, out_dir, device, megapixels=0.04, tile_size=64, name=None):
    """GENERATE_LAYERS, COLOR_BALANCE and BLEND_LAYERS of one ``OrthoJob`` on
    ``device``; returns the job and what it wrote, read back."""
    name = name or torch.device(device).type
    job = OrthoJob(state["surfaces"], state["graph"], state["model_store"], max_megapixels=megapixels,
                   tile_size=tile_size, device=device)
    if not job.ok:
        raise AssertionError("the ortho job found no surface or no posed image")
    job.pass_layers()
    job.solve_balance()
    ortho, cam = os.path.join(out_dir, f"{name}_ortho.tif"), os.path.join(out_dir, f"{name}_cam.tif")
    job.pass_blend(ortho, camera_id_path=cam)
    rgba = geotiff.read_geotiff(ortho)[0]
    ids = geotiff.read_geotiff(cam)[0].reshape(rgba.shape[:2])
    return dict(job=job, ortho_path=ortho, rgba=rgba, camera_ids=ids)


def compare_ortho_tails(a, b) -> dict:
    """Hold run ``a`` to run ``b`` (``run_ortho_tail`` results from one
    state): the same correspondences' cameras, balance parameters within
    ``BALANCE_ABS``, RGBA bytes at least ``RGBA_EQUAL_SHARE`` equal and none
    further than ``RGBA_MAX_LEVELS``, camera ids equal wherever both are
    covered. Raises ``AssertionError``; returns the measured numbers."""
    ja, jb = a["job"], b["job"]
    pairs = lambda job: [(c.camera_id_a, c.camera_id_b) for c in job.correspondences]  # noqa: E731
    if pairs(ja) != pairs(jb):
        raise AssertionError(f"correspondence sets differ: {len(ja.correspondences)} against {len(jb.correspondences)}")
    dbal = float(np.abs(balance_vector(ja.balance) - balance_vector(jb.balance)).max())
    if not dbal <= BALANCE_ABS:
        raise AssertionError(f"balance parameters differ by {dbal} (allowed {BALANCE_ABS})")
    if a["rgba"].shape != b["rgba"].shape:
        raise AssertionError(f"raster shapes differ: {a['rgba'].shape} against {b['rgba'].shape}")
    d = np.abs(a["rgba"].astype(int) - b["rgba"].astype(int))
    share = float((d == 0).mean())
    if share < RGBA_EQUAL_SHARE or d.max() > RGBA_MAX_LEVELS:
        raise AssertionError(f"RGBA: {share:.5f} of the bytes equal, largest difference {d.max()} "
                             f"(allowed {RGBA_EQUAL_SHARE}, {RGBA_MAX_LEVELS})")
    both = (a["rgba"][..., 3] == 255) & (b["rgba"][..., 3] == 255)
    if both.mean() < 0.3:
        raise AssertionError(f"only {both.mean():.3f} of the raster is covered by both runs")
    differ = int((a["camera_ids"][both] != b["camera_ids"][both]).sum())
    if differ:
        raise AssertionError(f"camera ids differ at {differ} pixels covered by both runs")
    return dict(correspondences=len(ja.correspondences), balance_max_abs=dbal, rgba_equal_share=share,
                rgba_max_levels=int(d.max()), covered_by_both=float(both.mean()))
