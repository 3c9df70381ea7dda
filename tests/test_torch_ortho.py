"""The port's orthomosaic (opencalibration_tpu_torch.ortho.ortho) against the
JAX package's, from one ground-truth state: a 2 x 3 colour survey at
320 x 240 (binary PPM, per-image exposure gains) with every node at its true
pose, one camera model and a flat 3 x 3-vertex mesh at z = 0 over the
ground the cameras see (``build_minimal_mesh`` reaches 170 m beyond the
cameras, which would leave 95 % of the raster empty). The
state is built with the JAX package's containers, thumbnails included, and
carried to the port through ``interop``, so both render the same pixels.

Both run in float32 on the CPU with ``tile_size=64`` and a 0.04 MP cap (16
tiles at most); ``taps=3`` as the pipeline runs it.

Tolerances:
* blended orthomosaic: at least 99 % of the RGBA bytes equal and none
  further than 2 levels (the layers are stored as float16, whose step near
  255 is 0.125, so a last-bit float32 difference can move a truncated uint8
  by one);
* thumbnail mosaic: at least 97 % of the RGBA bytes equal and none further
  than 3 levels. Its Lab value is a float32 bilinear sample truncated to
  uint8. Where the four neighbours are equal (flat chroma: 15 % of this
  scene's samples) the exact sample is an integer v and float32 gives v or
  v - 1e-5, which truncates to v - 1; XLA's CPU code contracts the products
  and sums into fused multiply-adds and torch's does not, so the two packages
  land on different sides for about 1 % of the bytes, and one Lab level is up
  to 3 BGR levels;
* DSM rasters within 1e-5 m, overlap counts equal, camera ids equal wherever
  both packages cover the pixel;
* correspondences: the same (camera a, camera b) sequence; Lab within 0.25
  (two float16 steps at 255), geometry within 2e-3 (two float16 steps at 1);
* balance parameters within 0.05 Lab levels (offsets), 0.05 (the other
  coefficients), from each package's own correspondences;
* GeoTIFFs written by each package are read by both readers with equal
  arrays and georeference;
* the textured OBJ's text is equal; the ``.mtl`` differs in the texture's
  file name alone.
"""

import numpy as np
import pytest

from opencalibration_tpu.extract import image_loader as JL
from opencalibration_tpu.io import geotiff as JGT
from opencalibration_tpu.ortho import ortho as JO
from opencalibration_tpu.surface.mesh import TriMesh as JTriMesh
from opencalibration_tpu.types import graph as JG
from opencalibration_tpu.types.camera import CameraModel as JCameraModel
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.io import geotiff as TGT
from opencalibration_tpu_torch.ortho import ortho as TO
from opencalibration_tpu_torch.testing import survey as TS
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

EQUAL_SHARE = 0.99
MAX_LEVELS = 2
THUMB_EQUAL_SHARE = 0.97
THUMB_MAX_LEVELS = 3
DSM_M = 1e-5
LAB_F16 = 0.25
GEOM_F16 = 2e-3
OFFSET_LEVELS = 0.05
COEFF = 0.05
TILE = 64
MEGAPIXELS = 0.04


def flat_mesh(cls, x=(0.0, 45.0, 90.0), y=(5.0, 37.5, 70.0)):
    """A 3 x 3-vertex, 8-triangle mesh at z = 0."""
    gx, gy = np.meshgrid(x, y)
    vertices = np.stack([gx.ravel(), gy.ravel(), np.zeros(9)], axis=1)
    tris = []
    for r in range(2):
        for c in range(2):
            a = r * 3 + c
            tris += [[a, a + 1, a + 4], [a, a + 4, a + 3]]
    return cls(vertices, np.asarray(tris, np.int32))


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    """(JAX state, port state), each (surfaces, graph, model_store)."""
    d = str(tmp_path_factory.mktemp("color_survey"))
    paths, positions, quats = TS.write_survey(d, 2, 3, color=True, gains=TS.survey_gains(6), device="cpu")
    model = JCameraModel.create(TS.FOCAL, (TS.IMG_W / 2, TS.IMG_H / 2), pixels_cols=TS.IMG_W, pixels_rows=TS.IMG_H)
    graph = JG.MeasurementGraph()
    for path, pos, q in zip(paths, positions, quats):
        node = JL.load_and_decode(path).node  # the reference's thumbnail (cv2)
        node.model_id, node.position, node.orientation = 0, np.array(pos), np.array(q)
        graph.add_node(node)
    mesh = flat_mesh(JTriMesh)
    j_state = ([JG.SurfaceModel(cloud=[], mesh=mesh)], graph, {0: model})
    t_state = ([interop.surface_from(s) for s in j_state[0]], interop.graph_from(graph),
               interop.model_store_from(j_state[2]))
    return j_state, t_state


def _assert_rgba_close(got, ref, equal_share=EQUAL_SHARE, max_levels=MAX_LEVELS):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    d = np.abs(got.astype(int) - ref.astype(int))
    share = float((d == 0).mean())
    print(f"equal bytes {share:.5f}, max difference {d.max()}")
    assert share >= equal_share and d.max() <= max_levels


def test_thumbnail_orthomosaic(state):
    j_state, t_state = state
    ref = JO.generate_orthomosaic(*j_state, max_megapixels=MEGAPIXELS)
    got = TO.generate_orthomosaic(*t_state, max_megapixels=MEGAPIXELS, device="cpu")
    assert got.gsd == pytest.approx(ref.gsd, rel=1e-12) and got.origin_xy == pytest.approx(ref.origin_xy)
    _assert_rgba_close(got.rgba, ref.rgba, THUMB_EQUAL_SHARE, THUMB_MAX_LEVELS)
    assert (ref.rgba[..., 3] == 255).mean() > 0.3
    np.testing.assert_allclose(got.dsm, ref.dsm, rtol=0, atol=DSM_M, equal_nan=True)
    np.testing.assert_array_equal(got.overlap, ref.overlap)
    both = (got.camera_index >= 0) & (ref.camera_index >= 0)
    assert both.sum() == (ref.camera_index >= 0).sum()
    np.testing.assert_array_equal(got.camera_index[both], ref.camera_index[both])
    # and the container crosses the packages by attribute
    back = interop.ortho_mosaic_from(got, JO.OrthoMosaic)
    np.testing.assert_array_equal(back.rgba, got.rgba)
    assert isinstance(interop.ortho_mosaic_from(ref), TO.OrthoMosaic)


@pytest.fixture(scope="module")
def jobs(state):
    j_state, t_state = state
    ref = JO.OrthoJob(*j_state, max_megapixels=MEGAPIXELS, tile_size=TILE)
    got = TO.OrthoJob(*t_state, max_megapixels=MEGAPIXELS, tile_size=TILE, device="cpu")
    assert ref.ok and got.ok
    for job in (ref, got):
        job.pass_layers()
        job.solve_balance()
    return ref, got


def test_job_layout(jobs):
    ref, got = jobs
    assert (got._width, got._height, got._tiles_x, got._tiles_y, got._kc) == (
        ref._width, ref._height, ref._tiles_x, ref._tiles_y, ref._kc)
    assert got._gsd == pytest.approx(ref._gsd, rel=1e-12)
    assert got._order == ref._order and got._tile_cams == ref._tile_cams
    assert got._tiles_x * got._tiles_y == 12


def test_correspondences(jobs):
    ref, got = jobs
    assert len(ref.correspondences) > 50
    assert [(c.camera_id_a, c.camera_id_b) for c in got.correspondences] == [
        (c.camera_id_a, c.camera_id_b) for c in ref.correspondences]
    lab = lambda cs: np.array([np.concatenate([c.lab_a, c.lab_b]) for c in cs])  # noqa: E731
    geom = lambda cs: np.array([[c.normalized_radius_a, c.normalized_radius_b, c.view_angle_a, c.view_angle_b,  # noqa: E731
                                 c.normalized_x_a, c.normalized_y_a, c.normalized_x_b, c.normalized_y_b] for c in cs])
    np.testing.assert_allclose(lab(got.correspondences), lab(ref.correspondences), rtol=0, atol=LAB_F16)
    np.testing.assert_allclose(geom(got.correspondences), geom(ref.correspondences), rtol=0, atol=GEOM_F16)
    # the list crosses the packages by attribute
    back = interop.color_correspondences_from(got.correspondences[:3], JO.ColorCorrespondence)
    assert back[0].camera_id_a == got.correspondences[0].camera_id_a
    assert isinstance(interop.color_correspondences_from(ref.correspondences[:1])[0], TO.ColorCorrespondence)


def test_balance_parameters(jobs):
    ref, got = jobs
    assert ref.balance.success and got.balance.success
    assert got.balance.final_cost == pytest.approx(ref.balance.final_cost, rel=1e-3)
    assert sorted(got.balance.per_image_params) == sorted(ref.balance.per_image_params)
    spread = 0.0
    for nid, r in ref.balance.per_image_params.items():
        g = got.balance.per_image_params[nid]
        np.testing.assert_allclose(g.lab_offset, r.lab_offset, rtol=0, atol=OFFSET_LEVELS)
        assert abs(g.brdf_coeff - r.brdf_coeff) <= COEFF
        np.testing.assert_allclose(g.slope, r.slope, rtol=0, atol=COEFF)
        spread = max(spread, abs(r.lab_offset[0]))
    assert spread > 1.0  # the exposure gains gave the solve something to find
    for mid, v in ref.balance.per_model_vignetting.items():
        np.testing.assert_allclose(got.balance.per_model_vignetting[mid], v, rtol=0, atol=COEFF)
    from opencalibration_tpu.ortho import color_balance as JCB

    back = interop.color_balance_from(got.balance, JCB)
    assert back.success and sorted(back.per_image_params) == sorted(got.balance.per_image_params)


def _read_both(path):
    a, b = JGT.read_geotiff(path), TGT.read_geotiff(path)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1] and a[2] == b[2]
    return b


def test_blended_geotiffs(jobs, tmp_path):
    ref, got = jobs
    out = {}
    for name, job in (("ref", ref), ("got", got)):
        ortho, cam = str(tmp_path / f"{name}_ortho.tif"), str(tmp_path / f"{name}_cam.tif")
        assert job.pass_blend(ortho, camera_id_path=cam)
        out[name] = (_read_both(ortho), _read_both(cam))
    (r_img, r_origin, r_px, _), (r_cam, *_) = out["ref"]
    (g_img, g_origin, g_px, _), (g_cam, *_) = out["got"]
    assert g_origin == pytest.approx(r_origin) and g_px == pytest.approx(r_px)
    _assert_rgba_close(g_img, r_img)
    assert (r_img[..., 3] == 255).mean() > 0.3
    assert g_cam.dtype == r_cam.dtype == np.uint64
    both = (g_img[..., 3] == 255) & (r_img[..., 3] == 255)
    np.testing.assert_array_equal(g_cam.reshape(both.shape)[both], r_cam.reshape(both.shape)[both])
    assert set(np.unique(g_cam)) <= set(got._nodes) | {0}
    # overviews of the port's file, listed alike by both
    shapes = TGT.read_geotiff_overviews(str(tmp_path / "got_ortho.tif"))
    assert shapes == JGT.read_geotiff_overviews(str(tmp_path / "got_ortho.tif")) and len(shapes) >= 2
    assert shapes == JGT.read_geotiff_overviews(str(tmp_path / "ref_ortho.tif"))


def test_dsm_geotiff(state, tmp_path):
    j_state, t_state = state
    ref_path, got_path = str(tmp_path / "ref_dsm.tif"), str(tmp_path / "got_dsm.tif")
    assert JO.generate_dsm_geotiff(ref_path, *j_state, max_megapixels=MEGAPIXELS)
    assert TO.generate_dsm_geotiff(got_path, *t_state, max_megapixels=MEGAPIXELS, device="cpu")
    r, g = _read_both(ref_path), _read_both(got_path)
    assert g[1] == pytest.approx(r[1]) and g[2] == pytest.approx(r[2])
    np.testing.assert_allclose(g[0], r[0], rtol=0, atol=DSM_M)
    assert (g[0] != -32767.0).mean() > 0.3


def test_textured_obj(state, tmp_path):
    j_state, t_state = state
    rgba = np.random.default_rng(0).integers(0, 256, (40, 50, 4), dtype=np.uint8)
    assert JO.generate_textured_obj(str(tmp_path / "ref"), j_state[0], rgba, (3.0, 90.0), 0.5)
    assert TO.generate_textured_obj(str(tmp_path / "got"), t_state[0], rgba, (3.0, 90.0), 0.5)
    text = lambda n: open(str(tmp_path / n)).read()  # noqa: E731
    assert text("got.obj").replace("got.mtl", "ref.mtl") == text("ref.obj")
    assert text("got.mtl").replace("got.png", "ref.jpg") == text("ref.mtl")
    from opencalibration_tpu_torch.io.png import decode_png

    np.testing.assert_array_equal(decode_png(open(str(tmp_path / "got.png"), "rb").read()), rgba[..., :3])


def test_generate_ortho_geotiff_and_device_rule(state, tmp_path):
    _, t_state = state
    path = str(tmp_path / "all.tif")
    assert TO.generate_ortho_geotiff(path, *t_state, max_megapixels=MEGAPIXELS, tile_size=TILE, device="cpu")
    assert TGT.read_geotiff(path)[0].shape[2] == 4
    import torch

    if not torch.cuda.is_available():
        for call in (lambda: TO.OrthoJob(*t_state), lambda: TO.generate_orthomosaic(*t_state),
                     lambda: TO.generate_dsm_geotiff(path, *t_state), lambda: TO.generate_ortho_geotiff(path, *t_state)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
