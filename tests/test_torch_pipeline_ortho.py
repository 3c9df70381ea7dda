"""The port's pipeline from FINAL_GLOBAL_RELAX's exit state to COMPLETE, in a
process where ``import jax``, ``import opencalibration_tpu`` (the JAX
package) and ``import cv2`` all fail.

The state is built from ground truth on a 2 x 3 colour survey at 320 x 240
(binary PPM with per-image exposure gains, ``testing/ortho_cases.py``): nodes
decoded by the port's loader (thumbnails included) at their true poses, one
float64 camera model, a flat mesh at z = 0 over the ground the cameras see. ``iterate_once`` then
drives GENERATE_THUMBNAIL, the skipped dense-mesh states, GENERATE_LAYERS,
COLOR_BALANCE and BLEND_LAYERS to COMPLETE with every output path set, with a
0.15 MP cap (2 x 2 tiles of 256). A second pipeline in the same state with no
output path set passes through the same states. The outputs are read back
here.

Bounds: the orthomosaic covers at least 60 % of its raster; against the
scene's own texture resampled at the mosaic's georeference the median
absolute L error over covered pixels is at most 8 levels of 255. The
surveyed exposure gains are +-10 % of the gamma-encoded values, up to +-13
levels at mid gray; the same
mosaic blended without the colour balance measures 9 and with it 6, and a
survey without gains 1. Six images leave much of the exposure pattern to the
balance's plane-fit gauge, which is why it is not flatter.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from opencalibration_tpu_torch.io import geotiff
from opencalibration_tpu_torch.io.png import decode_png
from opencalibration_tpu_torch.pipeline.pipeline import PipelineState
from opencalibration_tpu_torch.testing import ortho_cases
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

COVERED_SHARE = 0.6
MEDIAN_L_LEVELS = 8.0
MEGAPIXELS = 0.15

_CODE = """
    import json, os, sys
    sys.modules["jax"] = None  # any import of jax raises
    sys.modules["opencalibration_tpu"] = None  # and of the JAX package (not the port's prefix)
    sys.modules["cv2"] = None  # and of OpenCV
    import numpy as np
    from opencalibration_tpu_torch.pipeline.pipeline import Pipeline, PipelineState
    from opencalibration_tpu_torch.testing import ortho_cases, survey

    out = {out!r}
    truth = ortho_cases.ground_truth_state(out)
    positions = truth["positions"]

    def entry_state():
        p = Pipeline(device="cpu")
        p.geocoord.set_origin(survey.ORIGIN_LAT, survey.ORIGIN_LON)
        for _, node in truth["graph"].nodes():
            p.graph.add_node(node.payload)
        p.model_store.update(truth["model_store"])
        p.surfaces = list(truth["surfaces"])
        p.reset_state(PipelineState.GENERATE_THUMBNAIL)
        return p

    def drive(p):
        states, tiles = [], []
        p.step_callback = lambda info: tiles.append(info.tile_update) if info.tile_update else None
        for _ in range(20):
            states.append(p.get_state())
            r = p.iterate_once()
            if r == "DONE":
                break
        return states, r, tiles

    p = entry_state()
    p.ortho_path = os.path.join(out, "ortho.tif")
    p.dsm_path = os.path.join(out, "dsm.tif")
    p.camera_id_path = os.path.join(out, "cam.tif")
    p.thumbnail_path = os.path.join(out, "thumb.png")
    p.textured_obj_prefix = os.path.join(out, "model")
    p.ortho_max_megapixels = {mp}
    states, last, tiles = drive(p)
    job = p._ortho_job

    bare = entry_state()
    bare_states, bare_last, _ = drive(bare)

    wrong = entry_state()
    wrong.thumbnail_path = os.path.join(out, "thumb.jpg")
    try:
        wrong.iterate_once()
        refused = ""
    except NotImplementedError as e:
        refused = str(e)

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "opencalibration_tpu", "cv2") and sys.modules[m])
    print(json.dumps(dict(
        states=states, last=last, final_state=p.get_state(), run_count=p.state_run_count(),
        bare_states=bare_states, bare_last=bare_last, bare_mosaic=bare.thumbnail_mosaic is not None,
        bare_job=bare._ortho_job is not None, refused=refused, loaded=loaded,
        node_ids=[int(n) for n, _ in p.graph.nodes()],
        thumbs=[list(n.payload.thumbnail.shape) for _, n in p.graph.nodes()],
        mosaic_shape=list(p.thumbnail_mosaic.rgba.shape), mosaic_gsd=p.thumbnail_mosaic.gsd,
        tiles=[[t["tile_x"], t["tile_y"], t["num_tiles_x"], t["num_tiles_y"], t["fraction_done"], t["png_base64"]]
               for t in tiles],
        correspondences=len(job.correspondences), balance=bool(job.balance.success),
        cache=[job._cache.hits, job._cache.misses, job.device_uploads],
        positions=np.asarray(positions).tolist(),
    )))
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("to_complete"))
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"  # one torch thread, as in this process (tests/torch_threads.py)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_CODE.format(out=out, mp=MEGAPIXELS))],
                       capture_output=True, text=True, timeout=600, cwd=root, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return out, json.loads(r.stdout.strip().splitlines()[-1])


def test_states_to_complete_and_done(run):
    _, info = run
    order = PipelineState.ORDER
    assert info["states"] == order[order.index(PipelineState.GENERATE_THUMBNAIL):]
    assert info["last"] == "DONE" and info["final_state"] == PipelineState.COMPLETE and info["run_count"] == 0
    assert info["correspondences"] > 100 and info["balance"]
    hits, misses, uploads = info["cache"]
    assert misses == 6 and uploads == 6 and hits >= 6  # each image decoded and uploaded once, then reused


def test_without_output_paths_the_states_pass_through(run):
    _, info = run
    assert info["bare_states"] == info["states"] and info["bare_last"] == "DONE"
    assert info["bare_mosaic"] and not info["bare_job"]  # the thumbnail mosaic is made, no ortho job
    assert "B8b" in info["refused"] and ".png" in info["refused"]


def test_no_jax_no_opencv(run):
    _, info = run
    assert info["loaded"] == []


def test_thumbnails_and_thumbnail_mosaic(run):
    out, info = run
    assert info["thumbs"] == [[43, 58, 3]] * 6
    png = decode_png(open(os.path.join(out, "thumb.png"), "rb").read())
    assert list(png.shape) == info["mosaic_shape"] and png.shape[2] == 4
    assert (png[..., 3] == 255).mean() > COVERED_SHARE
    assert 0.5 < info["mosaic_gsd"] < 2.0


def test_orthomosaic_geotiff(run):
    out, info = run
    img, origin, px, _ = geotiff.read_geotiff(os.path.join(out, "ortho.tif"))
    assert img.dtype == np.uint8 and img.shape[2] == 4
    assert img.shape[0] * img.shape[1] <= MEGAPIXELS * 1e6 * 1.01
    assert origin == pytest.approx((0.0, 70.0)) and px[0] == pytest.approx(px[1]) and 0.15 < px[0] < 0.4
    covered = img[..., 3] == 255
    assert covered.mean() > COVERED_SHARE
    assert len(geotiff.read_geotiff_overviews(os.path.join(out, "ortho.tif"))) >= 2
    median, share = ortho_cases.median_l_error(os.path.join(out, "ortho.tif"), np.asarray(info["positions"]))
    print(f"median |L error| {median:.3f} levels over {covered.sum()} covered pixels")
    assert median <= MEDIAN_L_LEVELS and share == covered.mean()
    # the blend pass reported every tile, each with a 64 x 64 BGRA preview
    tiles = info["tiles"]
    assert sorted((t[0], t[1]) for t in tiles) == [(x, y) for x in range(tiles[0][2]) for y in range(tiles[0][3])]
    assert len(tiles) == 4 and tiles[-1][4] == 1.0
    import base64

    assert decode_png(base64.b64decode(tiles[0][5])).shape == (64, 64, 4)


def test_camera_id_geotiff(run):
    out, info = run
    img = geotiff.read_geotiff(os.path.join(out, "ortho.tif"))[0]
    cam, origin, px, _ = geotiff.read_geotiff(os.path.join(out, "cam.tif"))
    cam = cam.reshape(img.shape[:2])
    assert cam.dtype == np.uint64
    covered = img[..., 3] == 255
    assert set(np.unique(cam[covered]).tolist()) <= set(info["node_ids"])
    assert (cam[~covered] == 0).all()
    assert len(np.unique(cam[covered])) == 6  # every camera is the strongest somewhere
    # under each camera's nadir the raster names that camera
    for nid, pos in zip(info["node_ids"], info["positions"]):
        col, row = int((pos[0] - origin[0]) / px[0]), int((origin[1] - pos[1]) / px[1])
        assert cam[row, col] == nid


def test_dsm_geotiff(run):
    out, _ = run
    dsm, origin, px, _ = geotiff.read_geotiff(os.path.join(out, "dsm.tif"))
    assert dsm.dtype == np.float32 and origin == pytest.approx((0.0, 70.0))
    inside = dsm != -32767.0
    assert inside.mean() > 0.95 and np.abs(dsm[inside]).max() < 1e-6  # the flat mesh at z = 0
    assert len(geotiff.read_geotiff_overviews(os.path.join(out, "dsm.tif"))) >= 2


def test_textured_obj(run):
    out, _ = run
    obj = open(os.path.join(out, "model.obj")).read().splitlines()
    assert obj[0] == "mtllib model.mtl" and sum(line.startswith("v ") for line in obj) == 9
    assert sum(line.startswith("f ") for line in obj) == 8
    assert "map_Kd model.png" in open(os.path.join(out, "model.mtl")).read()
    tex = decode_png(open(os.path.join(out, "model.png"), "rb").read())
    np.testing.assert_array_equal(tex, geotiff.read_geotiff(os.path.join(out, "ortho.tif"))[0][..., :3])
