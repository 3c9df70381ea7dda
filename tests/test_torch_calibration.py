"""The port's calibration main path (opencalibration_tpu_torch.pipeline)
against ``bench.py::calibration_step`` of the JAX package, on the 2 x 3
synthetic survey at 320 x 240 with the bench's 1024 features and 2048
RANSAC hypotheses.

Stage by stage, each fed the reference's own upstream outputs, the results
are held tight (link: pose scores equal, quaternions and translations within
1e-4; relax: quaternions within 1e-4). The whole step, where the port
extracts its own keypoints, holds the relaxed cameras within 0.1 degrees of
the reference's. The JAX side runs in its float32 blur mode, restored after.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from opencalibration_tpu.ops import features as JF
from opencalibration_tpu.ops import quaternion as JQ
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.pipeline import calibration as TC
from opencalibration_tpu_torch.testing import survey as TS
from tests import synthetic_survey as JS
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

BENCH_FEATURES = 1024  # bench.calibration_step's extract_features(max_features=1024)
HYPOTHESES = 2048
STEP_DEG = 0.1


@pytest.fixture(scope="module", autouse=True)
def f32_blur():
    prior = JF._BLUR_PRECISION
    JF.set_blur_precision("f32")
    yield
    JF.set_blur_precision(prior)


@pytest.fixture(scope="module")
def scene():
    positions, quats = JS.camera_grid(2, 3, spacing=12.0)
    images = np.stack(JS.render_views(JS.make_texture(0), positions, quats)).astype(np.float32)
    pa, pb = TS.knn_pairs(positions)
    return images, positions, quats, pa, pb


@pytest.fixture(scope="module")
def jax_link(scene):
    """The reference's features and link outputs on the scene."""
    images, _, _, pa, pb = scene
    feats = JF.extract_features(jnp.asarray(images), max_features=BENCH_FEATURES)
    feats = {k: np.asarray(v) for k, v in feats.items()}
    rel = bench._link_all(jnp.asarray(feats["descriptors"]), jnp.asarray(feats["xy"]),
                          jnp.asarray(feats["valid"]), jnp.asarray(pa), jnp.asarray(pb))
    return feats, tuple(np.asarray(r) for r in rel)


def _deg(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.degrees(np.asarray(JQ.quat_angle(JQ.quat_multiply(a, JQ.quat_conjugate(b)))))


def test_survey_twin(scene):
    images, positions, quats, pa, pb = scene
    pos, q = TS.camera_grid(2, 3, spacing=12.0)
    np.testing.assert_array_equal(pos, positions)
    np.testing.assert_allclose(q, quats, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(TS.make_texture(0), JS.make_texture(0))
    got = TS.render_views(TS.make_texture(0), pos, q, device="cpu").numpy()
    np.testing.assert_allclose(got, images, rtol=0, atol=1e-5)
    # the bench's 24-image workload: 42 pairs from 3 nearest neighbours
    pos24, _ = TS.camera_grid(4, 6, spacing=12.0)
    pa24, pb24 = TS.knn_pairs(pos24)
    assert len(pa24) == 42 and (pa24 < pb24).all()


def test_link_on_reference_features(scene, jax_link):
    _, _, _, pa, pb = scene
    feats, (rq_ref, rt_ref, rs_ref) = jax_link
    t = interop.features_from(feats, "cpu")
    assert t["descriptors"].dtype == torch.int32
    for k, v in interop.features_to_numpy(t).items():
        np.testing.assert_array_equal(v, feats[k])
    uniforms = torch.from_numpy(np.asarray(jax.random.uniform(jax.random.PRNGKey(42), (HYPOTHESES, 4))))
    model = TC._model(JS.IMG_W, JS.IMG_H, JS.FOCAL, device="cpu")
    rq, rt, rs = TC._link_all(t["descriptors"], t["xy"], t["valid"], torch.as_tensor(pa), torch.as_tensor(pb),
                              model, HYPOTHESES, uniforms)
    np.testing.assert_array_equal(rs.numpy(), rs_ref)
    np.testing.assert_allclose(rq.numpy(), rq_ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(rt.numpy(), rt_ref, rtol=0, atol=1e-4)


def test_match_and_ransac_one_on_reference_features(scene, jax_link):
    """LinkStage's per-edge work, on one edge: matches bit-exact, then the
    same tolerances as the batched link."""
    from opencalibration_tpu.pipeline import stages as JSt
    from opencalibration_tpu.types.camera import CameraModel as JCamera
    from opencalibration_tpu_torch.pipeline import stages as TSt

    _, _, _, pa, pb = scene
    feats, _ = jax_link
    a, b = int(pa[0]), int(pb[0])
    jm = JCamera.create(JS.FOCAL, (JS.IMG_W / 2, JS.IMG_H / 2), pixels_cols=JS.IMG_W,
                        pixels_rows=JS.IMG_H, dtype=jnp.float32)
    args = [feats["descriptors"][a], feats["xy"][a], feats["valid"][a],
            feats["descriptors"][b], feats["xy"][b], feats["valid"][b]]
    ref = JSt._match_and_ransac_one(*(jnp.asarray(x) for x in args), jm, jm, num_hypotheses=HYPOTHESES)
    model = interop.camera_from(jm, "cpu")
    uniforms = torch.from_numpy(np.asarray(jax.random.uniform(jax.random.PRNGKey(42), (HYPOTHESES, 4))))
    got = TSt._match_and_ransac_one(*(interop.to_torch(x, "cpu") for x in args), model, model,
                                    num_hypotheses=HYPOTHESES, uniforms=uniforms)
    assert set(got) == set(ref)
    for k in ("idx2", "dist", "matched", "inliers", "pose_scores"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k in ("model", "score", "quats", "ts"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-4, err_msg=k)


def test_device_is_never_chosen_silently():
    from opencalibration_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_relax_on_reference_link(scene, jax_link):
    _, positions, quats, pa, pb = scene
    _, rel = jax_link
    ref = np.asarray(bench._relax_all(jnp.asarray(positions, jnp.float32), jnp.asarray(pa), jnp.asarray(pb),
                                      *(jnp.asarray(r) for r in rel)))
    got, info = TC._relax_all(torch.as_tensor(positions, dtype=torch.float32), torch.as_tensor(pa),
                              torch.as_tensor(pb), *(torch.from_numpy(r) for r in rel))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    assert int(info.iterations) <= TC.MAX_ITERATIONS


def test_calibration_step_matches_reference(scene):
    images, positions, quats, pa, pb = scene
    ref = np.asarray(bench.calibration_step(jnp.asarray(images), jnp.asarray(positions, jnp.float32),
                                            jnp.asarray(pa), jnp.asarray(pb)))
    got = TC.calibration_step(torch.from_numpy(images), torch.as_tensor(positions, dtype=torch.float32),
                              torch.as_tensor(pa), torch.as_tensor(pb), focal=JS.FOCAL,
                              max_features=BENCH_FEATURES, num_hypotheses=HYPOTHESES)
    assert got.shape == (6, 4) and torch.isfinite(got).all()
    diff = _deg(got.numpy(), ref)
    print(f"port vs reference: {np.round(diff, 5).tolist()} deg; "
          f"port vs truth: {np.round(_deg(got.numpy(), quats), 4).tolist()} deg")
    assert diff.max() < STEP_DEG


def test_uint8_images_accepted(scene):
    images, positions, _, pa, pb = scene
    u8 = torch.from_numpy(np.round(images * 255).astype(np.uint8))
    got = TC.calibration_step(u8, torch.as_tensor(positions, dtype=torch.float32), torch.as_tensor(pa),
                              torch.as_tensor(pb), focal=JS.FOCAL, max_features=256, num_hypotheses=256,
                              max_iterations=5)
    assert got.shape == (6, 4) and torch.isfinite(got).all()


def test_main_path_imports_no_jax():
    """The port may use the JAX package's host modules, which import no JAX;
    with ``import jax`` made to fail, every port module still imports."""
    code = (
        "import sys; sys.modules['jax'] = None; "
        "import opencalibration_tpu_torch.pipeline.calibration, "
        "opencalibration_tpu_torch.pipeline.pipeline, "
        "opencalibration_tpu_torch.ops.hamming_cuda, opencalibration_tpu_torch.testing.survey, "
        "opencalibration_tpu_torch.interop; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib') and sys.modules[m]]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
