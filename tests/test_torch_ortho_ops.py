"""The orthomosaic's device functions in the port against the JAX package's,
function by function, on numpy inputs made from a seed, in float32 on the
CPU: ``ortho/blending.py``, ``ortho/color_balance.py`` and the ``_*_kernel``
programs of ``ortho/ortho.py``.

Tolerances:
* blending functions: 5e-4 absolute on 0..255 data plus 2e-6 relative (a
  single convolution holds 1e-4; four pyramid levels of float32 sums add up,
  and the pull-push fill extrapolates random layers to values near 1500),
  2e-6 on the 0..1 blend weight;
* ``_irls_pcg``: parameters within 1e-3, cost within 1e-4 relative;
  ``solve_color_balance`` parameters within 1e-3 of the reference's and the
  injected +10 L offset recovered as the reference's own test asks;
  ``apply_correction`` exact (numpy on both sides);
* ``_sample_cameras_kernel``: pixel weights within 1e-6, geometry within 1e-5,
  colours within 2e-3 with one tap and with nine (the two packages' float32
  projections differ in the last bits, which a bilinear sample of 8-bit data
  scales by up to 255 per pixel);
* ``_sample_select_kernel``: the same selection wherever the kept weights are
  distinct in float32, and float16 outputs within one float16 step
  (0.125 for colours, 1e-3 for weights and geometry);
* ``_corr_sample_kernel``: exactly the reference's samples on identical
  float16 inputs;
* ``_correct_blend_kernel``: Lab bytes at least 99.9 % equal, none further
  than 1 level; alpha equal;
* ``_sample_knn_kernel``: colours within 2e-3, weights within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.ortho import blending as JB
from opencalibration_tpu.ortho import color_balance as JCB
from opencalibration_tpu.ortho import ortho as JO
from opencalibration_tpu.types.camera import CameraModel as JCameraModel
from opencalibration_tpu.types.camera import stack_cameras as j_stack
from opencalibration_tpu_torch.ortho import blending as TB
from opencalibration_tpu_torch.ortho import color_balance as TCB
from opencalibration_tpu_torch.ortho import ortho as TO
from opencalibration_tpu_torch.types.camera import CameraModel as TCameraModel
from opencalibration_tpu_torch.types.camera import stack_cameras as t_stack
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

BLEND_ABS = 5e-4
BLEND_REL = 2e-6
CONV_ABS = 1e-4
WEIGHT_ABS = 2e-6
PARAM_ABS = 1e-3
COLOR_ABS = 2e-3
PIXEL_WEIGHT_ABS = 1e-6
GEOM_ABS = 1e-5

t = torch.from_numpy


def _layers(seed, n=3, h=40, w=56):
    rng = np.random.default_rng(seed)
    colors = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    weights = rng.uniform(0, 1, (n, h, w, 1)).astype(np.float32)
    weights[:, 10:25, 20:45] = 0.0  # a hole in every layer
    weights[0, :, :8] = 0.0
    return colors, weights


def test_compute_blend_weight():
    rng = np.random.default_rng(0)
    x = rng.uniform(-5, 325, 4000).astype(np.float32)
    y = rng.uniform(-5, 245, 4000).astype(np.float32)
    d = rng.uniform(0, 3, 4000).astype(np.float32)
    ref = np.asarray(JB.compute_blend_weight(jnp.asarray(x), jnp.asarray(y), 320.0, 240.0, jnp.asarray(d)))
    got = TB.compute_blend_weight(t(x), t(y), torch.tensor(320.0), torch.tensor(240.0), t(d)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=WEIGHT_ABS)


@pytest.mark.parametrize("shape", [(2, 40, 56, 3), (1, 33, 17, 1)], ids=str)
def test_sep_conv_and_pyramid_steps(shape):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    k = np.asarray(TB._GAUSS5, np.float32)
    np.testing.assert_allclose(TB._sep_conv(t(img), TB._GAUSS5).numpy(),
                               np.asarray(JB._sep_conv(jnp.asarray(img), jnp.asarray(k))), rtol=0, atol=CONV_ABS)
    down_ref = np.asarray(JB.pyr_down(jnp.asarray(img)))
    down = TB.pyr_down(t(img)).numpy()
    assert down.shape == down_ref.shape == (shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2, shape[3])
    np.testing.assert_allclose(down, down_ref, rtol=0, atol=CONV_ABS)
    up_ref = np.asarray(JB.pyr_up(jnp.asarray(down_ref), shape[1:3]))
    up = TB.pyr_up(t(down_ref), shape[1:3]).numpy()
    assert up.shape == up_ref.shape == shape
    np.testing.assert_allclose(up, up_ref, rtol=0, atol=CONV_ABS)


@pytest.mark.parametrize("hw,max_levels", [((256, 256), None), ((64, 64), 4), ((40, 56), None), ((3, 200), None),
                                           ((256, 256), 4)])
def test_num_levels(hw, max_levels):
    assert TB._num_levels(*hw, max_levels) == JB._num_levels(*hw, max_levels)


def test_pull_push_fill():
    colors, weights = _layers(2)
    ref = np.asarray(JB.pull_push_fill(jnp.asarray(colors), jnp.asarray(weights)))
    got = TB.pull_push_fill(t(colors), t(weights)).numpy()
    np.testing.assert_allclose(got, ref, rtol=BLEND_REL, atol=BLEND_ABS)
    assert np.isfinite(got).all() and got[1, 15, 30].min() > 0  # the hole is filled


@pytest.mark.parametrize("levels", [1, 3, 4])
def test_laplacian_blend(levels):
    colors, weights = _layers(3)
    ref = np.asarray(JB.laplacian_blend(jnp.asarray(colors), jnp.asarray(weights), levels=levels))
    got = TB.laplacian_blend(t(colors), t(weights), levels=levels).numpy()
    assert got.shape == ref.shape == colors.shape[1:]
    np.testing.assert_allclose(got, ref, rtol=BLEND_REL, atol=BLEND_ABS)


def test_sigmoid_transition_weight():
    rng = np.random.default_rng(4)
    raw = rng.uniform(0, 1, (5, 500)).astype(np.float32)
    ref = np.asarray(JB.sigmoid_transition_weight(jnp.asarray(raw), jnp.asarray(raw[:1]), 0.05))
    got = TB.sigmoid_transition_weight(t(raw), t(raw[:1]), 0.05).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=WEIGHT_ABS)


# --- colour balance ----------------------------------------------------------

def _offset_correspondences(cls, cameras=4, per_pair=60, seed=0):
    """Camera i is 10 * i L brighter than camera 0, a = b unchanged, with
    seeded radiometric geometry; a few outliers for the Huber weights."""
    rng = np.random.default_rng(seed)
    out = []
    for a in range(cameras):
        for b in range(a + 1, cameras):
            for _ in range(per_pair):
                base = rng.uniform(80, 120, 3)
                shift = np.array([10.0 * (b - a), 0.0, 0.0])
                if rng.random() < 0.05:
                    shift = shift + rng.uniform(-40, 40, 3)
                g = rng.uniform(0, 1, 8)
                out.append(cls(
                    camera_id_a=a, camera_id_b=b, model_id_a=0, model_id_b=0, lab_a=base, lab_b=base + shift,
                    normalized_radius_a=g[0], normalized_radius_b=g[1], view_angle_a=0.3 * g[2],
                    view_angle_b=0.3 * g[3], normalized_x_a=g[4] - 0.5, normalized_y_a=g[5] - 0.5,
                    normalized_x_b=g[6] - 0.5, normalized_y_b=g[7] - 0.5,
                ))
    return out


def test_irls_pcg():
    rng = np.random.default_rng(5)
    T, R, n_data = 30, 400, 360
    cols = rng.integers(0, T, (R, 14))
    vals = rng.normal(size=(R, 14)).astype(np.float32)
    vals[:, 6:] = 0.0  # compact rows: most slots empty
    rhs = rng.normal(size=R).astype(np.float32) * 4
    rhs[:20] += 60.0  # outliers
    p_ref, c_ref = JCB._irls_pcg(jnp.asarray(cols, jnp.int32), jnp.asarray(vals), jnp.asarray(rhs),
                                 T=T, n_data=n_data, iters=5)
    p, c = TCB._irls_pcg(t(cols), t(vals), t(rhs), T=T, n_data=n_data, iters=5)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=0, atol=PARAM_ABS)
    assert float(c) == pytest.approx(float(c_ref), rel=1e-4)
    again, _ = TCB._irls_pcg(t(cols), t(vals), t(rhs), T=T, n_data=n_data, iters=5)
    assert torch.equal(p, again)  # the sorted segment sums are reproducible


def test_solve_color_balance_recovery_and_parity():
    positions = {i: np.array([10.0 * i, 3.0 * (i % 2)]) for i in range(4)}
    ref = JCB.solve_color_balance(_offset_correspondences(JCB.ColorCorrespondence), positions)
    got = TCB.solve_color_balance(_offset_correspondences(TCB.ColorCorrespondence), positions, device="cpu")
    assert ref.success and got.success
    assert got.final_cost == pytest.approx(ref.final_cost, rel=1e-4)
    for cid, r in ref.per_image_params.items():
        g = got.per_image_params[cid]
        np.testing.assert_allclose(g.lab_offset, r.lab_offset, rtol=0, atol=PARAM_ABS)
        assert abs(g.brdf_coeff - r.brdf_coeff) < PARAM_ABS
        np.testing.assert_allclose(g.slope, r.slope, rtol=0, atol=PARAM_ABS)
    np.testing.assert_allclose(got.per_model_vignetting[0], ref.per_model_vignetting[0], rtol=0, atol=PARAM_ABS)
    assert not TCB.solve_color_balance([], device="cpu").success

    # the reference's own recovery case: camera 1 is +10 L brighter than camera 0
    rng = np.random.default_rng(0)
    corrs = []
    for _ in range(60):
        base = rng.uniform(80, 120, 3)
        corrs.append(TCB.ColorCorrespondence(
            camera_id_a=0, camera_id_b=1, model_id_a=0, model_id_b=0, lab_a=base,
            lab_b=base + np.array([10.0, 0, 0]), normalized_radius_a=0.3, normalized_radius_b=0.3,
            view_angle_a=0.1, view_angle_b=0.1, normalized_x_a=0.0, normalized_y_a=0.0,
            normalized_x_b=0.0, normalized_y_b=0.0))
    res = TCB.solve_color_balance(corrs, {0: np.array([0.0, 0]), 1: np.array([10.0, 0])}, device="cpu")
    l0, l1 = res.per_image_params[0].lab_offset[0], res.per_image_params[1].lab_offset[0]
    assert abs((l1 - l0) - 10.0) < 1.0 and abs(l0 + l1) < 2.0


def test_apply_correction():
    rng = np.random.default_rng(6)
    lab = rng.uniform(0, 255, (50, 3))
    r, theta, nx, ny = rng.uniform(0, 1, (4, 50))
    vig = rng.normal(size=3)
    kw = dict(lab_offset=rng.normal(size=3), brdf_coeff=0.7, slope=rng.normal(size=2))
    ref = JCB.apply_correction(lab, JCB.RadiometricParams(**kw), vig, r, theta, nx, ny)
    got = TCB.apply_correction(lab, TCB.RadiometricParams(**kw), vig, r, theta, nx, ny)
    np.testing.assert_array_equal(got, ref)


# --- the tile programs -------------------------------------------------------

K, P_SIDE, H, W = 6, 32, 60, 80


@pytest.fixture(scope="module")
def tile():
    """One seeded tile: K cameras near nadir over a 32 x 32 pixel grid with
    relief, 8-bit Lab images of 80 x 60 (one camera a padded slot, one invalid),
    distorted camera models."""
    rng = np.random.default_rng(7)
    gsd = 0.4
    gx, gy = np.meshgrid(20.0 + gsd * np.arange(P_SIDE), 30.0 - gsd * np.arange(P_SIDE))
    z = 1.5 * np.sin(gx / 5.0) * np.cos(gy / 7.0)
    points = np.stack([gx.ravel(), gy.ravel(), z.ravel()], 1).astype(np.float32)
    down = np.array([0.0, 1.0, 0.0, 0.0])
    quats = down[None] + 0.03 * rng.normal(size=(K, 4))
    quats = (quats / np.linalg.norm(quats, axis=1, keepdims=True)).astype(np.float32)
    pos = np.stack([26.0 + rng.uniform(-6, 6, K), 24.0 + rng.uniform(-6, 6, K), 30.0 + rng.uniform(0, 8, K)], 1)
    pos = pos.astype(np.float32)
    images = rng.integers(0, 256, (K, H, W, 3), dtype=np.uint8)
    hw = np.array([[H, W]] * K, np.int32)
    hw[4] = (0, 0)
    valid = np.array([True] * K)
    valid[2] = valid[4] = False
    kw = dict(focal_length_pixels=70.0, principal_point=(W / 2 + 1.5, H / 2 - 2.0),
              radial_distortion=(-0.05, 0.01, 0.0), tangential_distortion=(1e-3, -5e-4),
              pixels_cols=float(W), pixels_rows=float(H))
    j_models = j_stack([JCameraModel.create(**kw).astype(jnp.float32)] * K)
    t_models = t_stack([TCameraModel.create(**kw, device="cpu")] * K)
    scale = np.ones(K, np.float32)
    common = dict(points=points, quats=quats, pos=pos, images=images, hw=hw, scale=scale, valid=valid,
                  elev=np.float32(32.0), gsd=np.float32(gsd))
    return common, j_models, t_models


def _j_args(c, jm):
    return (jnp.asarray(c["points"]), jnp.asarray(c["quats"]), jnp.asarray(c["pos"]), jm, jnp.asarray(c["images"]),
            jnp.asarray(c["hw"]), jnp.asarray(c["scale"]), jnp.asarray(c["valid"]), jnp.asarray(c["elev"]),
            jnp.asarray(c["gsd"]))


def _t_args(c, tm):
    return (t(c["points"]), t(c["quats"]), t(c["pos"]), tm, t(c["images"]), t(c["hw"]), t(c["scale"]),
            t(c["valid"]), torch.tensor(c["elev"]), torch.tensor(c["gsd"]))


@pytest.mark.parametrize("taps", [1, 3])
def test_sample_cameras_kernel(tile, taps):
    c, jm, tm = tile
    ref = [np.asarray(x) for x in JO._sample_cameras_kernel(*_j_args(c, jm), taps=taps)]
    got = [x.numpy() for x in TO._sample_cameras_kernel(*_t_args(c, tm), taps=taps)]
    assert [g.shape for g in got] == [r.shape for r in ref] == [(K, P_SIDE ** 2, 3), (K, P_SIDE ** 2),
                                                                 (K, P_SIDE ** 2, 4)]
    assert (ref[1] > 0).mean() > 0.3 and (ref[1][4] == 0).all() and (ref[1][2] == 0).all()
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=PIXEL_WEIGHT_ABS)
    np.testing.assert_array_equal(got[1] > 0, ref[1] > 0)
    seen = ref[1] > 0
    np.testing.assert_allclose(got[0][seen], ref[0][seen], rtol=0, atol=COLOR_ABS)
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=GEOM_ABS)


@pytest.fixture(scope="module")
def selected(tile):
    c, jm, tm = tile
    ref = [np.asarray(x) for x in JO._sample_select_kernel(*_j_args(c, jm), taps=3, kmax=5)]
    got = [x.numpy() for x in TO._sample_select_kernel(*_t_args(c, tm), taps=3, kmax=5)]
    return ref, got


def test_sample_select_kernel(tile, selected):
    ref, got = selected
    assert [g.dtype for g in got] == [r.dtype for r in ref] == [np.float16, np.float16, np.float16, np.uint8]
    assert [g.shape for g in got] == [r.shape for r in ref]
    np.testing.assert_allclose(got[1].astype(np.float32), ref[1].astype(np.float32), rtol=0, atol=1e-3)
    # the selection is the reference's wherever float32 weights leave no tie
    # to break differently; zero weights tie, and keep their slot order
    c, jm, _ = tile
    w32 = np.asarray(JO._sample_cameras_kernel(*_j_args(c, jm), taps=3)[1])
    top = -np.sort(-w32, axis=0)[:6]
    distinct = (np.diff(top, axis=0) < -1e-6) | ((top[:-1] == 0) & (top[1:] == 0))
    clear = distinct.all(axis=0)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[3][:, clear], ref[3][:, clear])
    same = (got[3] == ref[3])
    np.testing.assert_allclose(got[0].astype(np.float32)[same], ref[0].astype(np.float32)[same], rtol=0, atol=0.125)
    np.testing.assert_allclose(got[2].astype(np.float32)[same], ref[2].astype(np.float32)[same], rtol=0, atol=1e-3)
    # padded and invalid slots: among zero weights the lowest slot comes first
    zero = ref[1].astype(np.float32) == 0
    assert zero.any()
    np.testing.assert_array_equal(got[3][zero & same], ref[3][zero & same])


def test_corr_sample_kernel(selected):
    ref_layers, _ = selected  # identical float16 inputs to both
    lc, lw, lg, sel = ref_layers
    rng = np.random.default_rng(8)
    cam_ids = rng.permutation(20)[:K].astype(np.int32)
    valid_z = rng.random(P_SIDE ** 2) > 0.1
    stride, s_max = 7, P_SIDE ** 2 // 7 + 1
    ref = JO._corr_sample_kernel(jnp.asarray(lc), jnp.asarray(lw), jnp.asarray(lg), jnp.asarray(sel),
                                 jnp.asarray(cam_ids), jnp.asarray(valid_z), stride=stride, s_max=s_max)
    got = TO._corr_sample_kernel(t(lc), t(lw), t(lg), t(sel), t(cam_ids).long(), t(valid_z), stride=stride,
                                 s_max=s_max)
    valid = np.asarray(ref["valid"])
    assert valid.sum() > 20
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    for k in ("cam_a", "cam_b", "lab_a", "lab_b", "geom_a", "geom_b"):
        np.testing.assert_array_equal(got[k].numpy()[valid], np.asarray(ref[k])[valid], err_msg=k)


def test_correct_blend_and_render_blend_kernels(selected):
    ref_layers, _ = selected
    lc, lw, lg, sel = ref_layers
    rng = np.random.default_rng(9)
    n = 20
    cam_ids = rng.permutation(n)[:K].astype(np.int32)
    valid_z = rng.random(P_SIDE ** 2) > 0.05
    off = rng.normal(size=(n, 3)).astype(np.float32) * 3
    brdf = rng.normal(size=n).astype(np.float32)
    slope = rng.normal(size=(n, 2)).astype(np.float32)
    vig = rng.normal(size=(n, 3)).astype(np.float32) * 2
    ref = JO._render_blend_kernel(
        jnp.asarray(lc), jnp.asarray(lw), jnp.asarray(lg), jnp.asarray(sel), jnp.asarray(cam_ids),
        jnp.asarray(valid_z), jnp.asarray(off), jnp.asarray(brdf), jnp.asarray(slope), jnp.asarray(vig),
        jnp.asarray(0.05, jnp.float32), ts=P_SIDE, levels=4)
    got = TO._render_blend_kernel(
        t(lc), t(lw), t(lg), t(sel), t(cam_ids).long(), t(valid_z), t(off), t(brdf), t(slope), t(vig),
        torch.tensor(0.05), ts=P_SIDE, levels=4)
    lab_ref, lab = np.asarray(ref[0]), got[0].numpy()
    assert lab.dtype == lab_ref.dtype == np.uint8 and lab.shape == lab_ref.shape == (P_SIDE, P_SIDE, 3)
    d = np.abs(lab.astype(int) - lab_ref.astype(int))
    print(f"blended Lab bytes equal {float((d == 0).mean()):.5f}, max difference {d.max()}")
    assert (d == 0).mean() >= 0.999 and d.max() <= 1
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_sample_knn_kernel(tile):
    c, jm, tm = tile
    rng = np.random.default_rng(10)
    knn = np.stack([rng.permutation(K)[:5] for _ in range(P_SIDE ** 2)]).astype(np.int32)
    thumbs = c["images"].astype(np.float32)
    ref = JO._sample_knn_kernel(jnp.asarray(c["points"]), jnp.asarray(knn), jnp.asarray(c["quats"]),
                                jnp.asarray(c["pos"]), jm, jnp.asarray(thumbs), jnp.asarray(c["hw"]),
                                jnp.asarray(c["scale"]), jnp.asarray(c["elev"]))
    got = TO._sample_knn_kernel(t(c["points"]), t(knn).long(), t(c["quats"]), t(c["pos"]), tm, t(thumbs),
                                t(c["hw"]), t(c["scale"]), torch.tensor(c["elev"]))
    w_ref = np.asarray(ref[1])
    assert (w_ref > 0).mean() > 0.3
    np.testing.assert_allclose(got[1].numpy(), w_ref, rtol=0, atol=PIXEL_WEIGHT_ABS)
    seen = w_ref > 0
    np.testing.assert_allclose(got[0].numpy()[seen], np.asarray(ref[0])[seen], rtol=0, atol=COLOR_ABS)
