"""Parity of the port's spatial selection (opencalibration_tpu_torch.ops.spatial)
and image loading (opencalibration_tpu_torch.extract.image_loader) with the
JAX package.

Tolerances: none. ``spatial_subsample``, ``nms_radius`` and
``top_k_by_strength`` are bit-exact on random and on tied inputs; Netpbm
decoding equals ``cv2.imread`` + ``cvtColor``; sparse masks and feature sets
equal the reference's on one extraction batch; loaded metadata equals the
reference loader's.
"""

import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencalibration_tpu.extract import image_loader as JL
from opencalibration_tpu.ops import spatial as JS
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.extract import image_loader as TL
from opencalibration_tpu_torch.ops import features as TF
from opencalibration_tpu_torch.ops import spatial as TS
from opencalibration_tpu_torch.testing import survey as TSv
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _features(kind, n=600, width=320.0, height=240.0, seed=0):
    """xy [n, 2] float32, strength [n] float32, valid [n]: uniform strengths,
    or strengths from 4 values with clustered positions (many ties in one
    cell and across the radius)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        xy = rng.uniform(0, [width, height], size=(n, 2))
        strength = rng.uniform(0, 1, size=n)
    else:
        xy = np.round(rng.uniform(0, [width, height], size=(n, 2)) / 3.0) * 3.0
        strength = rng.integers(1, 5, size=n) * 0.25
    valid = rng.random(n) < 0.9
    return xy.astype(np.float32), strength.astype(np.float32), valid


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_spatial_subsample_bit_exact(kind):
    xy, strength, valid = _features(kind)
    xy64 = xy.astype(np.float64)  # the link stage subsamples float64 pixels
    for spacing, ncx, ncy in ((8.0, 40, 30), (40.0, 8, 6), (11.0, 30, 22)):
        ref = np.asarray(JS.spatial_subsample(jnp.asarray(xy64), jnp.asarray(strength),
                                              jnp.asarray(valid), spacing, ncx, ncy))
        got = TS.spatial_subsample(torch.from_numpy(xy64), torch.from_numpy(strength),
                                   torch.from_numpy(valid), spacing, ncx, ncy)
        np.testing.assert_array_equal(got.numpy(), ref)
        assert ref.sum() > 10


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_nms_radius_bit_exact(kind):
    xy, strength, valid = _features(kind)
    ref = np.asarray(JS.nms_radius(jnp.asarray(xy), jnp.asarray(strength), jnp.asarray(valid), 8.0, 40, 30))
    got = TS.nms_radius(torch.from_numpy(xy), torch.from_numpy(strength), torch.from_numpy(valid), 8.0, 40, 30)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < valid.sum()


def test_spatial_ops_batched_equal_per_row():
    rows = [_features("random", seed=s) for s in range(3)]
    xy, strength, valid = (torch.from_numpy(np.stack(a)) for a in zip(*rows))
    batched = TS.nms_radius(xy, strength, valid, 8.0, 40, 30)
    sub = TS.spatial_subsample(xy.double(), strength, valid, 40.0, 8, 6)
    for i in range(3):
        np.testing.assert_array_equal(batched[i].numpy(),
                                      TS.nms_radius(xy[i], strength[i], valid[i], 8.0, 40, 30).numpy())
        np.testing.assert_array_equal(sub[i].numpy(),
                                      TS.spatial_subsample(xy[i].double(), strength[i], valid[i], 40.0, 8, 6).numpy())


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_top_k_by_strength_bit_exact(kind):
    _, strength, valid = _features(kind, n=200)
    for k in (5, 64, 199):
        ref_idx, ref_mask = JS.top_k_by_strength(jnp.asarray(strength), jnp.asarray(valid), k)
        idx, mask = TS.top_k_by_strength(torch.from_numpy(strength), torch.from_numpy(valid), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    # fewer valid features than k: the mask says which entries are real
    few = np.zeros(200, bool)
    few[[3, 7]] = True
    idx, mask = TS.top_k_by_strength(torch.from_numpy(strength), torch.from_numpy(few), 4)
    assert mask.tolist() == [True, True, False, False] and set(idx[:2].tolist()) == {3, 7}


def test_rgb_to_gray_equals_opencv_on_every_colour():
    cube = np.stack(np.meshgrid(*(np.arange(256),) * 3, indexing="ij"), -1).astype(np.uint8)
    rgb = cube.reshape(4096, 4096, 3)
    ref = cv2.cvtColor(np.ascontiguousarray(rgb[..., ::-1]), cv2.COLOR_BGR2GRAY)
    np.testing.assert_array_equal(TL.rgb_to_gray(rgb), ref)


@pytest.mark.parametrize("ext", ["pgm", "ppm"])
def test_netpbm_decode_equals_opencv(tmp_path, ext):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
    path = str(tmp_path / f"a.{ext}")
    cv2.imwrite(path, img if ext == "ppm" else img[..., 0].copy())
    ref = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2GRAY)
    got = TL.load_and_decode(path)
    np.testing.assert_array_equal(got.gray, ref)
    assert got.scale == 1.0
    np.testing.assert_array_equal(got.node.thumbnail, JL.load_and_decode(path).node.thumbnail)
    # a header comment, as other writers emit
    data = open(path, "rb").read()
    commented = data[:3] + b"# written by a test\n" + data[3:]
    np.testing.assert_array_equal(TL.decode_netpbm(commented), ref)
    assert TL.decode_netpbm(data[:-5]) is None  # truncated raster


def test_load_and_decode_matches_reference(tmp_path):
    """Gray image, scale and metadata (sidecar applied by the stage) equal
    the reference loader's on a survey PGM."""
    from opencalibration_tpu.pipeline.stages import _apply_sidecar_metadata as j_sidecar
    from opencalibration_tpu_torch.pipeline.stages import _apply_sidecar_metadata as t_sidecar

    paths, _, _ = TSv.write_survey(str(tmp_path), 1, 2, device="cpu")
    for path in paths:
        ref, got = JL.load_and_decode(path), TL.load_and_decode(path)
        np.testing.assert_array_equal(got.gray, ref.gray)
        assert got.scale == ref.scale
        j_sidecar(ref.node)
        t_sidecar(got.node)
        assert got.node.metadata == interop.image_node_from(ref.node).metadata
        assert got.node.metadata.has_gps() and got.node.metadata.focal_length_px == TSv.FOCAL


def test_unreadable_and_undecodable_files(tmp_path, monkeypatch):
    assert TL.load_and_decode(str(tmp_path / "missing.jpg")) is None
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(24, 32), dtype=np.uint8)
    jpg, pgm = str(tmp_path / "a.jpg"), str(tmp_path / "a.pgm")
    cv2.imwrite(jpg, img)
    TSv.write_pgm(pgm, img)
    assert TL.load_and_decode(jpg) is not None
    want = cv2.cvtColor(cv2.imread(jpg, cv2.IMREAD_COLOR), cv2.COLOR_BGR2GRAY)
    monkeypatch.setitem(sys.modules, "cv2", None)  # a machine without OpenCV
    monkeypatch.setitem(sys.modules, "PIL", None)
    # the JPEG decodes through the port's own codec, equal to cv2's decode
    np.testing.assert_array_equal(TL.load_and_decode(jpg).gray, want)
    np.testing.assert_array_equal(TL.load_and_decode(pgm).gray, img)
    tif = str(tmp_path / "a.tif")  # the formats left still need cv2
    with open(tif, "wb") as f:
        f.write(b"II*\x00" + bytes(16))
    with pytest.raises(ImportError, match="cv2"):
        TL.load_and_decode(tif)
    with open(str(tmp_path / "bad.jpg"), "wb") as f:
        f.write(b"\xff\xd8\xff\xe0\x00")  # truncated: unreadable, skipped
    assert TL.load_and_decode(str(tmp_path / "bad.jpg")) is None


def test_sparse_masks_and_feature_sets_match_reference():
    """One extraction batch of two images of different sizes, padded as the
    load stage pads them."""
    tex = TSv.make_texture(0)
    grays = [(tex[0:120, 0:160] * 255).astype(np.uint8), (tex[50:150, 40:170] * 255).astype(np.uint8)]
    batch, sizes = TL.pad_gray_batch(grays)
    out = TF.extract_features(torch.from_numpy(batch), max_features=256)
    out_np_ref = interop.features_to_numpy(out)
    ref_np, ref_masks = JL.batch_sparse_masks({k: jnp.asarray(v) for k, v in out_np_ref.items()}, sizes)
    got_np, got_masks = TL.batch_sparse_masks(out, sizes)
    np.testing.assert_array_equal(got_masks, ref_masks)
    assert set(got_np) == set(ref_np) and got_np["descriptors"].dtype == np.uint32
    for k in ref_np:
        np.testing.assert_array_equal(got_np[k], ref_np[k])
    assert 0 < got_masks.sum() < out_np_ref["valid"].sum()
    for i, scale in enumerate((1.0, 0.5)):
        ref = JL.features_from_device(ref_np, i, scale, sizes[i], 200, sparse_mask=ref_masks[i])
        got = TL.features_from_device(got_np, i, scale, sizes[i], 200, sparse_mask=got_masks[i])
        assert got == interop.feature_set_from(ref) and got.descriptors.dtype == np.uint32

