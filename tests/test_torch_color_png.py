"""The port's OpenCV stand-ins against OpenCV itself: 8-bit colour
conversions and area resize (opencalibration_tpu_torch.ops.color), the PNG
codec (opencalibration_tpu_torch.io.png), the loader's Lab thumbnail and the
graph serialiser's thumbnails across the two packages.

Tolerances (uint8 levels per channel): ``bgr_to_lab_u8`` and ``resize_area``
within 1 of cv2, ``lab_u8_to_bgr`` within 2 (1 on in-gamut input); each test
prints the share of exactly equal values, which is 1.0 with the OpenCV these
tests were written against except for reductions by a fractional factor
(float32 sums in another order). PNG round trips, thumbnails and serialised
graphs are exact.
"""

import sys

import cv2
import numpy as np
import pytest
import torch

from opencalibration_tpu.extract import image_loader as JL
from opencalibration_tpu.io import serialize as JS
from opencalibration_tpu.types import graph as JG
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.extract import image_loader as TL
from opencalibration_tpu_torch.io import serialize as TSer
from opencalibration_tpu_torch.io.png import decode_png, encode_png
from opencalibration_tpu_torch.ops import color as C
from opencalibration_tpu_torch.testing import survey as TS
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

LAB_LEVELS = 1
BGR_LEVELS = 2
BGR_LEVELS_IN_GAMUT = 1
RESIZE_LEVELS = 1


def _images():
    rng = np.random.default_rng(0)
    ramp = np.arange(256, dtype=np.uint8)
    gx, gy = np.meshgrid(ramp, ramp)
    return {
        "random": rng.integers(0, 256, (200, 300, 3), dtype=np.uint8),
        "gradients": np.stack([gx, gy, ((gx.astype(int) + gy) // 2).astype(np.uint8)], -1),
        "gray_axis": np.repeat(ramp[None, :, None], 3, axis=2),
        "corners": np.array([[[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0]]],
                            np.uint8),
    }


def _report(name, got, ref, levels):
    d = np.abs(got.astype(int) - ref.astype(int))
    print(f"{name}: exact share {float((d == 0).mean()):.6f}, max difference {d.max()}")
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert d.max() <= levels


@pytest.mark.parametrize("name", list(_images()))
def test_bgr_to_lab_against_opencv(name):
    img = _images()[name]
    _report(name, C.bgr_to_lab_u8(img), cv2.cvtColor(img, cv2.COLOR_BGR2Lab), LAB_LEVELS)


@pytest.mark.parametrize("name", list(_images()))
def test_lab_to_bgr_against_opencv(name):
    """Arbitrary Lab bytes (mostly out of gamut) within 2; Lab that came from
    a BGR image within 1. The tensor form equals the numpy form."""
    img = _images()[name]
    _report(name + " as Lab", C.lab_u8_to_bgr(img), cv2.cvtColor(img, cv2.COLOR_Lab2BGR), BGR_LEVELS)
    lab = cv2.cvtColor(img, cv2.COLOR_BGR2Lab)
    got = C.lab_u8_to_bgr(lab)
    _report(name + " in gamut", got, cv2.cvtColor(lab, cv2.COLOR_Lab2BGR), BGR_LEVELS_IN_GAMUT)
    np.testing.assert_array_equal(C.lab_u8_to_bgr(torch.from_numpy(lab)).numpy(), got)


@pytest.mark.parametrize("src_hw,channels,dst_wh", [
    ((1200, 1600), 3, (58, 43)),  # the thumbnail of a 1600 x 1200 image
    ((240, 320), 3, (58, 43)),  # and of the test surveys' images
    ((256, 256), 4, (64, 64)),  # the tile preview, integer factor 4
    ((128, 128), 4, (64, 64)),  # integer factor 2
    ((600, 800), 1, (400, 300)),  # integer factor 2, gray
    ((450, 600), 1, (400, 300)),  # fractional factor 1.5
    ((200, 256), 4, (64, 64)),  # fractional in one direction
    ((40, 256), 4, (64, 64)),  # an edge tile: one side grows
    ((37, 53), 3, (60, 42)),  # both sides grow
    ((64, 64), 4, (64, 64)),  # same size
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_resize_area_against_opencv(src_hw, channels, dst_wh):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, src_hw + (channels,), dtype=np.uint8)
    if channels == 1:
        img = img[..., 0]
    _report("resize", C.resize_area(img, dst_wh), cv2.resize(img, dst_wh, interpolation=cv2.INTER_AREA),
            RESIZE_LEVELS)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_round_trips_with_opencv(channels):
    """Each codec reads the other's bytes to the same array, channel order
    included, and the port's own round trip is exact."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (43, 58, channels), dtype=np.uint8)
    img = img[..., 0] if channels == 1 else img
    mine = encode_png(img)
    np.testing.assert_array_equal(decode_png(mine), img)
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(mine, np.uint8), cv2.IMREAD_UNCHANGED), img)
    ok, theirs = cv2.imencode(".png", img)
    assert ok
    np.testing.assert_array_equal(decode_png(theirs.tobytes()), img)


@pytest.mark.parametrize("strategy", ["default", "filtered", "huffman", "rle"])
def test_png_reads_every_filter_opencv_writes(strategy):
    """A smooth image, which libpng's adaptive row filters encode with Sub,
    Up, Average and Paeth rows; the reader is also held to a file made here
    with each filter type forced on every row."""
    import struct
    import zlib

    yy, xx = np.mgrid[0:48, 0:64]
    img = np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256, (xx + yy * 2) % 256, 255 - xx], -1).astype(np.uint8)
    flag = {"default": cv2.IMWRITE_PNG_STRATEGY_DEFAULT, "filtered": cv2.IMWRITE_PNG_STRATEGY_FILTERED,
            "huffman": cv2.IMWRITE_PNG_STRATEGY_HUFFMAN_ONLY, "rle": cv2.IMWRITE_PNG_STRATEGY_RLE}[strategy]
    for arr in (img, img[..., :3], img[..., 0]):
        ok, buf = cv2.imencode(".png", arr, [cv2.IMWRITE_PNG_STRATEGY, flag, cv2.IMWRITE_PNG_COMPRESSION, 9])
        assert ok
        np.testing.assert_array_equal(decode_png(buf.tobytes()), arr)

    # every filter type forced, encoded here by the PNG specification
    rgb = img[..., 2::-1].astype(np.int16)  # file order R, G, B
    h, w, c = rgb.shape
    flat = rgb.reshape(h, w * c)
    for ft in range(5):
        rows = []
        for y in range(h):
            cur = flat[y]
            up = flat[y - 1] if y else np.zeros_like(cur)
            left = np.concatenate([np.zeros(c, np.int16), cur[:-c]])
            upleft = np.concatenate([np.zeros(c, np.int16), up[:-c]])
            if ft == 0:
                pred = 0
            elif ft == 1:
                pred = left
            elif ft == 2:
                pred = up
            elif ft == 3:
                pred = (left + up) >> 1
            else:
                p = left + up - upleft
                pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
                pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
            rows.append(bytes([ft]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        chunk = lambda k, d: struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))  # noqa: E731
        data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))
        np.testing.assert_array_equal(decode_png(data), img[..., :3])
        np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED), img[..., :3])


def test_png_rejects_what_it_does_not_read():
    assert decode_png(b"not a png") is None
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="channels"):
        encode_png(np.zeros((2, 2, 2), np.uint8))
    ok, buf = cv2.imencode(".png", np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match="8-bit"):
        decode_png(buf.tobytes())


@pytest.fixture(scope="module")
def color_survey(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ppm"))
    return TS.write_survey(d, 1, 2, color=True, gains=TS.survey_gains(2), device="cpu")[0]


def test_loader_thumbnail_equals_reference(color_survey):
    """One colour image written as PPM: gray, scale and the Lab thumbnail of
    the reference's size, all equal to the reference loader's (cv2)."""
    for path in color_survey:
        ref, got = JL.load_and_decode(path), TL.load_and_decode(path)
        assert got.node.thumbnail.shape == ref.node.thumbnail.shape == (43, 58, 3)
        np.testing.assert_array_equal(got.node.thumbnail, ref.node.thumbnail)
        np.testing.assert_array_equal(got.gray, ref.gray)
        np.testing.assert_array_equal(TL.decode_color(path), cv2.imread(path, cv2.IMREAD_COLOR))
    assert TL.THUMBNAIL_TARGET == JL.THUMBNAIL_TARGET
    assert np.ptp(got.node.thumbnail[..., 1]) > 3  # the survey really is coloured


def test_large_image_is_area_resized_without_opencv(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (1350, 1800), dtype=np.uint8)
    path = str(tmp_path / "big.pgm")
    TS.write_pgm(path, img)
    ref = JL.load_and_decode(path)
    monkeypatch.setitem(sys.modules, "cv2", None)  # a machine without OpenCV
    got = TL.load_and_decode(path)
    assert got.scale == ref.scale and got.gray.shape == ref.gray.shape == (1200, 1600)
    _report("downscaled gray", got.gray, ref.gray, RESIZE_LEVELS)
    np.testing.assert_array_equal(got.node.thumbnail, ref.node.thumbnail)


def _graph_with_thumbnails(types, paths, loader):
    graph = types.MeasurementGraph()
    for i, path in enumerate(paths):
        node = loader.load_and_decode(path).node
        node.model_id = 0
        node.position = np.array([10.0 * i, 0.0, 50.0])
        graph.add_node(node)
    return graph


def test_graph_thumbnails_cross_the_packages(color_survey, monkeypatch):
    """A graph with thumbnails serialised by each package and read by the
    other; the port's side also with OpenCV blocked."""
    j_graph = _graph_with_thumbnails(JG, color_survey, JL)
    t_graph = interop.graph_from(j_graph)
    j_text = JS.serialize_graph(j_graph, {})
    from_j = TSer.deserialize_graph(j_text)[0]
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        t_text = TSer.serialize_graph(t_graph, {})
        again = TSer.deserialize_graph(t_text)[0]
    from_t = JS.deserialize_graph(t_text)[0]
    for (nid, node), (_, a), (_, b), (_, c) in zip(sorted(j_graph.nodes()), sorted(from_j.nodes()),
                                                   sorted(from_t.nodes()), sorted(again.nodes())):
        for other in (a, b, c):
            assert other.payload.thumbnail.dtype == np.uint8
            np.testing.assert_array_equal(other.payload.thumbnail, node.payload.thumbnail)
