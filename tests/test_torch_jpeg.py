"""The port's JPEG codec (opencalibration_tpu_torch/io/jpeg.py over
native/jpeg.cpp) against OpenCV's, on files OpenCV writes here.

The decoder equals ``cv2.imdecode`` bit for bit (``IMREAD_COLOR`` for
colour files, ``IMREAD_GRAYSCALE`` for gray ones) on baseline files at
quality 95 and 75 with 4:4:4, 4:2:2, 4:2:0 and 4:4:0 sampling, progressive
files, restart intervals, gray files, sizes that are no multiple of the MCU,
and EXIF orientations spliced into an APP1 segment. The encoder's bytes equal
``cv2.imencode(".jpg")``'s at its defaults. A process in which cv2 and PIL
cannot be imported decodes and encodes.
"""

import os
import struct
import subprocess
import sys
import textwrap

import cv2
import numpy as np
import pytest

from opencalibration_tpu_torch.io.jpeg import decode_jpeg, encode_jpeg
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZES = [(240, 320), (239, 317), (17, 5)]
SAMPLING = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
}
MODES = {"baseline": [], "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1], "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]}


def _image(h, w, seed=0):
    """Smooth colour structure with noise, so every coefficient band and the
    chroma edges carry signal."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 11.0 - c) for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def _encode(img, params):
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality", [95, 75])
def test_decoder_equals_opencv(quality, sampling, mode):
    for h, w in SIZES:
        img = _image(h, w)
        buf = _encode(img, [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                            SAMPLING[sampling]] + MODES[mode])
        np.testing.assert_array_equal(decode_jpeg(buf.tobytes()), cv2.imdecode(buf, cv2.IMREAD_COLOR),
                                      err_msg=f"{h}x{w}")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_gray_decoder_equals_opencv(mode):
    for h, w in SIZES:
        buf = _encode(_image(h, w)[..., 1], MODES[mode])
        got = decode_jpeg(buf.tobytes())
        assert got.ndim == 2
        np.testing.assert_array_equal(got, cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE), err_msg=f"{h}x{w}")


def _with_orientation(data: bytes, orientation: int, little_endian: bool) -> bytes:
    """``data`` with an APP1 Exif segment holding only the Orientation tag
    spliced in after SOI."""
    e = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


@pytest.mark.parametrize("orientation", [3, 6])
def test_exif_orientation_applied_as_opencv_applies_it(orientation):
    base = _encode(_image(37, 53), []).tobytes()
    for le in (True, False):
        data = _with_orientation(base, orientation, le)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        got = decode_jpeg(data)
        assert got.shape == want.shape == ((53, 37, 3) if orientation == 6 else (37, 53, 3))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality", [95, 75])
def test_encoder_bytes_equal_opencv(quality):
    for h, w in SIZES + [(100, 310), (3, 3)]:
        img = _image(h, w, seed=1)
        assert encode_jpeg(img, quality) == _encode(img, [cv2.IMWRITE_JPEG_QUALITY, quality]).tobytes(), (h, w)
        gray = img[..., 0]
        assert encode_jpeg(gray, quality) == _encode(gray, [cv2.IMWRITE_JPEG_QUALITY, quality]).tobytes(), (h, w)
    assert encode_jpeg(img) == _encode(img, []).tobytes()  # quality 95 by default, as cv2


def test_rejects_what_it_does_not_read():
    assert decode_jpeg(b"\xff\xd8\xff\xe0\x00") is None
    assert decode_jpeg(b"not a jpeg") is None
    data = bytearray(_encode(_image(16, 16), []).tobytes())
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = 0xC9  # arithmetic coding
    with pytest.raises(ValueError, match="not supported"):
        decode_jpeg(bytes(data))
    with pytest.raises(ValueError, match="uint8"):
        encode_jpeg(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="channels"):
        encode_jpeg(np.zeros((4, 4, 4), np.uint8))


def test_codec_without_opencv_or_pil(tmp_path):
    img = _image(239, 317)
    path = str(tmp_path / "a.jpg")
    cv2.imwrite(path, img)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["cv2"] = None
        sys.modules["PIL"] = None
        from opencalibration_tpu_torch.io.jpeg import decode_jpeg, encode_jpeg
        img = decode_jpeg(open({path!r}, "rb").read())
        open({str(tmp_path / "b.jpg")!r}, "wb").write(encode_jpeg(img))
        print(img.shape)
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root, timeout=300)
    assert r.returncode == 0, r.stderr
    decoded = cv2.imread(path, cv2.IMREAD_COLOR)
    assert r.stdout.strip() == str(decoded.shape)
    assert open(str(tmp_path / "b.jpg"), "rb").read() == cv2.imencode(".jpg", decoded)[1].tobytes()
