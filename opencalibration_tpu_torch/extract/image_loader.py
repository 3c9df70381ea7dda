"""Image decoding and the device half of batched feature extraction (twin of
opencalibration_tpu/extract/image_loader.py).

Decoding, on the host:

* 8-bit binary Netpbm files (``P5`` gray, ``P6`` RGB) are parsed with numpy,
  so a machine without OpenCV reads them. RGB becomes gray with OpenCV's own
  8-bit fixed-point ``BGR2GRAY`` weights, which gives the image that
  ``cv2.imread(..., IMREAD_COLOR)`` + ``cvtColor`` gives the reference.
* JPEG goes through the port's own codec (``io/jpeg.py``) on every host,
  cv2 installed or not; it equals ``cv2.imread(..., IMREAD_COLOR)``. PNG goes
  through ``io/png.py`` (16-bit samples keep their high byte and alpha is
  dropped, as ``IMREAD_COLOR`` does).
* Every other format (TIFF) goes to ``cv2``, imported when needed. Without
  cv2 that raises ``ImportError``: ``None`` means an unreadable file, which
  the load stage skips, and a missing decoder is not one.
* Images longer than 1600 px are downscaled with ``ops.color.resize_area``
  (OpenCV's ``INTER_AREA`` reproduced), as the reference does.
* Every node gets the reference's Lab thumbnail: the colour image through
  ``ops.color.bgr_to_lab_u8``, area-resized to about 50 px on its geometric
  mean side.
* ``decode_color`` gives the BGR image alone, for the orthomosaic's
  full-resolution image cache.

``pad_gray_batch``, ``camera_model_kwargs`` and ``DecodedImage`` are copies
of the JAX package's numpy code. ``batch_sparse_masks`` runs the radius NMS on the
device over a whole extraction batch and pulls the outputs to the host once;
``features_from_device`` turns one image's slice into a ``FeatureSet`` in
original pixel coordinates, with uint32 descriptors as the graph holds them.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional

import numpy as np
import torch

from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.extract.camera_database import CameraDatabase, apply_database_entry
from opencalibration_tpu_torch.extract.metadata import extract_metadata
from opencalibration_tpu_torch.io.jpeg import JPEG_MAGIC, decode_jpeg
from opencalibration_tpu_torch.io.png import SIGNATURE as PNG_SIGNATURE, decode_png
from opencalibration_tpu_torch.ops.color import bgr_to_lab_u8, resize_area
from opencalibration_tpu_torch.ops.spatial import nms_radius
from opencalibration_tpu_torch.types.graph import FeatureSet, ImageMetadata, ImageNode
from opencalibration_tpu_torch.utils.performance import PerformanceMeasure

MAX_LENGTH_PIXELS = 1600  # reference extract_features.cpp:14
THUMBNAIL_TARGET = 50.0  # reference extract_image.cpp:42-52
NMS_PIXEL_RADIUS = 8.0  # reference extract_features.cpp:15


@dataclasses.dataclass
class DecodedImage:
    """Host-side decode result, ready for batched device extraction."""

    node: ImageNode
    gray: np.ndarray  # [H, W] uint8, downscaled (device normalizes)
    scale: float  # original px = gray px / scale


def camera_model_kwargs(md: ImageMetadata, database: Optional[CameraDatabase] = None):
    """Initial camera model parameters with DB priors
    (reference extract_image.cpp:60-80)."""
    kw = dict(
        focal_length_pixels=md.focal_length_px,
        principal_point=(md.width_px / 2.0, md.height_px / 2.0),
        radial_distortion=(0.0, 0.0, 0.0),
        tangential_distortion=(0.0, 0.0),
        pixels_cols=float(md.width_px),
        pixels_rows=float(md.height_px),
    )
    db = database or CameraDatabase.instance()
    entry = db.lookup(md)
    if entry is not None:
        kw = apply_database_entry(entry, md, kw)
    return kw


def pad_gray_batch(grays: list, target_hw=None):
    """Stack variable-size grayscale arrays into one padded batch.

    Returns (batch [B, H, W] of the input dtype — uint8 from the decode
    path — and sizes [B, 2]). Padding is edge replication so the detector
    border suppression handles it.
    """
    if target_hw is None:
        H = max(g.shape[0] for g in grays)
        W = max(g.shape[1] for g in grays)
    else:
        H, W = target_hw
    out = np.zeros((len(grays), H, W), grays[0].dtype if grays else np.uint8)
    sizes = np.zeros((len(grays), 2), np.int32)
    for i, g in enumerate(grays):
        h, w = g.shape
        out[i, :h, :w] = g
        # edge-replicate padding
        if h < H:
            out[i, h:, :w] = g[-1:, :]
        if w < W:
            out[i, :, w:] = out[i, :, w - 1 : w]
        sizes[i] = (h, w)
    return out, sizes


NETPBM_MAGIC = (b"P5", b"P6")
# magic, width, height, maxval, each after whitespace or '#' comment lines,
# then exactly one whitespace byte before the raster
_NETPBM_HEADER = re.compile(
    rb"P([56])(?:\s|#[^\n]*\n)+(\d+)(?:\s|#[^\n]*\n)+(\d+)(?:\s|#[^\n]*\n)+(\d+)\s"
)
# OpenCV's RGB -> gray for 8-bit images: 0.299 / 0.587 / 0.114 in 15-bit
# fixed point, rounded by adding half an LSB before the shift (equal to
# cvtColor on all 2^24 colours)
_GRAY_SHIFT = 15
_R2Y, _G2Y, _B2Y = 9798, 19235, 3735


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "decoding this image needs cv2 (OpenCV), which is not installed; "
            "binary PGM/PPM files decode without it"
        ) from e
    return cv2


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 RGB -> [H, W] uint8 gray, bit-exact with
    ``cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)``."""
    c = rgb.astype(np.int32)
    y = c[..., 0] * _R2Y + c[..., 1] * _G2Y + c[..., 2] * _B2Y
    return ((y + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT).astype(np.uint8)


def _netpbm_raster(data: bytes) -> Optional[np.ndarray]:
    """Binary 8-bit PGM / PPM bytes -> [H, W] gray or [H, W, 3] RGB uint8 (a
    view of ``data``); None if the file is malformed or truncated."""
    m = _NETPBM_HEADER.match(data)
    if m is None:
        return None
    kind, w, h, maxval = m.group(1), int(m.group(2)), int(m.group(3)), int(m.group(4))
    if maxval != 255:
        raise ValueError(f"only 8-bit Netpbm (maxval 255) is supported, got maxval {maxval}")
    channels = 1 if kind == b"5" else 3
    count = w * h * channels
    if w == 0 or h == 0 or len(data) - m.end() < count:
        return None
    raster = np.frombuffer(data, np.uint8, count=count, offset=m.end())
    return raster.reshape(h, w) if channels == 1 else raster.reshape(h, w, 3)


def decode_netpbm(data: bytes) -> Optional[np.ndarray]:
    """Binary 8-bit PGM / PPM bytes -> [H, W] uint8 gray; None if the file is
    malformed or truncated."""
    raster = _netpbm_raster(data)
    if raster is None:
        return None
    return raster.copy() if raster.ndim == 2 else rgb_to_gray(raster)


def _decode(path: str):
    """(gray, BGR) of an image file, or None for an unreadable one."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if data[:2] in NETPBM_MAGIC:
        raster = _netpbm_raster(data)
        if raster is None:
            return None
        if raster.ndim == 2:  # gray, replicated as cv2.imread(IMREAD_COLOR) does
            return raster.copy(), np.repeat(raster[..., None], 3, axis=2)
        return rgb_to_gray(raster), np.ascontiguousarray(raster[..., ::-1])
    if data[:2] == JPEG_MAGIC or data[:8] == PNG_SIGNATURE:
        img = decode_jpeg(data) if data[:2] == JPEG_MAGIC else decode_png(data)
        if img is None or img.size == 0:
            return None
        if img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
        if img.ndim == 2:  # gray, replicated as cv2.imread(IMREAD_COLOR) does
            return img, np.repeat(img[..., None], 3, axis=2)
        bgr = np.ascontiguousarray(img[..., :3])
        return rgb_to_gray(bgr[..., ::-1]), bgr
    cv2 = _cv2()
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None or img.size == 0:
        return None
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY), img


def decode_color(path: str) -> Optional[np.ndarray]:
    """[H, W, 3] uint8 BGR of an image file (PPM / PGM by numpy, JPEG and PNG
    by the port's codecs, every other format through cv2), or None for an
    unreadable one."""
    decoded = _decode(path)
    return None if decoded is None else decoded[1]


def lab_thumbnail(bgr: np.ndarray) -> np.ndarray:
    """The node's Lab thumbnail: about ``THUMBNAIL_TARGET`` px on the
    geometric mean of its sides (reference extract_image.cpp:42-52)."""
    h, w = bgr.shape[:2]
    tscale = THUMBNAIL_TARGET / math.sqrt(h * w)
    tw = max(1, int(round(w * tscale)))
    th = max(1, int(round(h * tscale)))
    return resize_area(bgr_to_lab_u8(bgr), (tw, th))


def load_and_decode(path: str) -> Optional[DecodedImage]:
    """Decode, thumbnail, downscale the gray to <= 1600 px, read metadata.
    Returns None for unreadable files (the load stage skips them)."""
    decoded = _decode(path)
    if decoded is None or decoded[0].size == 0:
        return None
    gray, bgr = decoded
    node = ImageNode(path=path)
    node.thumbnail = lab_thumbnail(bgr)
    h, w = gray.shape
    scale = min(1.0, MAX_LENGTH_PIXELS / max(h, w))
    if scale < 1.0:
        gray = resize_area(gray, (int(w * scale), int(h * scale)))
    node.metadata = extract_metadata(path)
    if node.metadata.width_px == 0:
        node.metadata.width_px = w
        node.metadata.height_px = h
    return DecodedImage(node=node, gray=gray, scale=scale)


def batch_sparse_masks(out: dict, sizes_hw):
    """Radius-NMS sparse masks for a whole extraction batch: one NMS call per
    distinct image size on the outputs' device, then one pull of outputs and
    masks to the host. ``out`` is ``extract_features``' dict of tensors.
    Returns (out_np with uint32 descriptors, masks [N, K] bool)."""
    by_cells: Dict[tuple, list] = {}
    for i, (h, w) in enumerate(sizes_hw):
        ncx = max(2, int(math.ceil(w / NMS_PIXEL_RADIUS)))
        ncy = max(2, int(math.ceil(h / NMS_PIXEL_RADIUS)))
        by_cells.setdefault((ncx, ncy), []).append(i)
    dev = out["xy"].device
    masks = torch.zeros(out["valid"].shape, dtype=torch.bool, device=dev)
    for (ncx, ncy), idxs in by_cells.items():
        sel = torch.tensor(idxs, device=dev)
        xy = out["xy"][sel]
        wv = torch.tensor([sizes_hw[i][1] for i in idxs], dtype=torch.float32, device=dev)
        hv = torch.tensor([sizes_hw[i][0] for i in idxs], dtype=torch.float32, device=dev)
        valid = out["valid"][sel] & (xy[..., 0] < wv[:, None]) & (xy[..., 1] < hv[:, None])
        masks[sel] = nms_radius(xy, out["strength"][sel], valid, NMS_PIXEL_RADIUS, ncx, ncy)
    with PerformanceMeasure("load: device_get outputs"):
        out_np = interop.features_to_numpy(out)
        masks_np = interop.to_numpy(masks)
    return out_np, masks_np


def features_from_device(out, index: int, scale: float, size_hw, max_keep: int, sparse_mask):
    """One image's slice of the host copy of a batched extraction -> a
    ``FeatureSet`` in original pixel coordinates: sparse (radius-NMS
    survivors, the image's row of ``batch_sparse_masks``) strongest first,
    then dense strongest first."""
    xy = np.asarray(out["xy"][index])
    strength = np.asarray(out["strength"][index])
    desc = np.asarray(out["descriptors"][index])
    valid = np.asarray(out["valid"][index])
    h, w = int(size_hw[0]), int(size_hw[1])
    valid = valid & (xy[:, 0] < w) & (xy[:, 1] < h)
    sparse_mask = np.asarray(sparse_mask)

    order = np.argsort(-np.where(valid & sparse_mask, strength, -np.inf), kind="stable")
    n_sparse = int((valid & sparse_mask).sum())
    dense_order = np.argsort(-np.where(valid & ~sparse_mask, strength, -np.inf), kind="stable")
    n_dense = int((valid & ~sparse_mask).sum())
    keep = np.concatenate([order[:n_sparse], dense_order[:n_dense]])[:max_keep]

    return FeatureSet(
        xy=(xy[keep] / scale).astype(np.float64),
        strength=strength[keep].astype(np.float32),
        descriptors=desc[keep],
        valid=np.ones(len(keep), bool),
        num_sparse=min(n_sparse, max_keep),
    )
