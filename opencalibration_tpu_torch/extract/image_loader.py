"""Image decoding and the device half of batched feature extraction (twin of
opencalibration_tpu/extract/image_loader.py).

Decoding, on the host:

* 8-bit binary Netpbm files (``P5`` gray, ``P6`` RGB) are parsed with numpy,
  so a machine without OpenCV reads them. RGB becomes gray with OpenCV's own
  8-bit fixed-point ``BGR2GRAY`` weights, which gives the image that
  ``cv2.imread(..., IMREAD_COLOR)`` + ``cvtColor`` gives the reference.
* Every other format (JPEG) goes to ``cv2``, imported when needed. Without
  cv2 that raises ``ImportError``: ``None`` means an unreadable file, which
  the load stage skips, and a missing decoder is not one.
* Images longer than 1600 px are downscaled with cv2's ``INTER_AREA``, as
  the reference does; without cv2 they raise.
* The Lab thumbnail is not made (``node.thumbnail`` stays ``None``).

``pad_gray_batch``, ``camera_model_kwargs`` and ``DecodedImage`` are the JAX
package's own numpy code. ``batch_sparse_masks`` runs the radius NMS on the
device over a whole extraction batch and pulls the outputs to the host once;
``features_from_device`` turns one image's slice into a ``FeatureSet`` in
original pixel coordinates, with uint32 descriptors as the graph holds them.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional

import numpy as np
import torch

from opencalibration_tpu.extract.image_loader import (  # noqa: F401  (re-exported)
    MAX_LENGTH_PIXELS,
    NMS_PIXEL_RADIUS,
    DecodedImage,
    camera_model_kwargs,
    pad_gray_batch,
)
from opencalibration_tpu.extract.metadata import extract_metadata
from opencalibration_tpu.types.graph import FeatureSet, ImageNode
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.ops.spatial import nms_radius
from opencalibration_tpu_torch.utils.performance import PerformanceMeasure

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


def decode_netpbm(data: bytes) -> Optional[np.ndarray]:
    """Binary 8-bit PGM / PPM bytes -> [H, W] uint8 gray; None if the file is
    malformed or truncated."""
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
    if channels == 1:
        return raster.reshape(h, w).copy()
    return rgb_to_gray(raster.reshape(h, w, 3))


def _decode(path: str) -> Optional[np.ndarray]:
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if data[:2] in NETPBM_MAGIC:
        return decode_netpbm(data)
    cv2 = _cv2()
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None or img.size == 0:
        return None
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)


def load_and_decode(path: str) -> Optional[DecodedImage]:
    """Decode to gray, downscale to <= 1600 px, read metadata. Returns None
    for unreadable files (the load stage skips them)."""
    gray = _decode(path)
    if gray is None or gray.size == 0:
        return None
    node = ImageNode(path=path)
    h, w = gray.shape
    scale = min(1.0, MAX_LENGTH_PIXELS / max(h, w))
    if scale < 1.0:
        cv2 = _cv2()
        gray = cv2.resize(gray, (int(w * scale), int(h * scale)), interpolation=cv2.INTER_AREA)
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
