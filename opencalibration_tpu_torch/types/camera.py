"""Camera model container (twin of opencalibration_tpu/types/camera.py).

A ``CameraModel`` holds tensors that may carry leading batch dimensions, so a
batch of cameras is one model with stacked leaves. ``tag`` says whether the
Brown coefficients distort a projected ray (FORWARD) or undistort a
normalised pixel (INVERSE).
"""

from __future__ import annotations

import dataclasses

import torch

FORWARD = "forward"
INVERSE = "inverse"

LEAVES = (
    "focal_length_pixels",
    "principal_point",
    "radial_distortion",
    "tangential_distortion",
    "pixels_cols",
    "pixels_rows",
)


@dataclasses.dataclass(frozen=True)
class CameraModel:
    """Pinhole camera with Brown radial (k1, k2, k3) + tangential (p1, p2)
    distortion. Leaves: focal [...], principal point [..., 2], radial
    [..., 3], tangential [..., 2], pixels_cols / pixels_rows [...]."""

    focal_length_pixels: torch.Tensor
    principal_point: torch.Tensor
    radial_distortion: torch.Tensor
    tangential_distortion: torch.Tensor
    pixels_cols: torch.Tensor
    pixels_rows: torch.Tensor
    tag: str = FORWARD

    @staticmethod
    def create(
        focal_length_pixels: float,
        principal_point=(0.0, 0.0),
        radial_distortion=(0.0, 0.0, 0.0),
        tangential_distortion=(0.0, 0.0),
        pixels_cols: float = 0.0,
        pixels_rows: float = 0.0,
        tag: str = FORWARD,
        dtype=torch.float32,
        *,
        device,
    ) -> "CameraModel":
        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return CameraModel(
            focal_length_pixels=t(focal_length_pixels),
            principal_point=t(principal_point),
            radial_distortion=t(radial_distortion),
            tangential_distortion=t(tangential_distortion),
            pixels_cols=t(pixels_cols),
            pixels_rows=t(pixels_rows),
            tag=tag,
        )

    @property
    def dtype(self):
        return self.focal_length_pixels.dtype

    def map(self, fn) -> "CameraModel":
        """Apply ``fn`` to every tensor leaf."""
        return dataclasses.replace(self, **{k: fn(getattr(self, k)) for k in LEAVES})

    def astype(self, dtype) -> "CameraModel":
        return self.map(lambda x: x.to(dtype))

    def with_tag(self, tag: str) -> "CameraModel":
        return dataclasses.replace(self, tag=tag)

    def replace(self, **kw) -> "CameraModel":
        return dataclasses.replace(self, **kw)

    def has_distortion(self):
        return torch.any(self.radial_distortion != 0) | torch.any(
            self.tangential_distortion != 0
        )


def stack_cameras(models: list[CameraModel]) -> CameraModel:
    """Stack N cameras into one model with a leading batch dim."""
    if not models:
        raise ValueError("need at least one camera")
    tag = models[0].tag
    if any(m.tag != tag for m in models):
        raise ValueError("cannot stack FORWARD and INVERSE cameras")
    return CameraModel(
        **{k: torch.stack([getattr(m, k) for m in models]) for k in LEAVES},
        tag=tag,
    )


def take_camera(models: CameraModel, i) -> CameraModel:
    """Select camera(s) ``i`` from a batched model (index on every leaf)."""
    return models.map(lambda x: x[i])
