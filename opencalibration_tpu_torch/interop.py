"""Carry state between the JAX package's containers and the port's.

Inputs are read through ``numpy.asarray``, so any array the JAX package holds
(numpy or device arrays) converts without this module importing JAX. Going
back, the functions return plain dicts of numpy arrays that the JAX
package's constructors take as keyword arguments, e.g.
``CameraModel(**camera_to_numpy(m))``.

Packed descriptors are uint32 on the JAX side and int32 bit patterns here;
the conversion is a reinterpretation of the same bits in both directions.
"""

from __future__ import annotations

import numpy as np
import torch

from opencalibration_tpu_torch.relax.tangent import FIELDS, RelaxParams
from opencalibration_tpu_torch.types.camera import LEAVES, CameraModel


def to_torch(x, device, dtype=None) -> torch.Tensor:
    """numpy-convertible array -> tensor; uint32 becomes int32 bit patterns."""
    a = np.array(x)  # a writable copy; keeps 0-d arrays 0-d
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(a).to(device)
    return t if dtype is None else t.to(dtype)


def to_numpy(t: torch.Tensor, uint32: bool = False) -> np.ndarray:
    """tensor -> numpy; ``uint32=True`` reinterprets int32 words as uint32."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if uint32 else a


def camera_from(model, device) -> CameraModel:
    """A JAX ``CameraModel`` (or anything with its attributes) -> the port's."""
    return CameraModel(**{k: to_torch(getattr(model, k), device) for k in LEAVES}, tag=model.tag)


def camera_to_numpy(model: CameraModel) -> dict:
    return dict({k: to_numpy(getattr(model, k)) for k in LEAVES}, tag=model.tag)


def relax_params_from(params, device) -> RelaxParams:
    """A JAX ``RelaxParams`` -> the port's."""
    return RelaxParams(**{f: to_torch(getattr(params, f), device) for f in FIELDS})


def relax_params_to_numpy(params: RelaxParams) -> dict:
    return {f: to_numpy(getattr(params, f)) for f in FIELDS}


def block_data_from(data: dict, device) -> dict:
    """A ``BlockSpec.data`` dict -> tensors; integer ids become int64, the
    index type torch wants."""
    out = {}
    for k, v in data.items():
        t = to_torch(v, device)
        out[k] = t.to(torch.int64) if t.dtype == torch.int32 else t
    return out


def block_data_to_numpy(data: dict) -> dict:
    return {k: to_numpy(v) for k, v in data.items()}


def features_from(feats: dict, device) -> dict:
    """An ``extract_features`` dict -> tensors (descriptors as int32 words)."""
    return {k: to_torch(v, device) for k, v in feats.items()}


def features_to_numpy(feats: dict) -> dict:
    """The port's feature dict -> numpy, descriptors back to uint32."""
    return {k: to_numpy(v, uint32=(k == "descriptors")) for k, v in feats.items()}
