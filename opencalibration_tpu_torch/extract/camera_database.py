"""Camera intrinsics-prior database (camera_database.json v1 schema).

Re-implements reference src/extract/camera_database.cpp:227-483: a JSON
database of per-(make, model, lens, dims) intrinsics priors with a 3-tier
fuzzy lookup (exact incl. lens+dims -> make+model+dims -> make+model) and
write-back of optimized models. File format is byte-compatible with the
reference's data/camera_database.json (version 1).
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
from typing import List, Optional

import numpy as np

from opencalibration_tpu_torch.types.graph import ImageMetadata


@dataclasses.dataclass
class CameraDBEntry:
    make: str = ""
    model: str = ""
    lens_model: str = ""
    sensor_width_px: int = 0
    sensor_height_px: int = 0
    radial_distortion: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3)
    )
    tangential_distortion: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2)
    )
    principal_point_offset: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2)
    )
    focal_length_pixels: float = float("nan")
    notes: str = ""


def default_database_path() -> str:
    """Path of the bundled intrinsics-prior database
    (reference data/camera_database.json, v1 schema)."""
    import os

    return os.path.join(os.path.dirname(__file__), "..", "data", "camera_database.json")


class CameraDatabase:
    """Thread-safe singleton-style database (instantiable for tests)."""

    _instance: Optional["CameraDatabase"] = None

    def __init__(self):
        self._entries: List[CameraDBEntry] = []
        self._loaded = False
        self._lock = threading.Lock()

    @classmethod
    def instance(cls) -> "CameraDatabase":
        """Process-wide database, primed with the bundled priors file on
        first use (reference bundles data/camera_database.json and
        compiles its path in, CMakeLists.txt:106-109)."""
        if cls._instance is None:
            cls._instance = CameraDatabase()
            cls._instance.load(default_database_path())
        return cls._instance

    def load(self, path: str) -> bool:
        with self._lock:
            try:
                with open(path) as f:
                    data = json.load(f)
            except (OSError, json.JSONDecodeError):
                return False
            if data.get("version") != 1:
                return False
            self._entries = []
            for c in data.get("cameras", []):
                self._entries.append(
                    CameraDBEntry(
                        make=c.get("make", ""),
                        model=c.get("model", ""),
                        lens_model=c.get("lens_model", ""),
                        sensor_width_px=int(c.get("sensor_width_px", 0)),
                        sensor_height_px=int(c.get("sensor_height_px", 0)),
                        radial_distortion=np.asarray(
                            c.get("radial_distortion", [0, 0, 0]), float
                        ),
                        tangential_distortion=np.asarray(
                            c.get("tangential_distortion", [0, 0]), float
                        ),
                        principal_point_offset=np.asarray(
                            c.get("principal_point_offset", [0, 0]), float
                        ),
                        focal_length_pixels=float(
                            c.get("focal_length_pixels", float("nan"))
                        ),
                        notes=c.get("notes", ""),
                    )
                )
            self._loaded = True
            return True

    def save(self, path: str) -> bool:
        with self._lock:
            cameras = []
            for e in self._entries:
                d = dict(
                    make=e.make,
                    model=e.model,
                    lens_model=e.lens_model,
                    sensor_width_px=e.sensor_width_px,
                    sensor_height_px=e.sensor_height_px,
                    radial_distortion=list(map(float, e.radial_distortion)),
                    tangential_distortion=list(map(float, e.tangential_distortion)),
                    principal_point_offset=list(map(float, e.principal_point_offset)),
                )
                if not math.isnan(e.focal_length_pixels):
                    d["focal_length_pixels"] = e.focal_length_pixels
                if e.notes:
                    d["notes"] = e.notes
                cameras.append(d)
            try:
                with open(path, "w") as f:
                    json.dump({"version": 1, "cameras": cameras}, f, indent=2)
                return True
            except OSError:
                return False

    def lookup(self, md: ImageMetadata) -> Optional[CameraDBEntry]:
        """3-tier fuzzy lookup (reference camera_database.cpp:346-390)."""
        with self._lock:
            if not self._loaded:
                return None
            make = md.camera_make.lower()
            model = md.camera_model.lower()
            lens = md.lens_model.lower()
            # 1: exact incl. lens + dims
            for e in self._entries:
                if (
                    e.make.lower() == make
                    and e.model.lower() == model
                    and e.lens_model.lower() == lens
                    and e.sensor_width_px == md.width_px
                    and e.sensor_height_px == md.height_px
                ):
                    return e
            # 2: make + model + dims
            for e in self._entries:
                if (
                    e.make.lower() == make
                    and e.model.lower() == model
                    and e.sensor_width_px == md.width_px
                    and e.sensor_height_px == md.height_px
                ):
                    return e
            # 3: make + model only
            for e in self._entries:
                if e.make.lower() == make and e.model.lower() == model:
                    return e
            return None

    def add_or_update(self, entry: CameraDBEntry):
        with self._lock:
            for i, e in enumerate(self._entries):
                if (
                    e.make.lower() == entry.make.lower()
                    and e.model.lower() == entry.model.lower()
                    and e.lens_model.lower() == entry.lens_model.lower()
                    and e.sensor_width_px == entry.sensor_width_px
                    and e.sensor_height_px == entry.sensor_height_px
                ):
                    self._entries[i] = entry
                    return
            self._entries.append(entry)
            self._loaded = True


def apply_database_entry(entry: CameraDBEntry, md: ImageMetadata, model_kw: dict):
    """Apply a DB entry onto camera-model keyword args
    (reference camera_database.cpp:392-418): distortion + scaled principal
    point offset; focal only if EXIF gave none."""
    model_kw["radial_distortion"] = tuple(entry.radial_distortion)
    model_kw["tangential_distortion"] = tuple(entry.tangential_distortion)
    center = np.array([md.width_px / 2.0, md.height_px / 2.0])
    if (
        entry.sensor_width_px != md.width_px
        or entry.sensor_height_px != md.height_px
    ) and entry.sensor_width_px:
        scale = md.width_px / entry.sensor_width_px
        model_kw["principal_point"] = tuple(center + entry.principal_point_offset * scale)
    else:
        model_kw["principal_point"] = tuple(center + entry.principal_point_offset)
    current_focal = model_kw.get("focal_length_pixels", float("nan"))
    if not math.isnan(entry.focal_length_pixels) and (
        math.isnan(current_focal) or current_focal <= 0
    ):
        model_kw["focal_length_pixels"] = entry.focal_length_pixels
    return model_kw
