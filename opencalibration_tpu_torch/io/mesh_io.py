"""PLY mesh and XYZ point-cloud IO (a copy of
opencalibration_tpu/io/mesh_io.py that differs only in its imports).

Covers reference src/io/serialize_MeshGraph.cpp / deserialize_MeshGraph.cpp
(surface meshes as ascii PLY) and src/io/saveXYZ.cpp (point clouds as xyz
text with statistical outlier filtering)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from opencalibration_tpu_torch.surface.mesh import TriMesh


def save_ply(path: str, mesh: TriMesh):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {mesh.num_vertices}\n")
        f.write("property double x\nproperty double y\nproperty double z\n")
        f.write(f"element face {mesh.num_triangles}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for v in mesh.vertices:
            f.write(f"{v[0]:.10g} {v[1]:.10g} {v[2]:.10g}\n")
        for t in mesh.triangles:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def load_ply(path: str) -> TriMesh:
    with open(path) as f:
        lines = f.read().splitlines()
    n_vert = n_face = 0
    i = 0
    while i < len(lines):
        parts = lines[i].split()
        if parts[:2] == ["element", "vertex"]:
            n_vert = int(parts[2])
        elif parts[:2] == ["element", "face"]:
            n_face = int(parts[2])
        elif parts[:1] == ["end_header"]:
            i += 1
            break
        i += 1
    verts = np.array(
        [list(map(float, lines[i + k].split()[:3])) for k in range(n_vert)]
    )
    tris = np.array(
        [
            list(map(int, lines[i + n_vert + k].split()[1:4]))
            for k in range(n_face)
        ],
        np.int32,
    )
    return TriMesh(verts, tris)


def filter_outliers(points: np.ndarray, num_stddev: float = 3.0) -> np.ndarray:
    """Statistical z-filter like reference io/saveXYZ.hpp filterOutliers."""
    if len(points) < 3:
        return points
    z = points[:, 2]
    mu, sd = z.mean(), z.std()
    if sd == 0:
        return points
    keep = np.abs(z - mu) <= num_stddev * sd
    return points[keep]


def save_xyz(path: str, points: np.ndarray, filter_stddev: Optional[float] = None):
    if filter_stddev is not None:
        points = filter_outliers(points, filter_stddev)
    with open(path, "w") as f:
        for p in points:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def load_xyz(path: str) -> np.ndarray:
    pts = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                pts.append([float(parts[0]), float(parts[1]), float(parts[2])])
    return np.asarray(pts).reshape(-1, 3)
