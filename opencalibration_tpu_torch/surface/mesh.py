"""Triangle surface mesh (host representation + builders).

Re-design of the reference's surface layer (reference src/surface/
expand_mesh.cpp: buildMinimalMesh :240-360, rebuildMesh grid construction
:17-160; mesh_graph.hpp). The reference stores the mesh as a
DirectedGraph with per-edge opposite-node bookkeeping because its walk-
based ray caster needs adjacency; the TPU build batches triangle tests
instead, so the primary representation is flat arrays:

  vertices [V, 3] float64, triangles [T, 3] int32

with adjacency (shared-edge pairs + border flags) derived once per build
for the smoothness priors. This maps directly to the relax blocks
(vert_idx gathers) and to batched ray-triangle kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

HEIGHT_MARGIN = 2.0  # reference expand_mesh.cpp:35,247


@dataclasses.dataclass
class TriMesh:
    vertices: np.ndarray  # [V, 3] float64
    triangles: np.ndarray  # [T, 3] int32

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, np.float64).reshape(-1, 3)
        self.triangles = np.asarray(self.triangles, np.int32).reshape(-1, 3)

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_triangles(self) -> int:
        return len(self.triangles)

    def copy(self) -> "TriMesh":
        return TriMesh(self.vertices.copy(), self.triangles.copy())

    def interior_edges(self):
        """Edges shared by two triangles: returns (edge_vi [E,2],
        opposite_vi [E,2]) for the smooth prior, plus border edge list."""
        edge_map: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        for t, tri in enumerate(self.triangles):
            for k in range(3):
                a, b = int(tri[k]), int(tri[(k + 1) % 3])
                c = int(tri[(k + 2) % 3])
                key = (min(a, b), max(a, b))
                edge_map.setdefault(key, []).append((t, c))
        interior, opposite, border = [], [], []
        for (a, b), tris in sorted(edge_map.items()):
            if len(tris) == 2:
                interior.append((a, b))
                opposite.append((tris[0][1], tris[1][1]))
            else:
                border.append((a, b))
        return (
            np.asarray(interior, np.int32).reshape(-1, 2),
            np.asarray(opposite, np.int32).reshape(-1, 2),
            np.asarray(border, np.int32).reshape(-1, 2),
        )

    def all_edges(self):
        """Unique undirected edges [E, 2] (for the flatness prior)."""
        e = np.concatenate(
            [self.triangles[:, [0, 1]], self.triangles[:, [1, 2]], self.triangles[:, [2, 0]]]
        )
        e = np.sort(e, axis=1)
        return np.unique(e, axis=0)

    def _triangle_bins(self, nbins: int = 64):
        """Uniform-grid spatial index: bin -> candidate triangle ids
        (cached). Replaces the warm-started walk searcher's locality
        (reference src/surface/intersect.cpp:10-170) for batched lookups
        without ever materializing an N x T test."""
        cache = getattr(self, "_bin_cache", None)
        if cache is not None and cache[0] == len(self.triangles):
            return cache[1]
        v = self.vertices[:, :2]
        tv = v[self.triangles]  # [T, 3, 2]
        lo = self.vertices[:, :2].min(axis=0)
        hi = self.vertices[:, :2].max(axis=0)
        span = np.maximum(hi - lo, 1e-9)
        tmin = tv.min(axis=1)
        tmax = tv.max(axis=1)
        bx0 = np.clip(((tmin[:, 0] - lo[0]) / span[0] * nbins).astype(int), 0, nbins - 1)
        bx1 = np.clip(((tmax[:, 0] - lo[0]) / span[0] * nbins).astype(int), 0, nbins - 1)
        by0 = np.clip(((tmin[:, 1] - lo[1]) / span[1] * nbins).astype(int), 0, nbins - 1)
        by1 = np.clip(((tmax[:, 1] - lo[1]) / span[1] * nbins).astype(int), 0, nbins - 1)
        bins = {}
        for t in range(len(self.triangles)):
            for bx in range(bx0[t], bx1[t] + 1):
                for by in range(by0[t], by1[t] + 1):
                    bins.setdefault((bx, by), []).append(t)
        index = (lo, span, nbins, {k: np.asarray(v_, np.int64) for k, v_ in bins.items()})
        self._bin_cache = (len(self.triangles), index)
        return index

    def find_triangles(self, xy: np.ndarray) -> np.ndarray:
        """2d point-in-triangle lookup: [N, 2] -> [N] triangle index or -1.

        Points are grouped by spatial bin; each bin tests only its few
        candidate triangles (bounded memory regardless of mesh size)."""
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        n = len(xy)
        out = np.full(n, -1, np.int64)
        if n == 0 or self.num_triangles == 0:
            return out
        lo, span, nbins, bins = self._triangle_bins()
        v = self.vertices[:, :2]

        px = np.clip(((xy[:, 0] - lo[0]) / span[0] * nbins).astype(int), 0, nbins - 1)
        py = np.clip(((xy[:, 1] - lo[1]) / span[1] * nbins).astype(int), 0, nbins - 1)
        bin_id = px * nbins + py
        order = np.argsort(bin_id, kind="stable")
        sorted_bins = bin_id[order]
        boundaries = np.flatnonzero(np.diff(sorted_bins)) + 1
        groups = np.split(order, boundaries)

        for grp in groups:
            if len(grp) == 0:
                continue
            key = (int(px[grp[0]]), int(py[grp[0]]))
            cand = bins.get(key)
            if cand is None or len(cand) == 0:
                continue
            tri = self.triangles[cand]
            a = v[tri[:, 0]]
            b = v[tri[:, 1]]
            c = v[tri[:, 2]]
            p = xy[grp]

            def cross(o, d):
                return (d[None, :, 0] - o[None, :, 0]) * (
                    p[:, None, 1] - o[None, :, 1]
                ) - (d[None, :, 1] - o[None, :, 1]) * (p[:, None, 0] - o[None, :, 0])

            d1 = cross(a, b)
            d2 = cross(b, c)
            d3 = cross(c, a)
            neg = (d1 < 0) | (d2 < 0) | (d3 < 0)
            pos = (d1 > 0) | (d2 > 0) | (d3 > 0)
            inside = ~(neg & pos)  # [len(grp), len(cand)]
            idx = np.argmax(inside, axis=1)
            found = inside[np.arange(len(grp)), idx]
            out[grp] = np.where(found, cand[idx], -1)
        return out

    def interpolate_z(self, xy: np.ndarray) -> np.ndarray:
        """Barycentric z at 2d points (NaN outside the mesh)."""
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        ti = self.find_triangles(xy)
        out = np.full(len(xy), np.nan)
        ok = ti >= 0
        if ok.any():
            tri = self.triangles[ti[ok]]
            p0 = self.vertices[tri[:, 0]]
            p1 = self.vertices[tri[:, 1]]
            p2 = self.vertices[tri[:, 2]]
            v0 = (p1 - p0)[:, :2]
            v1 = (p2 - p0)[:, :2]
            v2 = xy[ok] - p0[:, :2]
            den = v0[:, 0] * v1[:, 1] - v1[:, 0] * v0[:, 1]
            den = np.where(np.abs(den) < 1e-30, 1e-30, den)
            w1 = (v2[:, 0] * v1[:, 1] - v1[:, 0] * v2[:, 1]) / den
            w2 = (v0[:, 0] * v2[:, 1] - v2[:, 0] * v0[:, 1]) / den
            w0 = 1.0 - w1 - w2
            out[ok] = w0 * p0[:, 2] + w1 * p1[:, 2] + w2 * p2[:, 2]
        return out


def _median_agl(camera_positions: np.ndarray, prior_z_points: Optional[np.ndarray]):
    """Median camera height above ground, filtered to (-500, 5000) like
    reference expand_mesh.cpp:78-85,284-287."""
    cams = np.asarray(camera_positions, np.float64)
    heights = []
    if prior_z_points is not None and len(prior_z_points):
        pts = np.asarray(prior_z_points, np.float64)
        for p in cams:
            d2 = np.sum((pts[:, :2] - p[:2]) ** 2, axis=1)
            agl = p[2] - pts[np.argmin(d2), 2]
            if -500 < agl < 5000:
                heights.append(agl)
    if not heights:
        # median nearest-camera spacing as fallback scale
        if len(cams) >= 2:
            d = np.sqrt(
                np.sum((cams[:, None, :2] - cams[None, :, :2]) ** 2, axis=-1)
            )
            np.fill_diagonal(d, np.inf)
            heights = [float(np.median(np.min(d, axis=1)))]
        else:
            heights = [10.0]
    return float(np.sort(heights)[len(heights) // 2])


def build_minimal_mesh(
    camera_positions: np.ndarray, prior_z_points: Optional[np.ndarray] = None
) -> Optional[TriMesh]:
    """4-vertex 2-triangle bounding mesh under the cameras
    (reference expand_mesh.cpp:240-360)."""
    cams = np.asarray(camera_positions, np.float64)
    if len(cams) < 2:
        return None
    median_agl = _median_agl(cams, prior_z_points)
    border = max(0.0, min(1000.0, median_agl * HEIGHT_MARGIN))
    lo = cams[:, :2].min(axis=0) - border
    hi = cams[:, :2].max(axis=0) + border
    z = float(np.median(cams[:, 2])) - median_agl
    vertices = np.array(
        [
            [lo[0], lo[1], z],
            [hi[0], lo[1], z],
            [hi[0], hi[1], z],
            [lo[0], hi[1], z],
        ]
    )
    triangles = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return TriMesh(vertices, triangles)


def build_grid_mesh(
    camera_positions: np.ndarray,
    prior_z_points: Optional[np.ndarray] = None,
    grid_distance: Optional[float] = None,
    max_cells: int = 1000,
) -> Optional[TriMesh]:
    """Regular grid mesh over the camera bbox, spacing = median 2-NN
    camera distance, border = 2x median height above ground, z seeded from
    the nearest prior point or camera height (reference rebuildMesh,
    expand_mesh.cpp:17-160)."""
    cams = np.asarray(camera_positions, np.float64)
    if len(cams) < 2:
        return None
    if grid_distance is None:
        d = np.sqrt(np.sum((cams[:, None, :2] - cams[None, :, :2]) ** 2, axis=-1))
        np.fill_diagonal(d, np.inf)
        grid_distance = float(np.median(np.min(d, axis=1)))
        if not np.isfinite(grid_distance) or grid_distance <= 0:
            grid_distance = 10.0
    median_agl = _median_agl(cams, prior_z_points)
    border = max(0.0, min(1000.0, median_agl * HEIGHT_MARGIN))
    lo = cams[:, :2].min(axis=0) - border
    hi = cams[:, :2].max(axis=0) + border
    cols = int(np.ceil((hi[0] - lo[0]) / grid_distance)) + 1
    rows = int(np.ceil((hi[1] - lo[1]) / grid_distance)) + 1
    if rows > max_cells or cols > max_cells:  # cap like expand_mesh.cpp:127-131
        rows = min(rows, max_cells)
        cols = min(cols, max_cells)
    xs = np.linspace(lo[0], hi[0], cols)
    ys = np.linspace(lo[1], hi[1], rows)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")

    if prior_z_points is not None and len(prior_z_points):
        pts = np.asarray(prior_z_points, np.float64)
        flat = np.stack([gx.ravel(), gy.ravel()], axis=1)
        d2 = np.sum((flat[:, None, :] - pts[None, :, :2]) ** 2, axis=-1)
        z = pts[np.argmin(d2, axis=1), 2]
    else:
        flat = np.stack([gx.ravel(), gy.ravel()], axis=1)
        d2 = np.sum((flat[:, None, :] - cams[None, :, :2]) ** 2, axis=-1)
        z = cams[np.argmin(d2, axis=1), 2] - median_agl
    vertices = np.concatenate([gx.ravel()[:, None], gy.ravel()[:, None], z[:, None]], axis=1)

    tris = []
    for r in range(rows - 1):
        for c in range(cols - 1):
            i00 = r * cols + c
            i01 = i00 + 1
            i10 = i00 + cols
            i11 = i10 + 1
            tris.append([i00, i01, i11])
            tris.append([i00, i11, i10])
    return TriMesh(vertices, np.asarray(tris, np.int32))


def merge_surface_clouds(surfaces):
    """Concatenate point clouds from several surface models
    (mergeSurfaceModels semantics for the cloud part)."""
    clouds = []
    for s in surfaces:
        clouds.extend(s.cloud)
    return clouds
