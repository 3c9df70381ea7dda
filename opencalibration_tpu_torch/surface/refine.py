"""Mesh refinement by point density + surface-model merging.

Implements the contract of reference src/surface/refine_mesh.cpp:
``refineByPointDensity`` (:827) with per-triangle point counts AND
point-to-plane distance variance (``countPointsPerTriangle`` /
``TrianglePointStats``, refine_mesh.hpp:163-180), newest-vertex bisection
with recursive conforming propagation (``refineTriangle`` /
``bisectEdge``, refine_mesh.hpp:102-133), the minimum-triangle-size
guard, predicate-driven refinement (``refineWhere`` / ``refineAtPoint``),
and the per-group surface merge (``mergeSurfaceModels``,
refine_mesh.hpp:196-207: vertex positions weighted by each group's point
count in adjacent triangles).

The statistics are batched numpy/bincount reductions over the TriMesh's
bin-indexed point-in-triangle lookup; the bisection itself is host-side
graph surgery (pointer-chasing, not TPU work — SURVEY section 7 step 5).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from opencalibration_tpu_torch.surface.mesh import TriMesh
from opencalibration_tpu_torch.types.graph import SurfaceModel

MAX_POINTS_PER_TRIANGLE = 20  # reference refine_mesh.hpp:190
MESH_REFINEMENT_MAX_ITERATIONS = 20  # reference pipeline.cpp:38
REFINE_MAX_DEPTH = 10  # reference refineTriangle maxDepth


def _edge_key(a: int, b: int) -> Tuple[int, int]:
    return (a, b) if a < b else (b, a)


def triangle_point_stats(mesh: TriMesh, points: np.ndarray):
    """Per-triangle (count, point-to-plane distance variance) — batched
    equivalent of reference countPointsPerTriangle (refine_mesh.cpp:713:
    counts plus ``distanceVariance`` of point distance to the triangle's
    plane)."""
    nt = mesh.num_triangles
    counts = np.zeros(nt, np.int64)
    variance = np.zeros(nt, np.float64)
    points = np.asarray(points, np.float64).reshape(-1, 3)
    if len(points) == 0 or nt == 0:
        return counts, variance
    ti = mesh.find_triangles(points[:, :2])
    sel = ti >= 0
    if not sel.any():
        return counts, variance
    idx = ti[sel]
    pts = points[sel]
    V = np.asarray(mesh.vertices, np.float64)
    T = np.asarray(mesh.triangles)
    p0 = V[T[:, 0]]
    n = np.cross(V[T[:, 1]] - p0, V[T[:, 2]] - p0)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    d = np.einsum("ij,ij->i", pts - p0[idx], n[idx])
    counts = np.bincount(idx, minlength=nt)
    s1 = np.bincount(idx, weights=d, minlength=nt)
    s2 = np.bincount(idx, weights=d * d, minlength=nt)
    nz = np.maximum(counts, 1)
    variance = s2 / nz - (s1 / nz) ** 2
    return counts, np.maximum(variance, 0.0)


def count_points_per_triangle(mesh: TriMesh, points: np.ndarray) -> np.ndarray:
    """Counts only (kept for callers that don't need the variance)."""
    return triangle_point_stats(mesh, points)[0]


class _EditableMesh:
    """Triangle soup with edge->triangle adjacency, supporting
    newest-vertex bisection (reference bisectEdge/refineTriangle,
    refine_mesh.cpp:195-/:smaller helpers). Triangles keep their winding;
    splits stay conforming because ALL triangles adjacent to a bisected
    edge split at that edge."""

    def __init__(self, vertices: np.ndarray, triangles: np.ndarray,
                 z_of_midpoint: Optional[Callable] = None):
        self.verts: List[np.ndarray] = [np.asarray(v, np.float64) for v in vertices]
        self.tris: Dict[int, Tuple[int, int, int]] = {}
        self.edge2tris: Dict[Tuple[int, int], Set[int]] = {}
        self._next = 0
        self._zfn = z_of_midpoint
        for t in np.asarray(triangles):
            self._add(tuple(int(x) for x in t))

    def _add(self, tri: Tuple[int, int, int]) -> int:
        tid = self._next
        self._next += 1
        self.tris[tid] = tri
        for k in range(3):
            self.edge2tris.setdefault(
                _edge_key(tri[k], tri[(k + 1) % 3]), set()
            ).add(tid)
        return tid

    def _remove(self, tid: int):
        tri = self.tris.pop(tid)
        for k in range(3):
            ek = _edge_key(tri[k], tri[(k + 1) % 3])
            s = self.edge2tris.get(ek)
            if s is not None:
                s.discard(tid)
                if not s:
                    del self.edge2tris[ek]

    def longest_edge(self, tid: int) -> Tuple[int, int]:
        a, b, c = self.tris[tid]
        best, best_len = None, -1.0
        for u, v in ((a, b), (b, c), (c, a)):
            ln = float(
                np.linalg.norm(self.verts[u][:2] - self.verts[v][:2])
            )
            ek = _edge_key(u, v)
            # deterministic tie-break by edge key
            if ln > best_len + 1e-12 or (
                abs(ln - best_len) <= 1e-12 and (best is None or ek < best)
            ):
                best, best_len = ek, ln
        return best

    def edge_length(self, ek: Tuple[int, int]) -> float:
        return float(np.linalg.norm(self.verts[ek[0]][:2] - self.verts[ek[1]][:2]))

    def max_edge(self, tid: int) -> float:
        return self.edge_length(self.longest_edge(tid))

    def bisect_edge(self, ek: Tuple[int, int]) -> int:
        """Split every triangle adjacent to ek at its midpoint (reference
        bisectEdge). Returns the number of triangles created (1 per
        adjacent triangle)."""
        a, b = ek
        mid = 0.5 * (self.verts[a] + self.verts[b])
        if self._zfn is not None:
            z = self._zfn(mid, self.verts[a], self.verts[b])
            if z is not None and np.isfinite(z):
                mid = mid.copy()
                mid[2] = z
        m = len(self.verts)
        self.verts.append(mid)
        created = 0
        for tid in list(self.edge2tris.get(ek, ())):
            tri = self.tris[tid]
            # rotate so the split edge is (tri[0], tri[1])
            for k in range(3):
                u, v, w = tri[k], tri[(k + 1) % 3], tri[(k + 2) % 3]
                if _edge_key(u, v) == ek:
                    self._remove(tid)
                    self._add((u, m, w))
                    self._add((m, v, w))
                    created += 1
                    break
        return created

    def refine_triangle(self, tid: int, depth: int = REFINE_MAX_DEPTH) -> int:
        """Newest-vertex bisection with conforming propagation (reference
        refineTriangle, refine_mesh.hpp:102-133): neighbours whose longest
        edge differs from the shared edge are recursively refined first."""
        if tid not in self.tris or depth <= 0:
            return 0
        created = 0
        e = self.longest_edge(tid)
        for _ in range(depth):
            nbrs = [t for t in self.edge2tris.get(e, ()) if t != tid]
            incompatible = [t for t in nbrs if self.longest_edge(t) != e]
            if not incompatible:
                break
            for t in incompatible:
                created += self.refine_triangle(t, depth - 1)
            if tid not in self.tris:  # split as a side effect
                return created
        created += self.bisect_edge(e)
        return created

    def to_trimesh(self) -> TriMesh:
        tris = sorted(self.tris.values())
        return TriMesh(
            np.asarray(self.verts), np.asarray(tris, np.int32)
        )


def _cloud_z_lookup(points: np.ndarray) -> Callable:
    """Midpoint z from the median of cloud points within the edge's
    half-length (falls back to the geometric midpoint z)."""

    def zfn(mid, va, vb):
        r = 0.5 * np.linalg.norm(va[:2] - vb[:2])
        d2 = np.sum((points[:, :2] - mid[:2]) ** 2, axis=1)
        near = d2 <= r * r
        if near.sum() >= 3:
            return float(np.median(points[near, 2]))
        return None

    return zfn


def refine_by_point_density(
    mesh: TriMesh,
    points: np.ndarray,
    max_points_per_triangle: int = MAX_POINTS_PER_TRIANGLE,
    min_distance_variance: float = -1.0,
    max_iterations: int = MESH_REFINEMENT_MAX_ITERATIONS,
    min_triangle_size: Optional[float] = None,
    min_edge_length: Optional[float] = None,
    variance_z: Optional[float] = None,
) -> TriMesh:
    """reference refineByPointDensity (refine_mesh.cpp:827-906): refine
    triangles whose point count exceeds max_points_per_triangle AND whose
    point-to-plane distance variance exceeds min_distance_variance, via
    newest-vertex bisection, skipping triangles already at the minimum
    size, until converged or max_iterations.

    min_distance_variance defaults to -1 (count-only refinement); the
    pipeline passes the reference's (2 x GSD)^2 threshold
    (pipeline.cpp:753-754) so planar regions stop refining."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    if len(points) == 0 or mesh.num_triangles == 0:
        return mesh
    if variance_z is not None:  # legacy alias
        min_distance_variance = variance_z
    if min_triangle_size is None and min_edge_length is not None:
        # legacy knob: the old bisection skipped edges < 2x min_edge_length
        min_triangle_size = 2.0 * min_edge_length
    if min_triangle_size is None:
        # guard against runaway subdivision: ~1/50 of the footprint
        extent = (mesh.vertices[:, :2].max(0) - mesh.vertices[:, :2].min(0)).max()
        min_triangle_size = extent / 50.0

    cur = mesh
    for _ in range(max_iterations):
        counts, variance = triangle_point_stats(cur, points)
        flagged = (counts > max_points_per_triangle) & (
            variance > min_distance_variance
        )
        if not flagged.any():
            break
        em = _EditableMesh(
            cur.vertices, cur.triangles, z_of_midpoint=_cloud_z_lookup(points)
        )
        created = 0
        # tids in an _EditableMesh built from an array are 0..nt-1 in order
        for t in np.flatnonzero(flagged):
            tid = int(t)
            if tid not in em.tris:
                continue  # invalidated by an earlier conforming split
            if em.max_edge(tid) < min_triangle_size:
                continue
            created += em.refine_triangle(tid)
        if created == 0:
            break
        cur = em.to_trimesh()
    return cur


def refine_where(
    mesh: TriMesh,
    should_refine: Callable[[float, float, float], bool],
    max_iterations: int = REFINE_MAX_DEPTH,
) -> TriMesh:
    """reference refineWhere (refine_mesh.hpp:152-160): refine all
    triangles whose centroid satisfies the predicate."""
    cur = mesh
    for _ in range(max_iterations):
        V = np.asarray(cur.vertices)
        T = np.asarray(cur.triangles)
        if len(T) == 0:
            break
        cent = V[T].mean(axis=1)
        flagged = [
            i for i, c in enumerate(cent)
            if should_refine(float(c[0]), float(c[1]), float(c[2]))
        ]
        if not flagged:
            break
        em = _EditableMesh(V, T)
        created = 0
        for tid in flagged:
            if tid in em.tris:
                created += em.refine_triangle(tid)
        if created == 0:
            break
        cur = em.to_trimesh()
    return cur


def refine_at_point(mesh: TriMesh, x: float, y: float, levels: int = 1) -> TriMesh:
    """reference refineAtPoint (refine_mesh.hpp:136-147)."""
    cur = mesh
    for _ in range(levels):
        ti = cur.find_triangles(np.asarray([[x, y]]))
        if ti[0] < 0:
            break
        em = _EditableMesh(cur.vertices, cur.triangles)
        if em.refine_triangle(int(ti[0])) == 0:
            break
        cur = em.to_trimesh()
    return cur


def merge_surface_models(surfaces: List[SurfaceModel]) -> Optional[SurfaceModel]:
    """reference mergeSurfaceModels (refine_mesh.hpp:196-207): when
    group-parallel relax produces one surface per group over the SAME mesh
    topology, merge them by weighting each vertex position by that group's
    point count in the triangles adjacent to the vertex. Returns None when
    the meshes don't share topology (caller keeps the list)."""
    meshed = [s for s in surfaces if s.mesh is not None and s.mesh.num_vertices > 0]
    clouds = [c for s in surfaces for c in s.cloud]
    if not meshed:
        return SurfaceModel(cloud=clouds, mesh=None) if clouds else None
    base = meshed[0].mesh
    for s in meshed[1:]:
        if (
            s.mesh.num_vertices != base.num_vertices
            or not np.array_equal(np.asarray(s.mesh.triangles), np.asarray(base.triangles))
        ):
            return None
    nv = base.num_vertices
    T = np.asarray(base.triangles)
    wsum = np.zeros(nv)
    psum = np.zeros((nv, 3))
    vsum = np.zeros((nv, 3))
    for s in meshed:
        pts = np.concatenate(s.cloud) if s.cloud else np.zeros((0, 3))
        counts = count_points_per_triangle(s.mesh, pts).astype(np.float64)
        w = np.zeros(nv)
        for k in range(3):
            np.add.at(w, T[:, k], counts)
        wsum += w
        psum += w[:, None] * np.asarray(s.mesh.vertices, np.float64)
        vsum += np.asarray(s.mesh.vertices, np.float64)
    merged = np.where(
        (wsum > 0)[:, None], psum / np.maximum(wsum, 1e-12)[:, None],
        vsum / len(meshed),
    )
    return SurfaceModel(cloud=clouds, mesh=TriMesh(merged, T.astype(np.int32)))


def refine_surfaces(surfaces: List[SurfaceModel]) -> List[SurfaceModel]:
    """Refine each surface's mesh where the point cloud is dense."""
    out = []
    for s in surfaces:
        if s.mesh is None or not s.cloud:
            out.append(s)
            continue
        pts = np.concatenate(s.cloud)
        refined = refine_by_point_density(s.mesh, pts)
        out.append(SurfaceModel(cloud=s.cloud, mesh=refined))
    return out
