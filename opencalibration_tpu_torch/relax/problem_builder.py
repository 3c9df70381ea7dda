"""Build relax problems from the measurement graph (twin of
opencalibration_tpu/relax/problem_builder.py: the decomposition,
ground-plane, ground-mesh and 3-d point problems, with ``refresh_problem``).

The host half is numpy, as in the reference: gather cameras and edges,
pick measurements (composite-score grid filter, triangle assignment), pad
block arrays to power-of-two buckets. Device work is the per-inlier-row
undistort + world rotation + two-ray triangulation (``_edge_rows_device``)
and the camera-model inversion. Problems are built in an explicit ``dtype``
on an explicit ``device``; the graph and the camera models stay on the host
(models as float64 CPU ``CameraModel``s).

With intrinsics in the options a mesh problem takes the pixel form of the
plane-ray block (focal, principal point and radial terms of one shared
INVERSE model per camera model in the tangent) and the radial monotonicity
prior; ``apply_solution`` converts a changed INVERSE model back to a FORWARD
one. A 3-d point problem optimises one point per kept inlier match with
pixel reprojection residuals against the FORWARD models, whose intrinsics
are then in the tangent themselves.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.ops import distort as D
from opencalibration_tpu_torch.ops.intersection import ray_intersection
from opencalibration_tpu_torch.ops.quaternion import quat_rotate
from opencalibration_tpu_torch.relax import blocks as B
from opencalibration_tpu_torch.relax.tangent import RelaxParams, TangentLayout
from opencalibration_tpu_torch.relax.tracks import build_multiray_tracks
from opencalibration_tpu_torch.surface.mesh import TriMesh, build_minimal_mesh
from opencalibration_tpu_torch.types.camera import INVERSE, CameraModel, stack_cameras, take_camera
from opencalibration_tpu_torch.types.graph import MeasurementGraph, NodePose, SurfaceModel
from opencalibration_tpu_torch.utils.performance import PerformanceMeasure

DOWN_QUAT = np.array([0.0, 1.0, 0.0, 0.0])  # 180 deg about x: nadir, north-up
GROUND_PLANE_MARGIN = 50.0  # metres: plane below the cameras, triangle beyond them


def _bucket(n: int, minimum: int = 16) -> int:
    """Round up to the next power of two (padded instances carry weight 0)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _pad_rows(arr, target, fill=0):
    arr = np.asarray(arr)
    if len(arr) >= target:
        return arr[:target]
    pad_shape = (target - len(arr),) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)])


@dataclasses.dataclass(frozen=True)
class RelaxOptions:
    """Typed subset of the reference's relax option set."""

    orientation: bool = True
    ground_plane: bool = False
    ground_mesh: bool = False
    points_3d: bool = False
    focal: bool = False
    principal: bool = False
    radial_tier: int = 0  # 0 off, 1 Brown2, 2 Brown24, 3 Brown246
    tangential: bool = False
    grid_fraction: float = 0.15  # measurement grid-filter cell, fraction of the image

    @property
    def any_intrinsics(self) -> bool:
        return self.focal or self.principal or self.radial_tier > 0 or self.tangential


@dataclasses.dataclass
class BuiltProblem:
    params: RelaxParams
    layout: TangentLayout
    blocks: list
    free_mask: torch.Tensor
    surface_free_mask: torch.Tensor  # the surface-only pre-solve mask
    cam_index: Dict[int, int]  # node_id -> camera slot
    model_index: Dict[int, int]  # model_id -> intrinsics slot
    mesh: Optional[TriMesh]
    inverse_models: bool  # whether intrinsics leaves hold INVERSE coefficients
    track_points: np.ndarray  # [N, 3] triangulated points for the surface cloud
    track_errors: np.ndarray  # [N]
    # structure-cache metadata (refresh_problem): problem family, count of
    # optimised (non-halo) camera slots, real (unpadded) mesh vertex count
    kind: str = "mesh"  # "mesh" | "points" | "decomposition"
    num_opt: int = 0
    v_real: int = 0


def _gather_cameras(graph: MeasurementGraph, node_poses: Sequence[NodePose], edge_ids: Sequence[int]):
    """Optimised cameras first, then the frozen boundary cameras the edges
    reference."""
    cam_index: Dict[int, int] = {}
    quats, positions, opt = [], [], []
    for np_ in node_poses:
        cam_index[np_.node_id] = len(quats)
        q = np.asarray(np_.orientation, np.float64)
        quats.append(np.where(np.isfinite(q).all(), q, DOWN_QUAT))
        positions.append(np.asarray(np_.position, np.float64))
        opt.append(True)
    for edge_id in edge_ids:
        e = graph.get_edge(edge_id)
        if e is None:
            continue
        for nid in (e.source, e.dest):
            if nid in cam_index:
                continue
            node = graph.get_node(nid)
            if node is None:
                continue
            q = np.asarray(node.payload.orientation, np.float64)
            p = np.asarray(node.payload.position, np.float64)
            if not (np.isfinite(q).all() and np.isfinite(p).all()):
                continue
            cam_index[nid] = len(quats)
            quats.append(q)
            positions.append(p)
            opt.append(False)
    return cam_index, np.asarray(quats), np.asarray(positions), np.asarray(opt)


def _usable_edges(graph, cam_index, edge_ids):
    out = []
    for edge_id in sorted(edge_ids):
        e = graph.get_edge(edge_id)
        if e is not None and e.source in cam_index and e.dest in cam_index:
            out.append(edge_id)
    return out


def _tensors(dtype, device):
    """(floats, ids, flags) converters from numpy to the problem's tensors."""
    def floats(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    def ids(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def flags(a):
        return torch.as_tensor(np.asarray(a, bool), device=device)

    return floats, ids, flags


def build_decomposition_problem(graph, node_poses, edge_ids, *, dtype, device) -> Optional[BuiltProblem]:
    """Relative-orientation problem: decomposed-rotation costs per edge plus
    the downwards prior."""
    floats, ids, flags = _tensors(dtype, device)
    cam_index, quats, positions, opt = _gather_cameras(graph, node_poses, edge_ids)
    if len(quats) == 0:
        return None
    layout = TangentLayout(len(quats), 0, 0, 1)
    params = RelaxParams.create(floats(quats), floats(positions), dtype=dtype)

    ci, cj, RQ, RT, RS, RV = [], [], [], [], [], []
    for edge_id in _usable_edges(graph, cam_index, edge_ids):
        e = graph.get_edge(edge_id)
        rel = e.payload
        if len(rel.inlier_idx1) == 0:
            continue
        scores = np.asarray(rel.rel_scores, np.float64)
        if not np.any(scores > 0):
            continue
        valid = scores > 0.25 * scores.max()
        q = np.asarray(rel.rel_quats, np.float64)
        t = np.asarray(rel.rel_positions, np.float64)
        valid &= np.isfinite(q).all(axis=1) & np.isfinite(t).all(axis=1)
        if not valid.any():
            continue
        ci.append(cam_index[e.source])
        cj.append(cam_index[e.dest])
        RQ.append(np.where(valid[:, None], q, DOWN_QUAT[None]))
        RT.append(np.where(valid[:, None], t, 0.0))
        RS.append(np.where(valid, scores, 0.0))
        RV.append(valid)
    if not ci:
        return None

    nb = _bucket(len(ci))
    blk = B.decomposed_rotation_block(
        layout, ids(_pad_rows(ci, nb)), ids(_pad_rows(cj, nb)),
        floats(_pad_rows(np.stack(RQ), nb)), floats(_pad_rows(np.stack(RT), nb)),
        floats(_pad_rows(np.stack(RS), nb)), flags(_pad_rows(np.stack(RV), nb, fill=False)),
        floats(_pad_rows(np.ones(len(ci)), nb)),
    )
    down = B.downwards_prior_block(layout, ids(np.arange(len(quats))), floats(opt))
    free = layout.build_free_mask(rot_free=np.asarray(opt), device=device)
    return BuiltProblem(
        params=params, layout=layout, blocks=[blk, down], free_mask=free,
        surface_free_mask=torch.zeros_like(free), cam_index=cam_index,
        model_index={}, mesh=None, inverse_models=False,
        track_points=np.zeros((0, 3)), track_errors=np.zeros(0),
        kind="decomposition", num_opt=len(node_poses), v_real=0,
    )


def _edge_rows_device(px1, px2, mi1, mi2, q1, q2, p1, p2, models: CameraModel):
    """Per inlier row, on the tensors' device: undistort each pixel through
    its row's FORWARD model, rotate into the world frame, triangulate the two
    rays. Returns (r1 cam, r2 cam, r1 world, r2 world, midpoint, error)."""
    r1 = D.image_to_3d(px1, take_camera(models, mi1))
    r2 = D.image_to_3d(px2, take_camera(models, mi2))
    r1w, r2w = quat_rotate(q1, r1), quat_rotate(q2, r2)
    mid, err = ray_intersection(r1w, p1, r2w, p2)
    return r1, r2, r1w, r2w, mid, err


def _ground_plane(positions) -> TriMesh:
    """One big triangle 50 m under the cameras, reaching 50 m past them."""
    lo, hi = positions[:, :2].min(0), positions[:, :2].max(0)
    center = 0.5 * (lo + hi)
    spacing = (hi - lo).max() + GROUND_PLANE_MARGIN
    height = positions[:, 2].mean() - GROUND_PLANE_MARGIN
    return TriMesh(
        np.array(
            [
                [center[0] - spacing, center[1] - spacing, height],
                [center[0] + spacing, center[1] - spacing, height],
                [center[0], center[1] + spacing, height],
            ]
        ),
        np.array([[0, 1, 2]], np.int32),
    )


def _initial_mesh(options: RelaxOptions, positions, previous_surfaces) -> Optional[TriMesh]:
    """The mesh a problem starts from: the previous surfaces' mesh for a
    ground-mesh problem, the big triangle for a ground-plane problem, else a
    minimal mesh under the cameras at the previous clouds' height."""
    prior_pts, prev_mesh = None, None
    for s in previous_surfaces:
        if s.mesh is not None and getattr(s.mesh, "num_vertices", 0) > 0:
            prev_mesh = s.mesh
        for c in s.cloud:
            prior_pts = c if prior_pts is None else np.concatenate([prior_pts, c])
    if options.ground_mesh and prev_mesh is not None:
        return prev_mesh.copy()
    if options.ground_plane:
        return _ground_plane(positions)
    return build_minimal_mesh(positions, prior_pts)


def _cell_keys(nid_dense_of_row, px, dims, grid_fraction):
    """(node, image cell) keys of pixel rows, as the reference encodes them."""
    g = np.floor(px / dims / grid_fraction).astype(np.int64)
    return nid_dense_of_row * (1 << 28) + ((g[:, 0] & 0x3FFF) << 14) + (g[:, 1] & 0x3FFF)


def build_mesh_problem(
    graph: MeasurementGraph,
    node_poses: Sequence[NodePose],
    cam_models: Dict[int, CameraModel],
    edge_ids: Sequence[int],
    options: RelaxOptions,
    previous_surfaces: Sequence[SurfaceModel] = (),
    grid_fraction: Optional[float] = None,
    *,
    dtype,
    device,
) -> Optional[BuiltProblem]:
    """Ground-plane or ground-mesh problem: plane-ray costs of rays against
    the mesh triangle under their triangulated point, plus the downwards
    prior. The rays are fixed camera-frame directions, or with any intrinsics
    option the pixels themselves, undistorted through the shared INVERSE
    model of their camera whose focal, principal point and radial terms are
    then in the tangent; the radial monotonicity prior is built with them and
    switched by its weight, so the option tiers change values and masks only.

    A ground-plane problem has one big triangle under the cameras and one
    two-ray row per kept inlier. A ground-mesh problem starts from the
    previous surfaces' mesh (``_initial_mesh``); it adds the multi-ray track
    rows first, keeps only the two-ray rows the tracks do not already
    constrain, and adds the mesh flatness, anchor and smoothness priors.
    Mesh heights are free; so are the rotations of the group's own cameras.
    Rows are grid-filtered at ``grid_fraction`` of the image (default
    ``options.grid_fraction``)."""
    if not (options.ground_plane or options.ground_mesh):
        raise ValueError("build_mesh_problem needs ground_plane or ground_mesh in the options")
    if grid_fraction is None:
        grid_fraction = options.grid_fraction
    floats, ids, flags = _tensors(dtype, device)
    cam_index, quats, positions, opt = _gather_cameras(graph, node_poses, edge_ids)
    if len(quats) < 2:
        return None
    edge_list = _usable_edges(graph, cam_index, edge_ids)
    if not edge_list:
        return None
    mesh = _initial_mesh(options, positions, previous_surfaces)
    if mesh is None:
        return None

    # ---- one shared INVERSE model per camera model id
    def on_device(m: CameraModel) -> CameraModel:
        return m.map(lambda x: x.to(device=device, dtype=dtype))

    model_index: Dict[int, int] = {}
    inv_models = []
    with PerformanceMeasure("build: model inversion"):
        for mid, m in sorted(cam_models.items()):
            model_index[mid] = len(inv_models)
            inv_models.append(D.convert_to_inverse(on_device(m)))
    M = max(1, len(inv_models))

    # the mesh-z tangent is padded to a bucket; padded slots carry no
    # residuals and are frozen
    V_real = mesh.num_vertices
    V_pad = _bucket(V_real, minimum=32)
    layout = TangentLayout(len(quats), V_pad, 0, M)
    mesh_z0 = np.zeros(V_pad)
    mesh_z0[:V_real] = mesh.vertices[:, 2]

    def leaf(name, default):
        if not inv_models:
            return floats(default)
        return torch.stack([getattr(m, name) for m in inv_models]).to(dtype)

    params = RelaxParams.create(
        floats(quats), floats(positions), mesh_z=floats(mesh_z0),
        focal=leaf("focal_length_pixels", [1.0]), principal=leaf("principal_point", np.zeros((1, 2))),
        radial=leaf("radial_distortion", np.zeros((1, 3))),
        tangential=leaf("tangential_distortion", np.zeros((1, 2))), dtype=dtype,
    )

    node_model = {nid: graph.get_node(nid).payload.model_id for nid in cam_index}
    fwd_models = {mid: on_device(m) for mid, m in cam_models.items()}
    # plane-ray rows as a few whole-array parts: tracks first, then 2-ray rows
    b_vert, b_trixy, b_cam, b_valid, b_pix, b_dir, b_model = [], [], [], [], [], [], []

    # ---- multi-ray track rows (ground mesh only)
    used_measurements, covered_cells = set(), {}
    if options.ground_mesh:
        with PerformanceMeasure("build: multiray tracks"):
            track_rows, used_measurements, covered_cells = build_multiray_tracks(
                graph, cam_index, node_model, cam_models, quats, positions, mesh, edge_list,
                grid_fraction, device=device,
            )
        if track_rows:
            mi_raw = np.asarray(track_rows["model_i"], np.int64)
            uniq, inv = np.unique(mi_raw, return_inverse=True)
            b_vert.append(track_rows["vert_idx"])
            b_trixy.append(track_rows["tri_xy"])
            b_cam.append(track_rows["cam_idx"])
            b_valid.append(track_rows["ray_valid"])
            b_model.append(np.asarray([model_index.get(int(v), 0) for v in uniq], np.int64)[inv])
            b_pix.append(track_rows["pixel"])
            b_dir.append(track_rows["fixed_dir"])

    # ---- gather every usable edge's inlier rows
    live_edges = []
    A_px1, A_px2, A_mi1, A_mi2, A_q1, A_q2, A_p1, A_p2 = ([] for _ in range(8))
    with PerformanceMeasure("build: edge gather host"):
        for edge_id in edge_list:
            e = graph.get_edge(edge_id)
            rel = e.payload
            n = len(rel.inlier_idx1)
            if n == 0:
                continue
            if node_model[e.source] not in fwd_models or node_model[e.dest] not in fwd_models:
                continue
            live_edges.append((edge_id, n))
            A_px1.append(np.asarray(rel.inlier_pixel1, np.float64))
            A_px2.append(np.asarray(rel.inlier_pixel2, np.float64))
            A_mi1.append(np.full(n, model_index[node_model[e.source]]))
            A_mi2.append(np.full(n, model_index[node_model[e.dest]]))
            A_q1.append(np.repeat(quats[cam_index[e.source]][None], n, 0))
            A_q2.append(np.repeat(quats[cam_index[e.dest]][None], n, 0))
            A_p1.append(np.repeat(positions[cam_index[e.source]][None], n, 0))
            A_p2.append(np.repeat(positions[cam_index[e.dest]][None], n, 0))

    track_points, track_errors = np.zeros((0, 3)), np.zeros(0)
    if live_edges:
        # ---- one device pass over all rows
        model_order = sorted(model_index, key=model_index.get)
        fwd_stack = stack_cameras([fwd_models[mid] for mid in model_order])
        with PerformanceMeasure("build: edge rows device"):
            rows = _edge_rows_device(
                floats(np.concatenate(A_px1)), floats(np.concatenate(A_px2)),
                ids(np.concatenate(A_mi1)), ids(np.concatenate(A_mi2)),
                floats(np.concatenate(A_q1)), floats(np.concatenate(A_q2)),
                floats(np.concatenate(A_p1)), floats(np.concatenate(A_p2)),
                fwd_stack,
            )
            r1c_all, r2c_all, r1w_all, r2w_all, mid_all, err_all = (interop.to_numpy(t) for t in rows)

        # ---- composite-score grid filter + triangle assignment, vectorised
        # over all edges' rows
        with PerformanceMeasure("build: grid filter + triangle assign"):
            R = sum(n for _, n in live_edges)
            row_edge = np.repeat(np.arange(len(live_edges)), [n for _, n in live_edges])
            px1_all = np.concatenate(A_px1)
            px2_all = np.concatenate(A_px2)
            e_objs = [graph.get_edge(eid) for eid, _ in live_edges]
            src_slot = np.asarray([cam_index[e.source] for e in e_objs])
            dst_slot = np.asarray([cam_index[e.dest] for e in e_objs])
            # node ids are random 64-bit: dense indices before any key encoding
            nid_dense = {nid: i for i, nid in enumerate(sorted(cam_index))}
            src_nid = np.asarray([nid_dense[e.source] for e in e_objs], np.int64)
            dst_nid = np.asarray([nid_dense[e.dest] for e in e_objs], np.int64)

            def dims(nid):
                m = fwd_models[node_model[nid]]
                return [max(float(m.pixels_cols), 1.0), max(float(m.pixels_rows), 1.0)]

            dims_src = np.asarray([dims(e.source) for e in e_objs])
            dims_dst = np.asarray([dims(e.dest) for e in e_objs])
            dist_parts, H_parts = [], []
            for (_, n), e in zip(live_edges, e_objs):
                rel = e.payload
                dist_parts.append(
                    np.asarray(rel.match_distance)[np.asarray(rel.inlier_match_index)]
                    if len(rel.match_distance)
                    else np.zeros(n)
                )
                Hm = np.asarray(rel.ransac_relation, np.float64)
                if Hm.shape != (3, 3) or not np.isfinite(Hm).all():
                    Hm = np.full((3, 3), np.nan)
                H_parts.append(Hm)
            dist_all = np.concatenate(dist_parts)
            H_edge = np.stack(H_parts)  # [E, 3, 3]

            # composite score: triangulation, ray angle, descriptor distance,
            # homography transfer
            inter_score = np.where(err_all < 0, 0.0, 1.0 / (1.0 + err_all))
            cosang = np.sum(r1w_all * r2w_all, axis=1)
            angle_score = 1.0 - cosang**2
            desc_score = 1.0 - dist_all
            src_h = np.concatenate([px1_all, np.ones((R, 1))], axis=1)
            dst_h = np.einsum("rij,rj->ri", H_edge[row_edge], src_h)
            wcoord = np.where(np.abs(dst_h[:, 2:3]) < 1e-12, 1e-12, dst_h[:, 2:3])
            reproj = np.linalg.norm(dst_h[:, :2] / wcoord - px2_all, axis=1)
            ransac_score = np.where(np.isfinite(reproj), 1.0 / (1.0 + reproj), 1.0)
            score = inter_score * angle_score * desc_score * ransac_score

            # best per grid cell in EITHER image, per edge
            keep_all = np.zeros(R, bool)
            for px_all, dims_e in ((px1_all, dims_src), (px2_all, dims_dst)):
                g = np.floor(px_all / dims_e[row_edge] / grid_fraction).astype(np.int64)
                cells = (row_edge.astype(np.int64) << 28) | ((g[:, 0] & 0x3FFF) << 14) | (g[:, 1] & 0x3FFF)
                order = np.lexsort((-score, cells))
                sc = cells[order]
                first = np.ones(R, bool)
                first[1:] = sc[1:] != sc[:-1]
                best = order[first]
                keep_all[best[score[best] > 0]] = True

            sel = keep_all & np.isfinite(mid_all).all(axis=1)
            track_points, track_errors = mid_all[sel], err_all[sel]
            tri_idx = np.full(R, -1, np.int64)
            if sel.any():
                with PerformanceMeasure("build: find triangles"):
                    tri_idx[sel] = mesh.find_triangles(mid_all[sel, :2])
            cand = np.flatnonzero(tri_idx >= 0)

            # rows whose measurement is in a multi-ray track, or whose cells
            # in both images are already track-covered, are redundant
            if len(cand) and used_measurements:
                um = list(used_measurements)
                um_keys = (np.asarray([nid_dense.get(k[0], -1) for k in um], np.int64) * (1 << 24)
                           + np.asarray([k[1] for k in um], np.int64))
                idx1_all = np.concatenate([np.asarray(e.payload.inlier_idx1, np.int64) for e in e_objs])
                idx2_all = np.concatenate([np.asarray(e.payload.inlier_idx2, np.int64) for e in e_objs])
                k1 = src_nid[row_edge[cand]] * (1 << 24) + idx1_all[cand]
                k2 = dst_nid[row_edge[cand]] * (1 << 24) + idx2_all[cand]
                cand = cand[~(np.isin(k1, um_keys) | np.isin(k2, um_keys))]
            if len(cand) and covered_cells:
                cov_keys = np.asarray(
                    [nid_dense[nid] * (1 << 28) + ((cx & 0x3FFF) << 14) + (cy & 0x3FFF)
                     for nid, cs in covered_cells.items() for cx, cy in cs if nid in nid_dense],
                    np.int64,
                )
                re = row_edge[cand]
                c1 = _cell_keys(src_nid[re], px1_all[cand], dims_src[re], grid_fraction)
                c2 = _cell_keys(dst_nid[re], px2_all[cand], dims_dst[re], grid_fraction)
                cand = cand[~(np.isin(c1, cov_keys) & np.isin(c2, cov_keys))]

            if len(cand):
                re = row_edge[cand]
                tri = mesh.triangles[tri_idx[cand]]  # [K, 3]
                cam5 = np.zeros((len(cand), 5), np.int64)
                cam5[:, 0] = src_slot[re]
                cam5[:, 1] = dst_slot[re]
                valid5 = np.zeros((len(cand), 5), bool)
                valid5[:, :2] = True
                r1k, r2k = r1c_all[cand], r2c_all[cand]
                model_row = np.asarray([model_index.get(node_model[e.source], 0) for e in e_objs])
                b_vert.append(tri)
                b_trixy.append(mesh.vertices[tri][:, :, :2])
                b_cam.append(cam5)
                b_valid.append(valid5)
                b_model.append(model_row[re])
                p1k, p2k = px1_all[cand], px2_all[cand]
                b_pix.append(np.stack([p1k, p2k, p1k, p1k, p1k], axis=1))
                b_dir.append(np.stack([r1k, r2k, r1k, r1k, r1k], axis=1))
    if not b_vert:
        return None

    # ---- stack the plane-ray block (up to five valid rays a row), padded,
    # and the priors
    with PerformanceMeasure("build: stack blocks"):
        v_all = np.concatenate(b_vert)
        NB = len(v_all)
        nb = _bucket(NB, minimum=64)
        if options.any_intrinsics:
            rays = dict(pixel=floats(_pad_rows(np.concatenate(b_pix), nb)))
        else:
            rays = dict(fixed_dir=floats(_pad_rows(np.concatenate(b_dir), nb)))
        blocks = [
            B.plane_ray_block(
                layout,
                vert_idx=ids(_pad_rows(v_all, nb)),
                tri_xy=floats(_pad_rows(np.concatenate(b_trixy), nb)),
                cam_idx=ids(_pad_rows(np.concatenate(b_cam), nb)),
                ray_valid=flags(_pad_rows(np.concatenate(b_valid), nb, fill=False)),
                weight=floats(_pad_rows(np.ones(NB), nb)),
                model_i=ids(_pad_rows(np.concatenate(b_model), nb)),
                **rays,
            ),
            B.downwards_prior_block(layout, ids(np.arange(len(quats))), floats(opt)),
        ]
        if options.ground_mesh:
            blocks += _mesh_prior_blocks(layout, mesh, floats, ids)
        if options.any_intrinsics and inv_models:
            # always present with intrinsics, weight 0 until a radial tier opens
            slots = [model_index[mid] for mid in model_index]
            blocks.append(B.monotonicity_block(
                layout, ids(slots), floats([_monotonicity_r_max(cam_models[mid]) for mid in model_index]),
                floats(np.full(len(slots), np.sqrt(NB / 10.0))),
                floats(np.full(len(slots), _monotonicity_weight(options))),
            ))

    mesh_free = np.arange(V_pad) < V_real
    free = layout.build_free_mask(
        rot_free=np.asarray(opt) if options.orientation else np.zeros(len(quats), bool),
        mesh_free=mesh_free, focal_free=options.focal, principal_free=options.principal,
        radial_tiers=options.radial_tier, device=device,
    )
    surface_free = layout.build_free_mask(
        rot_free=np.zeros(len(quats), bool), mesh_free=mesh_free, device=device
    )
    return BuiltProblem(
        params=params, layout=layout, blocks=blocks, free_mask=free,
        surface_free_mask=surface_free, cam_index=cam_index,
        model_index=model_index, mesh=mesh, inverse_models=True,
        track_points=track_points, track_errors=track_errors,
        kind="mesh", num_opt=len(node_poses), v_real=V_real,
    )


def _np_ray_error(rays1_w, rays2_w, pos1, pos2):
    """Signed squared inter-ray distance of world rays from two positions
    (numpy; ``ray_intersection``'s error, negative behind either camera)."""
    n1dn1 = np.sum(rays1_w * rays1_w, axis=-1)
    n1dn2 = np.sum(rays1_w * rays2_w, axis=-1)
    n2dn2 = np.sum(rays2_w * rays2_w, axis=-1)
    denom = n1dn1 * n2dn2 - n1dn2 * n1dn2
    offset = pos1[None] - pos2[None]
    odn1 = np.sum(offset * rays1_w, axis=-1)
    odn2 = np.sum(offset * rays2_w, axis=-1)
    denom_safe = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    t1 = (n1dn2 * odn2 - n2dn2 * odn1) / denom_safe
    t2 = (n1dn1 * odn2 - n1dn2 * odn1) / denom_safe
    p1 = pos1[None] + t1[:, None] * rays1_w
    p2 = pos2[None] + t2[:, None] * rays2_w
    err = np.sum((p1 - p2) ** 2, axis=-1)
    return np.where((t1 < 0) | (t2 < 0), -err, err)


def _grid_filter_edge(pixels1, pixels2, rays1_w, rays2_w, pos1, pos2, distances, ransac_H, dims1, dims2,
                      cell_fraction: float):
    """Composite-score grid filter of one edge's inliers (numpy): the best
    row per grid cell in either image by triangulation, ray angle,
    descriptor distance and homography transfer. Returns the keep mask."""
    n = len(pixels1)
    if n == 0:
        return np.zeros(0, bool)
    err = _np_ray_error(rays1_w, rays2_w, pos1, pos2)
    inter_score = np.where(err < 0, 0.0, 1.0 / (1.0 + err))
    angle_score = 1.0 - np.sum(rays1_w * rays2_w, axis=1) ** 2
    desc_score = 1.0 - np.asarray(distances)
    if ransac_H is not None and np.isfinite(ransac_H).all():
        dst = np.concatenate([pixels1, np.ones((n, 1))], axis=1) @ ransac_H.T
        dst = dst[:, :2] / np.where(np.abs(dst[:, 2:3]) < 1e-12, 1e-12, dst[:, 2:3])
        ransac_score = 1.0 / (1.0 + np.linalg.norm(dst - pixels2, axis=1))
    else:
        ransac_score = np.ones(n)
    score = inter_score * angle_score * desc_score * ransac_score
    keep = np.zeros(n, bool)
    for pixels, dims in ((pixels1, dims1), (pixels2, dims2)):
        gx = np.floor(pixels[:, 0] / dims[0] / cell_fraction).astype(np.int64)
        gy = np.floor(pixels[:, 1] / dims[1] / cell_fraction).astype(np.int64)
        cells = gx * 100000 + gy
        order = np.lexsort((-score, cells))
        first = np.ones(n, bool)
        first[1:] = cells[order][1:] != cells[order][:-1]
        best = order[first]
        keep[best[score[best] > 0]] = True
    return keep


def build_points_problem(
    graph: MeasurementGraph,
    node_poses: Sequence[NodePose],
    cam_models: Dict[int, CameraModel],
    edge_ids: Sequence[int],
    options: RelaxOptions,
    grid_fraction: float = 0.05,
    *,
    dtype,
    device,
) -> Optional[BuiltProblem]:
    """3-d point bundle adjustment: every inlier match the grid filter keeps
    (at ``grid_fraction`` of the image) becomes one point, triangulated from
    its two rays, with one pixel-reprojection residual pair in each camera
    against the FORWARD camera models. With any intrinsics option the
    radial monotonicity prior is built, switched by its weight. Points are
    always free; rotations follow ``options.orientation``."""
    floats, ids, _ = _tensors(dtype, device)
    cam_index, quats, positions, opt = _gather_cameras(graph, node_poses, edge_ids)
    if len(quats) < 2:
        return None
    edge_list = _usable_edges(graph, cam_index, edge_ids)
    if not edge_list:
        return None

    def on_device(m: CameraModel) -> CameraModel:
        return m.map(lambda x: x.to(device=device, dtype=dtype))

    model_index: Dict[int, int] = {}
    fwd_list = []
    for mid, m in sorted(cam_models.items()):
        model_index[mid] = len(fwd_list)
        fwd_list.append(on_device(m))
    if not fwd_list:
        return None
    node_model = {nid: graph.get_node(nid).payload.model_id for nid in cam_index}
    fwd_models = {mid: fwd_list[k] for mid, k in model_index.items()}

    pts_list, err_list = [], []
    obs = dict(cam_i=[], point_i=[], model_i=[], pixel=[])
    for edge_id in edge_list:
        e = graph.get_edge(edge_id)
        rel = e.payload
        n = len(rel.inlier_idx1)
        s_model, d_model = fwd_models.get(node_model[e.source]), fwd_models.get(node_model[e.dest])
        if n == 0 or s_model is None or d_model is None:
            continue
        px1 = np.asarray(rel.inlier_pixel1, np.float64)
        px2 = np.asarray(rel.inlier_pixel2, np.float64)
        r1, r2 = D.distort_keypoints(floats(px1), floats(px2), s_model, d_model)
        q1, q2 = quats[cam_index[e.source]], quats[cam_index[e.dest]]
        p1w, p2w = positions[cam_index[e.source]], positions[cam_index[e.dest]]
        r1w = interop.to_numpy(quat_rotate(floats(q1)[None], r1)).astype(np.float64)
        r2w = interop.to_numpy(quat_rotate(floats(q2)[None], r2)).astype(np.float64)
        dist = (np.asarray(rel.match_distance)[np.asarray(rel.inlier_match_index)]
                if len(rel.match_distance) else np.zeros(n))
        dims1 = (float(s_model.pixels_cols), float(s_model.pixels_rows))
        dims2 = (float(d_model.pixels_cols), float(d_model.pixels_rows))
        keep = _grid_filter_edge(px1, px2, r1w, r2w, p1w, p2w, dist, np.asarray(rel.ransac_relation),
                                 dims1, dims2, grid_fraction)
        if not keep.any():
            continue
        k = np.where(keep)[0]
        mid, err = ray_intersection(floats(r1w[k]), floats(np.repeat(p1w[None], len(k), 0)),
                                    floats(r2w[k]), floats(np.repeat(p2w[None], len(k), 0)))
        mid, err = interop.to_numpy(mid), interop.to_numpy(err)
        finite = np.isfinite(mid).all(axis=1)
        for j, ki in zip(np.where(finite)[0], k[finite]):
            p_idx = len(pts_list)
            pts_list.append(mid[j])
            err_list.append(err[j])
            for nid, px in ((e.source, px1[ki]), (e.dest, px2[ki])):
                obs["cam_i"].append(cam_index[nid])
                obs["point_i"].append(p_idx)
                obs["model_i"].append(model_index[node_model[nid]])
                obs["pixel"].append(px)
    if not pts_list:
        return None

    P_count = len(pts_list)
    layout = TangentLayout(len(quats), 0, P_count, len(fwd_list))
    params = RelaxParams.create(
        floats(quats), floats(positions), points=floats(np.stack(pts_list)),
        focal=torch.stack([m.focal_length_pixels for m in fwd_list]),
        principal=torch.stack([m.principal_point for m in fwd_list]),
        radial=torch.stack([m.radial_distortion for m in fwd_list]),
        tangential=torch.stack([m.tangential_distortion for m in fwd_list]), dtype=dtype,
    )
    nb = _bucket(len(obs["cam_i"]), minimum=64)
    blocks = [B.pixel_error_block(
        layout, ids(_pad_rows(np.asarray(obs["cam_i"]), nb)), ids(_pad_rows(np.asarray(obs["point_i"]), nb)),
        ids(_pad_rows(np.asarray(obs["model_i"]), nb)), floats(_pad_rows(np.stack(obs["pixel"]), nb)),
        floats(_pad_rows(np.ones(len(obs["cam_i"])), nb)),
    )]
    if options.any_intrinsics:
        # weight-gated as in the mesh problem: the option tiers change values only
        slots = list(model_index.values())
        blocks.append(B.monotonicity_block(
            layout, ids(slots), floats([_monotonicity_r_max(cam_models[mid]) for mid in model_index]),
            floats(np.full(len(slots), np.sqrt(P_count / 10.0))),
            floats(np.full(len(slots), _monotonicity_weight(options))),
        ))
    free = layout.build_free_mask(
        rot_free=np.asarray(opt) if options.orientation else np.zeros(len(quats), bool), points_free=True,
        focal_free=options.focal, principal_free=options.principal, radial_tiers=options.radial_tier,
        tangential_free=options.tangential, device=device,
    )
    surface_free = layout.build_free_mask(rot_free=np.zeros(len(quats), bool), points_free=True, device=device)
    return BuiltProblem(
        params=params, layout=layout, blocks=blocks, free_mask=free, surface_free_mask=surface_free,
        cam_index=cam_index, model_index=model_index, mesh=None, inverse_models=False,
        track_points=np.stack(pts_list), track_errors=np.asarray(err_list),
        kind="points", num_opt=len(node_poses), v_real=0,
    )


def _monotonicity_r_max(model: CameraModel) -> float:
    """The image's half diagonal in focal lengths: how far out the radial
    polynomial has to stay monotonic."""
    half = np.hypot(float(model.pixels_cols), float(model.pixels_rows)) / 2.0
    return half / max(float(model.focal_length_pixels), 1.0)


def _monotonicity_weight(options: RelaxOptions) -> float:
    return 1.0 if options.radial_tier > 0 else 0.0


def _mesh_prior_blocks(layout, mesh: TriMesh, floats, ids):
    """Flatness over every mesh edge, an anchor on every vertex at its
    current height, smoothness over every interior edge."""
    blocks = []
    edges_all = mesh.all_edges()
    if len(edges_all):
        blocks.append(B.mesh_flat_block(
            layout, ids(edges_all[:, 0]), ids(edges_all[:, 1]), floats(np.ones(len(edges_all)))
        ))
    blocks.append(B.mesh_anchor_block(
        layout, ids(np.arange(mesh.num_vertices)), floats(mesh.vertices[:, 2]),
        floats(np.ones(mesh.num_vertices)),
    ))
    interior, opposite, _ = mesh.interior_edges()
    if len(interior):
        v = mesh.vertices
        blocks.append(B.mesh_smooth_block(
            layout, ids(interior[:, 0]), ids(interior[:, 1]), ids(opposite[:, 0]), ids(opposite[:, 1]),
            floats(v[interior[:, 0], :2]), floats(v[interior[:, 1], :2]),
            floats(v[opposite[:, 0], :2]), floats(v[opposite[:, 1], :2]),
            floats(np.ones(len(interior))),
        ))
    return blocks


def refresh_problem(
    built: BuiltProblem,
    graph: MeasurementGraph,
    node_poses: Sequence[NodePose],
    cam_models: Dict[int, CameraModel],
    previous_surfaces: Sequence[SurfaceModel],
    options: RelaxOptions,
) -> bool:
    """Refresh a cached problem's values (poses, mesh heights, intrinsics),
    free masks and anchor targets from the current pipeline state, without
    selecting its measurements again (grid filter, tracks, triangle
    assignment). A repeat pass of a relax state re-solves the same structure
    with moved values; whatever changes the structure (mesh refinement, new
    images, edge refits) changes the pipeline's cache key instead. Returns
    False when the cached structure no longer fits (the caller rebuilds)."""
    p0 = built.params
    dtype, device = p0.quats.dtype, p0.quats.device
    floats, _, _ = _tensors(dtype, device)
    pose_by_id = {p.node_id: p for p in node_poses}

    C = p0.C
    quats = np.array(interop.to_numpy(p0.quats), np.float64)
    positions = np.array(interop.to_numpy(p0.positions), np.float64)
    for nid, slot in built.cam_index.items():
        p = pose_by_id.get(nid)
        if p is not None:
            q, pos = np.asarray(p.orientation, np.float64), np.asarray(p.position, np.float64)
        else:
            node = graph.get_node(nid)
            if node is None:
                return False
            q = np.asarray(node.payload.orientation, np.float64)
            pos = np.asarray(node.payload.position, np.float64)
        if not np.isfinite(q).all():
            q = DOWN_QUAT
        if slot >= C or not np.isfinite(pos).all():
            return False
        quats[slot] = q
        positions[slot] = pos

    mesh_z = np.array(interop.to_numpy(p0.mesh_z), np.float64)
    if built.kind == "mesh":
        prev_mesh = None
        for s in previous_surfaces:
            if s.mesh is not None and s.mesh.num_vertices == built.mesh.num_vertices:
                prev_mesh = s.mesh
        if prev_mesh is None or not np.array_equal(prev_mesh.triangles, built.mesh.triangles):
            return False
        built.mesh.vertices[:, 2] = prev_mesh.vertices[:, 2]
        mesh_z[: built.v_real] = prev_mesh.vertices[:, 2]

    leaves = {name: getattr(p0, name).clone() for name in ("focal", "principal", "radial", "tangential")}
    for mid, slot in built.model_index.items():
        m = cam_models.get(mid)
        if m is None:
            continue
        m = m.map(lambda x: x.to(device=device, dtype=dtype))
        if built.inverse_models:
            with PerformanceMeasure("refresh: model inversion"):
                m = D.convert_to_inverse(m)
        leaves["focal"][slot] = m.focal_length_pixels
        leaves["principal"][slot] = m.principal_point
        leaves["radial"][slot] = m.radial_distortion
        leaves["tangential"][slot] = m.tangential_distortion
    built.params = dataclasses.replace(
        p0, quats=floats(quats), positions=floats(positions), mesh_z=floats(mesh_z), **leaves
    )

    layout = built.layout
    rot_free = np.arange(C) < built.num_opt if options.orientation else np.zeros(C, bool)
    if built.kind == "mesh":
        mesh_free = np.arange(layout.V) < built.v_real
        built.free_mask = layout.build_free_mask(
            rot_free=rot_free, mesh_free=mesh_free, focal_free=options.focal,
            principal_free=options.principal, radial_tiers=options.radial_tier, device=device,
        )
        built.surface_free_mask = layout.build_free_mask(
            rot_free=np.zeros(C, bool), mesh_free=mesh_free, device=device
        )
    elif built.kind == "points":
        built.free_mask = layout.build_free_mask(
            rot_free=rot_free, points_free=True, focal_free=options.focal, principal_free=options.principal,
            radial_tiers=options.radial_tier, tangential_free=options.tangential, device=device,
        )
        built.surface_free_mask = layout.build_free_mask(rot_free=np.zeros(C, bool), points_free=True, device=device)

    # the anchor prior follows the pass-entry mesh; the monotonicity prior
    # follows the radial tier (its weight) and the current focal (r_max)
    mid_of_slot = {slot: mid for mid, slot in built.model_index.items()}
    for i, blk in enumerate(built.blocks):
        if blk.name == "mesh_anchor":
            v_i = interop.to_numpy(blk.data["v_i"])
            data = dict(blk.data, target=floats(built.mesh.vertices[v_i, 2]))
            built.blocks[i] = dataclasses.replace(blk, data=data)
        elif blk.name == "monotonicity":
            r_max = np.array(interop.to_numpy(blk.data["r_max"]), np.float64)
            for r, slot in enumerate(interop.to_numpy(blk.data["model_i"])):
                m = cam_models.get(mid_of_slot.get(int(slot)))
                if m is not None:
                    r_max[r] = _monotonicity_r_max(m)
            built.blocks[i] = dataclasses.replace(
                blk, data=dict(blk.data, r_max=floats(r_max)),
                weight=torch.full_like(blk.weight, _monotonicity_weight(options)),
            )
    return True


def apply_solution(built: BuiltProblem, params: RelaxParams, node_poses: Sequence[NodePose],
                   cam_models: Optional[Dict[int, CameraModel]] = None) -> SurfaceModel:
    """Write solved (host) orientations back into node_poses, solved
    intrinsics back into ``cam_models`` when given, and build the surface
    model: the solved mesh, and the cloud of triangulated points whose two
    rays meet within 1 m^2 in front of both cameras.

    The solved intrinsics leaves of a mesh problem are an INVERSE model's;
    where its focal or radial terms differ from the stored FORWARD model, the
    model is replaced by the conversion of the solved one, made in the
    problem's dtype on its device and stored like the old one. A points
    problem optimises the FORWARD models themselves, which replace the
    stored ones, and its solved points are the cloud."""
    quats = np.asarray(params.quats)
    for np_ in node_poses:
        slot = built.cam_index.get(np_.node_id)
        if slot is not None:
            np_.orientation = quats[slot]

    if cam_models is not None and not built.inverse_models:
        for mid, slot in built.model_index.items():
            old = cam_models.get(mid)
            if old is None:
                continue

            def like(x):
                return torch.as_tensor(np.asarray(x)[slot], device=old.focal_length_pixels.device).to(old.dtype)

            cam_models[mid] = dataclasses.replace(
                old, focal_length_pixels=like(params.focal), principal_point=like(params.principal),
                radial_distortion=like(params.radial), tangential_distortion=like(params.tangential),
            )
    if cam_models is not None and built.inverse_models:
        dtype, device = built.params.quats.dtype, built.params.quats.device

        def leaf(x):
            return torch.as_tensor(np.asarray(x), device=device).to(dtype)

        for mid, slot in built.model_index.items():
            old = cam_models.get(mid)
            if old is None:
                continue
            radial = np.asarray(params.radial)[slot]
            focal = float(np.asarray(params.focal)[slot])
            changed = not np.allclose(radial, -interop.to_numpy(old.radial_distortion), atol=1e-12) or not np.isclose(
                focal, float(old.focal_length_pixels)
            )
            if not changed:
                continue
            inv = CameraModel(
                focal_length_pixels=leaf(focal), principal_point=leaf(np.asarray(params.principal)[slot]),
                radial_distortion=leaf(radial), tangential_distortion=leaf(np.asarray(params.tangential)[slot]),
                pixels_cols=old.pixels_cols.to(device=device, dtype=dtype),
                pixels_rows=old.pixels_rows.to(device=device, dtype=dtype), tag=INVERSE,
            )
            with PerformanceMeasure("writeback: model conversion"):
                fwd = D.convert_to_forward(inv)
            cam_models[mid] = fwd.map(lambda x: x.to(device=old.focal_length_pixels.device, dtype=old.dtype))

    surface = SurfaceModel()
    if built.mesh is not None:
        mesh = built.mesh.copy()
        mesh.vertices[:, 2] = np.asarray(params.mesh_z)[: mesh.num_vertices]
        surface.mesh = mesh
    if built.params.P > 0 and not built.inverse_models:
        pts = np.asarray(params.points)
        good = np.isfinite(pts).all(axis=1)
        if good.any():
            surface.cloud.append(pts[good])
    else:
        good = np.isfinite(built.track_errors) & (np.abs(built.track_errors) < 1.0)
        if good.any():
            surface.cloud.append(built.track_points[good])
    return surface
