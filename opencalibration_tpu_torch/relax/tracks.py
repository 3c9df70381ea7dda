"""Multi-image feature tracks for the ground-mesh relax (twin of
opencalibration_tpu/relax/tracks.py).

Per-edge inlier matches become 2-view tracks; connected components over
(node, feature) keys merge them into multi-image tracks; tracks are
grid-filtered by length (longest track per image cell); each track's rays
are outlier-rejected against the robust centroid of their intersections
with the mesh triangle under the track, and the surviving 3-5-ray tracks
become padded plane-ray rows. The host phases are numpy, as in the
reference; the undistortion, world rotation and first-two-ray
triangulation run as one torch call on the problem's device.

The covered image cells and the used measurements are returned so the 2-ray
rows can skip what the tracks already constrain.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import numpy as np
import torch

from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.ops import distort as D
from opencalibration_tpu_torch.ops.intersection import ray_intersection
from opencalibration_tpu_torch.ops.quaternion import quat_rotate
from opencalibration_tpu_torch.types.camera import stack_cameras, take_camera
from opencalibration_tpu_torch.utils.performance import PerformanceMeasure

MIN_TRACK_RAYS = 3
MAX_TRACK_RAYS = 5


def _rays_and_first_mids_device(px, model_i, models, quats, positions, first0, first1):
    """Camera-frame rays of the track members and the midpoints of every
    track's first two rays, on the tensors' device.

    ``px`` [N, 2] member pixels (float32 values, undistorted in the models'
    float64), ``model_i`` / ``quats`` / ``positions`` per member, ``first0``
    and ``first1`` [T] the member rows of each track's first two rays.
    Returns (rays [N, 3], midpoints [T, 3])."""
    px = px.to(torch.float32).to(models.dtype)
    rays = D.image_to_3d(px, take_camera(models, model_i))
    d0 = quat_rotate(quats[first0], rays[first0])
    d1 = quat_rotate(quats[first1], rays[first1])
    mids, _ = ray_intersection(d0, positions[first0], d1, positions[first1])
    return rays, mids


def build_multiray_tracks(
    graph,
    cam_index: Dict[int, int],
    node_model: Dict[int, int],
    fwd_models: Dict[int, object],
    quats: np.ndarray,
    positions: np.ndarray,
    mesh,
    edge_ids: Sequence[int],
    grid_fraction: float,
    *,
    device,
):
    """Padded multi-ray track rows.

    ``fwd_models`` are the port's FORWARD ``CameraModel``s (float64 on the
    host). Returns (rows, used measurements, covered cells): rows is a dict
    of numpy arrays (vert_idx [B, 3], tri_xy [B, 3, 2], cam_idx [B, 5],
    ray_valid [B, 5], pixel [B, 5, 2], fixed_dir [B, 5, 3], model_i [B]) or
    an empty dict; used is a set of (node_id, feature index); covered maps a
    node id to its set of (cell x, cell y)."""
    # ---- phase 1: per-edge 2-view pairs -> connected tracks ----------------
    with PerformanceMeasure("tracks: phase1+2 host"):
        # node ids are random 64-bit: dense indices before the key encoding
        nid_order = sorted(cam_index)
        nid_dense = {nid: i for i, nid in enumerate(nid_order)}
        nid_arr = np.asarray(nid_order, np.int64)

        e_src, e_dst, e_i1, e_i2 = [], [], [], []
        for eid in edge_ids:
            e = graph.get_edge(eid)
            if e is None or e.source not in cam_index or e.dest not in cam_index:
                continue
            rel = e.payload
            n = len(rel.inlier_idx1)
            if n == 0:
                continue
            e_src.append(np.full(n, nid_dense[e.source], np.int64))
            e_dst.append(np.full(n, nid_dense[e.dest], np.int64))
            e_i1.append(np.asarray(rel.inlier_idx1, np.int64))
            e_i2.append(np.asarray(rel.inlier_idx2, np.int64))
        if not e_src:
            return {}, set(), {}
        a_keys = (np.concatenate(e_src) << 32) | np.concatenate(e_i1)
        b_keys = (np.concatenate(e_dst) << 32) | np.concatenate(e_i2)
        # interleave a/b so first-occurrence order follows the edge walk
        # (the dedup below keeps the FIRST feature per node)
        inter = np.empty(2 * len(a_keys), np.int64)
        inter[0::2] = a_keys
        inter[1::2] = b_keys
        uniq, first_pos, inv = np.unique(inter, return_index=True, return_inverse=True)
        a_idx, b_idx = inv[0::2], inv[1::2]

        import scipy.sparse
        import scipy.sparse.csgraph

        n_keys = len(uniq)
        adj = scipy.sparse.coo_matrix((np.ones(len(a_idx), np.int8), (a_idx, b_idx)), shape=(n_keys, n_keys))
        _, labels = scipy.sparse.csgraph.connected_components(adj, directed=False)

        key_nid = nid_arr[(uniq >> 32).astype(np.int64)]
        key_fi = (uniq & 0xFFFFFFFF).astype(np.int64)

        # ---- dedup per (track, node): keep the first-seen feature ---------
        order = np.lexsort((first_pos, key_nid, labels))
        ln = labels[order]
        nn = key_nid[order]
        keep_first = np.ones(len(order), bool)
        keep_first[1:] = (ln[1:] != ln[:-1]) | (nn[1:] != nn[:-1])
        dk = order[keep_first]
        d_lab = labels[dk]
        d_nid = key_nid[dk]
        d_fi = key_fi[dk]

        sizes = np.bincount(d_lab, minlength=d_lab.max() + 1)
        key_score = sizes[d_lab]
        ok_track = key_score >= MIN_TRACK_RAYS
        if not ok_track.any():
            return {}, set(), {}
        d_lab, d_nid, d_fi, key_score = d_lab[ok_track], d_nid[ok_track], d_fi[ok_track], key_score[ok_track]
        d_first = first_pos[dk][ok_track]

        # candidate index per surviving track, by first appearance
        lab_uniq, lab_inv = np.unique(d_lab, return_inverse=True)
        lab_first = np.full(len(lab_uniq), np.iinfo(np.int64).max)
        np.minimum.at(lab_first, lab_inv, d_first)
        ti_of_lab = np.empty(len(lab_uniq), np.int64)
        ti_of_lab[np.argsort(lab_first, kind="stable")] = np.arange(len(lab_uniq))
        d_ti = ti_of_lab[lab_inv]

        # ---- grid filter by track length -----------------------------------
        node_list_all = sorted({int(x) for x in np.unique(d_nid)})
        nid_index = {nid: i for i, nid in enumerate(node_list_all)}
        xy_parts = [np.asarray(graph.get_node(nid).payload.features.xy) for nid in node_list_all]
        offs = np.zeros(len(node_list_all) + 1, np.int64)
        offs[1:] = np.cumsum([len(x) for x in xy_parts])
        xy_cat = np.concatenate(xy_parts) if xy_parts else np.zeros((0, 2))
        d_nrow = np.asarray([nid_index[int(x)] for x in d_nid])
        px_all = xy_cat[offs[d_nrow] + d_fi]
        dims = np.stack([
            [max(float(fwd_models[node_model[nid]].pixels_cols), 1.0),
             max(float(fwd_models[node_model[nid]].pixels_rows), 1.0)]
            for nid in node_list_all
        ])
        cell_xy = np.floor(px_all / dims[d_nrow] / grid_fraction).astype(np.int64)
        cell_id = d_nrow.astype(np.int64) * (1 << 24) + (cell_xy[:, 0] & 0xFFF) * (1 << 12) + (cell_xy[:, 1] & 0xFFF)
        # best per cell: longest track, ties to the smallest candidate index
        corder = np.lexsort((d_ti, -key_score, cell_id))
        cfirst = np.ones(len(corder), bool)
        cid_s = cell_id[corder]
        cfirst[1:] = cid_s[1:] != cid_s[:-1]
        accepted = set(d_ti[corder[cfirst]].tolist())

        sort_items = np.lexsort((d_nid, d_ti))
        cand: List[List[Tuple[int, int]]] = [[] for _ in range(len(lab_uniq))]
        for j in sort_items:
            cand[d_ti[j]].append((int(d_nid[j]), int(d_fi[j])))

    def cell_key(nid, px):
        m = fwd_models[node_model[nid]]
        nx = px[0] / max(float(m.pixels_cols), 1.0)
        ny = px[1] / max(float(m.pixels_rows), 1.0)
        return (int(np.floor(nx / grid_fraction)), int(np.floor(ny / grid_fraction)))

    # ---- rays of every member of an accepted track, in one device call ----
    accepted_list = sorted(accepted)
    if not accepted_list:
        return {}, set(), {}
    with PerformanceMeasure("tracks: ray construction"):
        model_ids = sorted({node_model[nid] for ti in accepted_list for nid, _ in cand[ti]})
        model_slot = {mid: k for k, mid in enumerate(model_ids)}
        models = stack_cameras([fwd_models[mid] for mid in model_ids]).map(lambda x: x.to(device))
        members = [(nid, fi) for ti in accepted_list for nid, fi in cand[ti]]
        first = np.zeros((len(accepted_list), 2), np.int64)
        k = 0
        for ai, ti in enumerate(accepted_list):
            first[ai] = (k, k + 1)
            k += len(cand[ti])
        px = np.stack([np.asarray(graph.get_node(nid).payload.features.xy[fi], np.float32) for nid, fi in members])
        slots = np.asarray([cam_index[nid] for nid, _ in members])
        mem_rays_t, mids_t = _rays_and_first_mids_device(
            interop.to_torch(px, device),
            interop.to_torch(np.asarray([model_slot[node_model[nid]] for nid, _ in members], np.int64), device),
            models,
            interop.to_torch(quats[slots], device, models.dtype),
            interop.to_torch(positions[slots], device, models.dtype),
            interop.to_torch(first[:, 0], device), interop.to_torch(first[:, 1], device),
        )
        mem_rays, mids = interop.to_numpy(mem_rays_t), interop.to_numpy(mids_t)
        ray_at: Dict[Tuple[int, int], np.ndarray] = {m: mem_rays[i] for i, m in enumerate(members)}
        finite = np.isfinite(mids).all(axis=1)
        tri_idx_all = np.full(len(accepted_list), -1, np.int64)
        if finite.any():
            tri_idx_all[finite] = mesh.find_triangles(mids[finite, :2])

    rows = dict(vert_idx=[], tri_xy=[], cam_idx=[], ray_valid=[], pixel=[], fixed_dir=[], model_i=[])
    used: Set[Tuple[int, int]] = set()
    covered: Dict[int, Set] = {}

    with PerformanceMeasure("tracks: row loop"):
        for ai, ti in enumerate(accepted_list):
            items = cand[ti]
            nids = [nid for nid, _ in items]
            same_model = len({node_model[n] for n in nids}) == 1
            pixels = np.stack([graph.get_node(nid).payload.features.xy[fi] for nid, fi in items])
            dirs_cam = np.stack([ray_at[(nid, fi)] for nid, fi in items])
            cams = np.asarray([cam_index[nid] for nid in nids])
            q = quats[cams]
            t = positions[cams]
            w_ = q[:, 0:1]
            u = q[:, 1:]
            uv = np.cross(u, dirs_cam)
            world = dirs_cam + 2.0 * (w_ * uv + np.cross(u, uv))

            if tri_idx_all[ai] < 0:
                continue
            tri = mesh.triangles[tri_idx_all[ai]]
            v = mesh.vertices

            # plane intersections, robust centroid, outlier rejection
            n_vec = np.cross(v[tri[0]] - v[tri[1]], v[tri[0]] - v[tri[2]])
            n_vec = n_vec / max(np.linalg.norm(n_vec), 1e-30)
            denom = world @ n_vec
            if np.any(np.abs(denom) < 1e-9):
                continue
            s = ((v[tri[0]] - t) @ n_vec) / denom
            inter = t + s[:, None] * world
            dist = np.linalg.norm(inter - t, axis=1)
            avg = dist.mean()
            centroid = inter.mean(axis=0)
            for _ in range(3):
                err = np.linalg.norm(inter - centroid, axis=1)
                w = 1.0 / (err + 1e-8)
                hub = avg * 0.01
                w = np.where(err > hub, w * hub / np.maximum(err, 1e-30), w)
                centroid = (w[:, None] * inter).sum(0) / w.sum()
            err = np.linalg.norm(inter - centroid, axis=1) / max(avg, 1e-30)
            thr = max(np.median(err) * 3.0, 1e-6)
            good = [g for g in np.argsort(err) if err[g] <= thr][:MAX_TRACK_RAYS]
            if len(good) < MIN_TRACK_RAYS:
                continue

            pad = MAX_TRACK_RAYS - len(good)
            sel = list(good) + [good[0]] * pad
            rows["vert_idx"].append(tri)
            rows["tri_xy"].append(v[tri, :2])
            rows["cam_idx"].append(cams[sel])
            rows["ray_valid"].append(np.asarray([True] * len(good) + [False] * pad))
            rows["pixel"].append(pixels[sel])
            rows["fixed_dir"].append(dirs_cam[sel])
            rows["model_i"].append(node_model[nids[good[0]]] if same_model else -1)

            for g in good:
                nid, fi = items[g]
                used.add((nid, fi))
                covered.setdefault(nid, set()).add(cell_key(nid, pixels[g]))

    if not rows["vert_idx"]:
        return {}, set(), {}
    return {k: np.stack(vs) for k, vs in rows.items()}, used, covered
