"""Dense multi-view densification (twin of
opencalibration_tpu/dense/dense_stereo.py).

For each image and each of its nearest neighbours (by camera position), the
dense features' rays are dropped onto the ground mesh and projected into the
neighbour; ``gated_match`` keeps, per feature, the nearest descriptor among
the neighbour's features within ``SEARCH_RADIUS_PIXELS`` of that prediction,
under the ratio and absolute-distance tests. Matches are merged into tracks
by a union-find, each track triangulated from up to ``MAX_TRACK_RAYS`` rays,
and tracks whose every ray reprojects within ``MAX_REPROJECTION_ERROR_PIXELS``
are appended to ``surfaces[0].cloud``.

Geometry runs in float64 on the given device, as the reference casts every
camera model to float64; the Hamming product runs in float32 with TF32 off.
The mesh lookups and the track bookkeeping run on the host, in the
reference's order: observations are numbered in order of first appearance
and tracks listed by their union-find root in that order.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Dict, List, Optional

import numpy as np
import scipy.spatial
import torch

from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.ops import distort as D
from opencalibration_tpu_torch.ops import features as F
from opencalibration_tpu_torch.ops import hamming as H
from opencalibration_tpu_torch.ops.intersection import triangulate_tracks
from opencalibration_tpu_torch.ops.quaternion import quat_rotate, quat_rotate_inverse
from opencalibration_tpu_torch.types.camera import stack_cameras, take_camera
from opencalibration_tpu_torch.utils.device import resolve_device
from opencalibration_tpu_torch.utils.performance import PerformanceMeasure

SEARCH_RADIUS_PIXELS = 150.0
RATIO_THRESHOLD = 0.85
MAX_CANDIDATE_IMAGES = 10
MAX_ABSOLUTE_DESCRIPTOR_DISTANCE = 0.35
MAX_REPROJECTION_ERROR_PIXELS = 8.0
MAX_TRACK_RAYS = 8

# the dense set is re-extracted at DENSIFY_MESH with a larger budget and a
# lower detector threshold than the sparse set used for linking
DENSE_MAX_FEATURES = 8192
DENSE_THRESHOLD_SCALE = 0.2  # x the sparse detector threshold
DENSE_EXTRACT_BATCH = 16


class UnionFind:
    """Disjoint sets with path halving; the union makes the smaller root the
    parent."""

    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def unite(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)


def gated_match(desc1, xy1, valid1, desc2, xy2, valid2, predicted_xy):
    """Hamming distances / 486 gated by |xy2 - predicted| <= the search
    radius and valid2, then the nearest candidate under the ratio and
    absolute tests. desc [N, 16] int32 words, xy / predicted float32 [N, 2],
    valid bool. Returns (idx [N1] int64, best [N1] float32, good [N1] bool):
    the lowest column wins a tie, and only that column is masked for the
    second best, so a tie gives second == best."""
    inv_bits = torch.tensor(1.0 / H.DESCRIPTOR_BITS, dtype=torch.float32, device=desc1.device)
    dist = H.hamming_matrix(desc1, desc2).to(torch.float32) * inv_bits
    d2 = torch.sum((xy2[None, :, :] - predicted_xy[:, None, :]) ** 2, dim=-1)
    ok = (d2 <= SEARCH_RADIUS_PIXELS ** 2) & valid2[None, :]
    big = torch.tensor(2.0, dtype=torch.float32, device=dist.device)
    masked = torch.where(ok, dist, big)
    best = torch.amin(masked, dim=1)
    idx = torch.argmin(masked, dim=1)  # the first minimum
    cols = torch.arange(masked.shape[1], device=dist.device)
    second = torch.min(torch.where(cols[None, :] == idx[:, None], big, masked), dim=1).values
    n_candidates = torch.sum(ok, dim=1)
    good = torch.where(
        n_candidates >= 2,
        best < torch.tensor(RATIO_THRESHOLD, dtype=torch.float32, device=dist.device) * second,
        best < MAX_ABSOLUTE_DESCRIPTOR_DISTANCE,
    )
    good = good & valid1 & (best < MAX_ABSOLUTE_DESCRIPTOR_DISTANCE)
    return idx, best, good


def extract_dense_featuresets(graph, nodes, max_features: int = DENSE_MAX_FEATURES,
                              batch: int = DENSE_EXTRACT_BATCH, *, device="cuda"):
    """Decode every image again and extract a dense feature set of up to
    ``max_features`` at ``DENSE_THRESHOLD_SCALE`` x the detector threshold,
    in batches of ``batch`` on ``device``. Sets are padded (xy 1e9, invalid)
    or cut to one count, a multiple of 512. Returns {node_id: FeatureSet};
    images that fail to decode are left out (their sparse set is used)."""
    from opencalibration_tpu_torch.extract.image_loader import (
        batch_sparse_masks,
        features_from_device,
        load_and_decode,
        pad_gray_batch,
    )

    dev = resolve_device(device)
    threshold = F.DETECTOR_THRESHOLD * DENSE_THRESHOLD_SCALE
    raw: Dict[int, object] = {}
    for c0 in range(0, len(nodes), batch):
        chunk = nodes[c0 : c0 + batch]
        paths = [graph.get_node(nid).payload.path for nid in chunk]
        with PerformanceMeasure("dense: decode"):
            with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
                decoded = list(ex.map(load_and_decode, paths))
        good = [(nid, d) for nid, d in zip(chunk, decoded) if d is not None]
        if not good:
            continue
        with PerformanceMeasure("dense: extract"):
            gray_batch, sizes = pad_gray_batch([d.gray for _, d in good])
            out = F.extract_features(torch.from_numpy(gray_batch).to(dev), max_features=max_features,
                                     threshold=threshold)
            out_np, sparse_masks = batch_sparse_masks(out, sizes)
        for i, (nid, d) in enumerate(good):
            raw[nid] = features_from_device(out_np, i, d.scale, sizes[i], max_features, sparse_mask=sparse_masks[i])
    if not raw:
        return {}
    cap = max(len(f.xy) for f in raw.values())
    cap = min(max_features, ((cap + 511) // 512) * 512)
    for f in raw.values():
        n = len(f.xy)
        if n < cap:
            f.xy = np.concatenate([f.xy, np.full((cap - n, 2), 1e9)])
            f.strength = np.concatenate([f.strength, np.zeros(cap - n, np.float32)])
            f.descriptors = np.concatenate(
                [f.descriptors, np.zeros((cap - n,) + f.descriptors.shape[1:], f.descriptors.dtype)])
            f.valid = np.concatenate([f.valid, np.zeros(cap - n, bool)])
        elif n > cap:
            f.xy, f.strength = f.xy[:cap], f.strength[:cap]
            f.descriptors, f.valid = f.descriptors[:cap], f.valid[:cap]
    return raw


def _model64(model, dev):
    return model.map(lambda x: x.to(device=dev, dtype=torch.float64))


def densify_mesh(graph, model_store, surfaces, dense_features: Optional[Dict[int, object]] = None,
                 use_dense_extraction: bool = True, dense_max_features: int = DENSE_MAX_FEATURES,
                 *, device="cuda", stats: Optional[dict] = None) -> int:
    """Append the dense tracks' points to ``surfaces[0].cloud``; returns
    their number. ``dense_features`` ({node_id: FeatureSet}) replaces the
    re-extraction. ``stats``, where given, receives the feature counts, the
    pairs matched with the matcher's seconds, the tracks and the points
    kept."""
    dev = resolve_device(device)
    stats = {} if stats is None else stats
    mesh = next((s.mesh for s in surfaces if s.mesh is not None and s.mesh.num_vertices > 0), None)
    if mesh is None:
        return 0
    nodes = [nid for nid, node in sorted(graph.nodes())
             if np.isfinite(np.asarray(node.payload.orientation)).all() and node.payload.features is not None]
    if len(nodes) < 2:
        return 0

    positions = {nid: np.asarray(graph.get_node(nid).payload.position) for nid in nodes}
    tree = scipy.spatial.cKDTree(np.stack([positions[n][:2] for n in nodes]))
    node_arr = np.asarray(nodes)

    if dense_features is None and use_dense_extraction:
        dense_features = extract_dense_featuresets(graph, nodes, max_features=dense_max_features, device=dev)

    def feats_of(nid):
        if dense_features:
            f = dense_features.get(nid)
            if f is not None:
                return f
        return graph.get_node(nid).payload.features

    def t64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    def quat(nid):
        return t64(graph.get_node(nid).payload.orientation)

    def model(nid):
        return _model64(model_store[graph.get_node(nid).payload.model_id], dev)

    stats["features"] = {nid: int(np.asarray(feats_of(nid).valid).sum()) for nid in nodes}
    descs = {nid: interop.to_torch(np.asarray(feats_of(nid).descriptors), dev) for nid in nodes}
    xys = {nid: torch.as_tensor(np.asarray(feats_of(nid).xy, np.float32), device=dev) for nid in nodes}
    valids = {nid: torch.as_tensor(np.asarray(feats_of(nid).valid, bool), device=dev) for nid in nodes}

    key_to_obs: Dict[tuple, int] = {}
    observations: List[tuple] = []  # (node_id, feature index)
    uf_edges: List[tuple] = []
    pairs, match_s = 0, 0.0
    for nid in nodes:
        fa = feats_of(nid)
        pa_ = positions[nid]
        ma = model(nid)
        # the dense features' rays, dropped onto the mesh: the mesh height
        # under the camera first, then under that first hit
        rays_a = D.image_to_3d(t64(fa.xy), ma)
        world_dirs = quat_rotate(quat(nid)[None], rays_a).cpu().numpy()
        z0 = mesh.interpolate_z(pa_[None, :2])[0]
        if not np.isfinite(z0):
            z0 = float(mesh.vertices[:, 2].mean())
        dz = np.where(np.abs(world_dirs[:, 2]) < 1e-9, -1e-9, world_dirs[:, 2])
        t = (z0 - pa_[2]) / dz
        ground = pa_[None] + t[:, None] * world_dirs
        z1 = mesh.interpolate_z(ground[:, :2])
        z1 = np.where(np.isfinite(z1), z1, z0)
        t = (z1 - pa_[2]) / dz
        ground = pa_[None] + t[:, None] * world_dirs
        valid_a = np.asarray(fa.valid) & (t > 0)

        k = min(MAX_CANDIDATE_IMAGES + 1, len(nodes))
        _, nn = tree.query(pa_[:2], k=k)
        for j in np.atleast_1d(nn):
            nid_b = int(node_arr[j])
            if nid_b <= nid:  # each unordered pair once
                continue
            rays_b = quat_rotate_inverse(quat(nid_b)[None], t64(ground - positions[nid_b][None]))
            pred = D.image_from_3d(rays_b, model(nid_b))
            in_front = rays_b[:, 2] > 0
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t_match = time.perf_counter()
            idx, _, good = gated_match(
                descs[nid], xys[nid], torch.as_tensor(valid_a, device=dev) & in_front,
                descs[nid_b], xys[nid_b], valids[nid_b], pred.to(torch.float32),
            )
            idx, good = idx.cpu().numpy(), good.cpu().numpy()
            match_s += time.perf_counter() - t_match
            pairs += 1
            for ia in np.flatnonzero(good):
                ka = (nid, int(ia))
                kb = (nid_b, int(idx[ia]))
                for kk in (ka, kb):
                    if kk not in key_to_obs:
                        key_to_obs[kk] = len(observations)
                        observations.append(kk)
                uf_edges.append((key_to_obs[ka], key_to_obs[kb]))
    stats.update(pairs=pairs, match_seconds=match_s, matches=len(uf_edges), tracks=0, points=0)
    if not uf_edges:
        return 0

    uf = UnionFind(len(observations))
    for a, b in uf_edges:
        uf.unite(a, b)
    tracks: Dict[int, List[tuple]] = {}
    for i, obs in enumerate(observations):
        tracks.setdefault(uf.find(i), []).append(obs)

    # world rays of every dense feature, one batched call a node
    node_world_rays = {
        nid: quat_rotate(quat(nid)[None], D.image_to_3d(t64(feats_of(nid).xy), model(nid))).cpu().numpy()
        for nid in nodes
    }
    track_list = [t for t in tracks.values() if len(t) >= 2]
    if not track_list:
        return 0
    T = len(track_list)
    dirs = np.zeros((T, MAX_TRACK_RAYS, 3))
    origins = np.zeros((T, MAX_TRACK_RAYS, 3))
    valid = np.zeros((T, MAX_TRACK_RAYS), bool)
    pix = np.zeros((T, MAX_TRACK_RAYS, 2))
    track_nodes = []
    for ti, obs_list in enumerate(track_list):
        seen = {}  # one observation per image per track
        for nid, fi in obs_list:
            if nid not in seen:
                seen[nid] = fi
        items = sorted(seen.items())[:MAX_TRACK_RAYS]
        track_nodes.append(items)
        for k, (nid, fi) in enumerate(items):
            dirs[ti, k] = node_world_rays[nid][fi]
            origins[ti, k] = positions[nid]
            pix[ti, k] = feats_of(nid).xy[fi]
            valid[ti, k] = True

    pts, _ = triangulate_tracks(t64(dirs), t64(origins), torch.as_tensor(valid, device=dev))

    # the reprojection gate: every ray of a track through its own camera
    models_list = sorted({graph.get_node(nid).payload.model_id for items in track_nodes for nid, _ in items})
    model_slot = {mid: i for i, mid in enumerate(models_list)}
    batched = stack_cameras([_model64(model_store[mid], dev) for mid in models_list])
    obs_q = np.zeros((T, MAX_TRACK_RAYS, 4))
    obs_p = np.zeros((T, MAX_TRACK_RAYS, 3))
    obs_m = np.zeros((T, MAX_TRACK_RAYS), np.int64)
    for ti, items in enumerate(track_nodes):
        for k, (nid, _) in enumerate(items):
            node = graph.get_node(nid)
            obs_q[ti, k] = np.asarray(node.payload.orientation)
            obs_p[ti, k] = positions[nid]
            obs_m[ti, k] = model_slot[node.payload.model_id]
    ray = quat_rotate_inverse(t64(obs_q), pts[:, None, :] - t64(obs_p))
    repro = D.image_from_3d(ray, take_camera(batched, torch.as_tensor(obs_m, device=dev))).cpu().numpy()
    pts = pts.cpu().numpy()
    keep = np.isfinite(pts).all(axis=1)
    err = np.linalg.norm(repro - pix, axis=-1)
    keep &= ((err <= MAX_REPROJECTION_ERROR_PIXELS) | ~valid).all(axis=1)

    new_points = pts[keep]
    stats.update(tracks=T, points=len(new_points))
    if len(new_points):
        surfaces[0].cloud.append(new_points)
    return len(new_points)
