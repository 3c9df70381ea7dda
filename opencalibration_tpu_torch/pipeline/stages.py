"""Pipeline stages: load, link, relax (twin of
opencalibration_tpu/pipeline/stages.py).

* LoadStage: images decoded on host threads, then ONE batched feature
  extraction on the device for the whole batch, the radius-NMS sparse split
  on the device, one pull of the outputs to the host;
* LinkStage: candidate pairs from the GPS nearest neighbours, matched and
  RANSAC'd in chunks of ``LINK_CHUNK`` pairs padded to a fixed shape. On a
  CUDA device each chunk is matched by one launch of the hand-written
  Hamming top-2 kernel;
* RelaxStage: spectral clustering into bounded groups, each built as one
  relax problem (with a depth-2 halo of neighbours when there is one group)
  and solved on the device; a ``RelaxPlan`` carries the built problems and
  their final damping from one pass of a relax state to the next. Several
  groups that optimise intrinsics are stacked into one batch and solved
  jointly with their camera models shared
  (``group_solver.solve_group_batch_shared``);
* ``refit_all_edges``: after the intrinsics changed, every edge's homography
  is fitted again from its previous inliers and decomposed, in buckets of
  edges of one padded match count.

Every stage sorts its results into a canonical order before it changes the
graph, so a run is deterministic. The graph, its payloads and the camera
model store live on the host; tensors cross to the stage's device at the
stage boundary (camera models as float32 for the link, the pipeline's dtype
for the relax).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.extract.image_loader import (
    DecodedImage,
    batch_sparse_masks,
    camera_model_kwargs,
    features_from_device,
    load_and_decode,
    pad_gray_batch,
)
from opencalibration_tpu_torch.geo.geo_coord import GeoCoord
from opencalibration_tpu_torch.ops import distort as D
from opencalibration_tpu_torch.ops import features as F
from opencalibration_tpu_torch.ops import hamming as H
from opencalibration_tpu_torch.ops import models as M
from opencalibration_tpu_torch.ops import ransac as R
from opencalibration_tpu_torch.ops.clustering import spectral_cluster
from opencalibration_tpu_torch.ops.spatial import spatial_subsample
from opencalibration_tpu_torch.parallel.group_solver import (
    build_group_batch,
    extract_group_params,
    fetch_solved,
    refresh_group_batch,
    solve_group_batch_shared,
    solve_groups,
)
from opencalibration_tpu_torch.relax.lm import DEFAULT_MAX_ITERATIONS
from opencalibration_tpu_torch.relax.problem_builder import (
    RelaxOptions,
    _bucket,
    _pad_rows,
    apply_solution,
    refresh_problem,
)
from opencalibration_tpu_torch.relax.relax import build_problem
from opencalibration_tpu_torch.types.camera import CameraModel, stack_cameras
from opencalibration_tpu_torch.types.graph import (
    CameraRelations,
    ImageNode,
    MeasurementGraph,
    NodePose,
    RelationType,
    SurfaceModel,
)
from opencalibration_tpu_torch.utils.device import full_fp32, resolve_device
from opencalibration_tpu_torch.utils.performance import PerformanceMeasure, add_event_count

MAX_FEATURES = 2048
LINK_HYPOTHESES = 2048
LINK_SUBSET = 1024  # padded per-image sparse subset for matching
LINK_CHUNK = 16  # pairs per device call, padded to this
COARSE_SPACING_PIXELS = 40.0  # link subset grid at <= 1600 px images
KNN_NEIGHBOURS = 10
POSE_GROUP_SIZE = 50
INTRINSICS_GROUP_SIZE = 150


def _match_and_ransac_batch(
    desc1, xy1, valid1, desc2, xy2, valid2, models1: CameraModel, models2: CameraModel,
    num_hypotheses: int = LINK_HYPOTHESES, uniforms=None,
):
    """Link work of P candidate pairs at once: match (Hamming + Lowe ratio),
    undistort the matches to unit rays, RANSAC a homography and decompose it
    into four scored relative poses.

    desc* [P, N, 16] int32 words, xy* [P, N, 2], valid* [P, N] bool, models*
    with batch shape [P]. Returns a dict of [P, ...] tensors: idx2, dist,
    matched, model, inliers, score, quats, ts, pose_scores."""
    idx2, dist, matched = H.match_descriptors(desc1, desc2, valid1, valid2)
    mp2 = torch.gather(xy2, 1, idx2.to(torch.int64)[..., None].expand(-1, -1, 2))
    r1, r2 = D.distort_keypoints(xy1, mp2, models1, models2)
    res, quats, ts, scores = R.ransac_homography_with_poses(
        r1, r2, dist.to(r1.dtype), matched, num_hypotheses=num_hypotheses, uniforms=uniforms
    )
    return dict(
        idx2=idx2, dist=dist, matched=matched,
        model=res.model, inliers=res.inliers, score=res.score,
        quats=quats, ts=ts, pose_scores=scores,
    )


def _match_and_ransac_one(
    desc1, xy1, valid1, desc2, xy2, valid2, model1: CameraModel, model2: CameraModel,
    num_hypotheses: int = LINK_HYPOTHESES, uniforms=None,
):
    """One candidate edge: the batch form over a batch of one."""
    out = _match_and_ransac_batch(
        desc1[None], xy1[None], valid1[None], desc2[None], xy2[None], valid2[None],
        model1.map(lambda x: x[None]), model2.map(lambda x: x[None]),
        num_hypotheses=num_hypotheses, uniforms=uniforms,
    )
    return {k: v[0] for k, v in out.items()}


def _apply_sidecar_metadata(node: ImageNode):
    """An optional ``<image>.json`` sidecar overrides EXIF fields (externally
    geotagged surveys, synthetic tests)."""
    sidecar = os.path.splitext(node.path)[0] + ".json"
    if not os.path.exists(sidecar):
        return
    try:
        with open(sidecar) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        return
    md = node.metadata
    for key in (
        "latitude", "longitude", "altitude", "relative_altitude",
        "focal_length_px", "camera_make", "camera_model", "lens_model",
        "gps_accuracy_xy", "gps_accuracy_z",
    ):
        if key in data:
            setattr(md, key, data[key])


class LoadStage:
    """Decode a batch of paths on host threads, extract their features in one
    device call, turn them into graph nodes."""

    def __init__(self, *, device="cuda", max_features: int = MAX_FEATURES):
        self.device = resolve_device(device)
        self.max_features = max_features
        self._decoded: List[Optional[DecodedImage]] = []
        self._paths: List[str] = []
        self._futures = None
        self._executor = None

    def init(self, paths: Sequence[str]):
        self._paths = list(paths)
        self._decoded = []
        self._futures = None
        self._executor = None

    def start_decode(self, parallelism: int = 8):
        """Start decoding on a thread pool without waiting for it, so the
        decode of this batch overlaps the device work of earlier batches."""
        if not self._paths:
            return
        self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=parallelism)
        self._futures = [self._executor.submit(load_and_decode, p) for p in self._paths]

    def finish(self):
        """Join the decode threads and run the batched device extraction."""
        with PerformanceMeasure("load: decode join"):
            if self._futures is not None:
                try:
                    self._decoded = [f.result() for f in self._futures]
                finally:
                    self._executor.shutdown(wait=True)
                    self._futures = None
                    self._executor = None
            if not self._paths:
                self._decoded = []
                return
            for d in self._decoded:
                if d is not None:
                    _apply_sidecar_metadata(d.node)

        good = [d for d in self._decoded if d is not None]
        if not good:
            return
        with PerformanceMeasure("load: extract device"):
            batch, sizes = pad_gray_batch([d.gray for d in good])
            out = F.extract_features(torch.from_numpy(batch).to(self.device), max_features=self.max_features)
            out_np, sparse_masks = batch_sparse_masks(out, sizes)
            for i, d in enumerate(good):
                d.node.features = features_from_device(
                    out_np, i, d.scale, sizes[i], self.max_features, sparse_mask=sparse_masks[i]
                )

    def run(self, parallelism: int = 8):
        if self._futures is None:
            self.start_decode(parallelism)
        self.finish()

    def finalize(
        self,
        graph: MeasurementGraph,
        geocoord: GeoCoord,
        model_store: Dict[int, CameraModel],
        model_key_to_id: Dict[tuple, int],
        gps_positions: Dict[int, np.ndarray],
    ) -> List[int]:
        """Add the decoded images to the graph in input order: one camera
        model per distinct camera, the local frame's origin at the first
        geotagged image, GPS converted to local positions."""
        new_ids = []
        for d in self._decoded:
            if d is None:
                continue  # unreadable image skipped
            node = d.node
            md = node.metadata
            key = (
                md.camera_make, md.camera_model, md.lens_model,
                md.width_px, md.height_px, round(md.focal_length_px or 0.0, 3),
            )
            if key not in model_key_to_id:
                kw = camera_model_kwargs(md)
                model_id = len(model_store) + 1
                if not math.isfinite(kw["focal_length_pixels"] or float("nan")):
                    # last-resort prior: ~55 deg horizontal field of view
                    kw["focal_length_pixels"] = max(md.width_px, md.height_px)
                model_key_to_id[key] = model_id
                model_store[model_id] = CameraModel.create(dtype=torch.float64, device="cpu", **kw)
            node.model_id = model_key_to_id[key]

            if md.has_gps():
                if not geocoord.is_initialized():
                    geocoord.set_origin(md.latitude, md.longitude)
                alt = md.altitude if math.isfinite(md.altitude) else 0.0
                node.position = geocoord.to_local(md.latitude, md.longitude, alt)
            node_id = graph.add_node(node)
            if np.isfinite(node.position[:2]).all():
                gps_positions[node_id] = node.position[:2].copy()
            new_ids.append(node_id)
        self._decoded = []
        self._paths = []
        return new_ids


def _subsample_for_link(feats, model: CameraModel, device):
    """Indices [LINK_SUBSET] and validity of a strength-ordered, spatially
    spread feature subset: the strongest feature per grid cell of 40 px at
    1600 px images, proportionally finer on smaller ones (at least 4 px).
    Candidates are padded to a power-of-two bucket, as in the reference,
    because the padded length takes part in the selection key."""
    n = len(feats.xy)
    count = feats.num_sparse if feats.num_sparse > 0 else n
    nb = _bucket(max(count, 1), minimum=256)
    cols = max(float(model.pixels_cols), 1.0)
    rows = max(float(model.pixels_rows), 1.0)
    spacing = max(COARSE_SPACING_PIXELS * min(1.0, max(cols, rows) / 1600.0), 4.0)
    ncx = max(2, int(math.ceil(cols / spacing)))
    ncy = max(2, int(math.ceil(rows / spacing)))
    keep = spatial_subsample(
        torch.from_numpy(_pad_rows(feats.xy[:count], nb)).to(device),
        torch.from_numpy(_pad_rows(feats.strength[:count], nb)).to(device),
        torch.from_numpy(_pad_rows(feats.valid[:count], nb, fill=False)).to(device),
        spacing, ncx, ncy,
    )
    idx = np.where(interop.to_numpy(keep)[:count])[0][:LINK_SUBSET]
    pad = LINK_SUBSET - len(idx)
    sel = np.concatenate([idx, np.zeros(pad, np.int64)])
    valid = np.concatenate([np.ones(len(idx), bool), np.zeros(pad, bool)])
    return sel.astype(np.int32), valid


class LinkStage:
    """Candidate edges of the newly loaded nodes, matched and fitted on the
    device.

    ``uniforms`` [LINK_HYPOTHESES, 4] are the RANSAC sample draws shared by
    every pair, as the reference draws one ``jax.random`` block per call;
    by default ``ransac.default_uniforms`` makes them from its seed."""

    def __init__(self, *, device="cuda", uniforms=None):
        self.device = resolve_device(device)
        if uniforms is None:
            uniforms = R.default_uniforms(
                LINK_HYPOTHESES, M.HOMOGRAPHY_MIN_POINTS, R.DEFAULT_SEED, self.device
            )
        self.uniforms = torch.as_tensor(uniforms).to(self.device)
        self._candidates: List[Tuple[int, int]] = []
        self._results = []

    def init(self, graph: MeasurementGraph, gps_positions: Dict[int, np.ndarray], node_ids: Sequence[int]):
        """Candidate edges: the KNN_NEIGHBOURS nearest GPS neighbours of each
        new node that are not linked yet."""
        self._candidates = []
        self._results = []
        if not node_ids or len(gps_positions) < 2:
            return
        import scipy.spatial

        ids = sorted(gps_positions.keys())
        tree = scipy.spatial.cKDTree(np.stack([gps_positions[i] for i in ids]))
        id_arr = np.asarray(ids)
        seen = set()
        for nid in sorted(node_ids):
            if nid not in gps_positions:
                continue
            _, nn = tree.query(gps_positions[nid], k=min(KNN_NEIGHBOURS + 1, len(ids)))
            for j in np.atleast_1d(nn):
                other = int(id_arr[j])
                if other == nid or (nid, other) in seen or (other, nid) in seen:
                    continue
                if graph.get_edge_id(nid, other) is not None or graph.get_edge_id(other, nid) is not None:
                    continue
                seen.add((nid, other))
                self._candidates.append((nid, other))

    def run(self, graph: MeasurementGraph, model_store: Dict[int, CameraModel]):
        """Enqueue the device work of every candidate, LINK_CHUNK pairs per
        call; the results stay on the device until ``finalize``."""
        prepared = []
        sub_cache: Dict[int, tuple] = {}
        dev = self.device

        def subsample_of(nid, node, model):
            if nid not in sub_cache:
                sub_cache[nid] = _subsample_for_link(node.payload.features, model, dev)
            return sub_cache[nid]

        for source, dest in self._candidates:
            ns, nd = graph.get_node(source), graph.get_node(dest)
            if ns is None or nd is None or ns.payload.features is None or nd.payload.features is None:
                continue
            ms = model_store[ns.payload.model_id]
            md = model_store[nd.payload.model_id]
            sel1, v1 = subsample_of(source, ns, ms)
            sel2, v2 = subsample_of(dest, nd, md)
            f1, f2 = ns.payload.features, nd.payload.features
            prepared.append((
                source, dest, sel1, sel2,
                f1.descriptors[sel1], f1.xy[sel1].astype(np.float32), v1,
                f2.descriptors[sel2], f2.xy[sel2].astype(np.float32), v2,
                ms, md,
            ))

        def to_f32(m: CameraModel) -> CameraModel:
            return m.map(lambda x: x.to(device=dev, dtype=torch.float32))

        for c0 in range(0, len(prepared), LINK_CHUNK):
            chunk = prepared[c0 : c0 + LINK_CHUNK]
            n = len(chunk)
            chunk_p = chunk + [chunk[-1]] * (LINK_CHUNK - n)  # fixed chunk shape

            def stacked(k):
                return interop.to_torch(np.stack([c[k] for c in chunk_p]), dev)

            out = _match_and_ransac_batch(
                stacked(4), stacked(5), stacked(6), stacked(7), stacked(8), stacked(9),
                stack_cameras([to_f32(c[10]) for c in chunk_p]),
                stack_cameras([to_f32(c[11]) for c in chunk_p]),
                num_hypotheses=LINK_HYPOTHESES, uniforms=self.uniforms,
            )
            self._results.append((chunk, n, out))

    def finalize(self, graph: MeasurementGraph) -> List[int]:
        """Pull the results and insert the edges that keep at least 6
        inliers, sorted by (source, dest)."""
        resolved = []
        for chunk, n, out in self._results:
            out_np = {k: interop.to_numpy(v) for k, v in out.items()}
            for i in range(n):
                source, dest, sel1, sel2 = chunk[i][:4]
                resolved.append((source, dest, sel1, sel2, {k: v[i] for k, v in out_np.items()}))
        new_node_ids = set()
        for source, dest, sel1, sel2, out in sorted(resolved, key=lambda r: (r[0], r[1])):
            matched = out["matched"]
            inliers = out["inliers"] & matched
            if inliers.sum() < 4 * 1.5:
                continue
            rel = CameraRelations()
            # matches sorted by descending distance
            m = np.where(matched)[0]
            m = m[np.argsort(-out["dist"][m], kind="stable")]
            rel.match_idx1 = sel1[m].astype(np.int32)
            rel.match_idx2 = sel2[out["idx2"][m]].astype(np.int32)
            rel.match_distance = out["dist"][m].astype(np.float32)
            # inliers in match-list order, with their rank in that list
            inl = np.where(inliers)[0]
            ranks = np.full(len(matched), -1, np.int64)
            ranks[m] = np.arange(len(m))
            inl = inl[np.argsort(ranks[inl])]
            ns, nd = graph.get_node(source), graph.get_node(dest)
            rel.inlier_idx1 = sel1[inl].astype(np.int32)
            rel.inlier_idx2 = sel2[out["idx2"][inl]].astype(np.int32)
            rel.inlier_pixel1 = ns.payload.features.xy[rel.inlier_idx1]
            rel.inlier_pixel2 = nd.payload.features.xy[rel.inlier_idx2]
            rel.inlier_match_index = np.where(ranks[inl] >= 0, ranks[inl], 0).astype(np.int32)
            rel.ransac_relation = out["model"].astype(np.float64)
            rel.relation_type = RelationType.HOMOGRAPHY
            rel.rel_quats = out["quats"].astype(np.float64)
            rel.rel_positions = out["ts"].astype(np.float64)
            rel.rel_scores = out["pose_scores"].astype(np.float64)
            graph.add_edge(rel, source, dest)
            new_node_ids.update((source, dest))
        self._results = []
        self._candidates = []
        return sorted(new_node_ids)


@dataclasses.dataclass
class RelaxGroupState:
    poses: List[NodePose]
    cam_models: Dict[int, CameraModel]
    edge_ids: List[int]
    # node ids whose solved poses ``finalize`` writes to the graph; None: all.
    # A multi-group intrinsics run writes only each group's own nodes: the
    # halo duplicates across groups are co-optimised in the group and written
    # by their home group
    write_ids: Optional[set] = None


@dataclasses.dataclass
class RelaxPlan:
    """Cached problem structure for the repeat passes of one relax state:
    the groups and their built problems. The pipeline owns the cache key
    (graph, mesh and option structure); ``RelaxStage`` refreshes the
    problems' values on each reuse (``problem_builder.refresh_problem``)
    and warm-starts each group's damping from the previous pass."""

    key: tuple
    groups: List[RelaxGroupState]
    builts: list  # Optional[BuiltProblem] per group
    pre_solve: bool
    warm_lambda: Optional[list] = None  # final damping per live group
    batch: object = None  # the stacked GroupBatch of a shared-intrinsics solve


class RelaxStage:
    """Spectral-clustered group relaxation. Each group is built as one relax
    problem in ``dispatch`` (host work plus the per-row device pass) and
    solved in ``join`` in the stage's ``dtype`` on its ``device``: one group
    after another, or, when several groups optimise intrinsics, as one joint
    problem with the camera models and the surface shared."""

    def __init__(self, *, device="cuda", dtype=torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self._groups: List[RelaxGroupState] = []
        self._options = RelaxOptions()
        self._surfaces: List[SurfaceModel] = []
        self._plan: Optional[RelaxPlan] = None  # set by reuse_plan
        self.last_plan: Optional[RelaxPlan] = None  # the plan of the last dispatch
        self._inflight = None  # (builts, live, pre_solve, warm lambdas, batch) between dispatch and join
        self.max_lm_iterations: Optional[int] = None  # None: the LM's default cap

    def init(
        self,
        graph: MeasurementGraph,
        node_ids: Sequence[int],
        gps_positions: Dict[int, np.ndarray],
        model_store: Dict[int, CameraModel],
        relax_all: bool,
        disable_parallelism: bool,
        options: RelaxOptions,
    ):
        """Groups of the given nodes (of every node with ``relax_all``): one
        group when ``disable_parallelism`` or up to the group size
        (POSE_GROUP_SIZE, or INTRINSICS_GROUP_SIZE with intrinsics in the
        options), spectral clusters beyond."""
        self._options = options
        self._surfaces = []
        self._groups = []
        self._plan = None
        self.last_plan = None
        ids = sorted(graph.node_ids()) if relax_all else sorted(set(node_ids))
        ids = [
            i for i in ids
            if graph.get_node(i) is not None
            and np.isfinite(np.asarray(graph.get_node(i).payload.position)).all()
        ]
        if not ids:
            return
        group_size = INTRINSICS_GROUP_SIZE if options.any_intrinsics else POSE_GROUP_SIZE
        if disable_parallelism or len(ids) <= group_size:
            labels = np.zeros(len(ids), np.int64)
        else:
            idx_of = {nid: k for k, nid in enumerate(ids)}
            edges, weights = [], []
            for _, e in graph.edges():
                if e.source in idx_of and e.dest in idx_of:
                    edges.append((idx_of[e.source], idx_of[e.dest]))
                    weights.append(max(1.0, float(len(e.payload.inlier_idx1))))
            pts = np.stack([np.asarray(graph.get_node(i).payload.position)[:2] for i in ids])
            labels = spectral_cluster(len(ids), edges, weights, pts, group_size)

        by_label: Dict[int, List[int]] = {}
        for nid, lab in zip(ids, labels):
            by_label.setdefault(int(lab), []).append(nid)
        # a single group takes a depth-2 halo of connected neighbours, so a
        # new batch is co-optimised with the already placed cameras it links to
        depth = 0 if len(by_label) > 1 else 2
        for lab in sorted(by_label, key=lambda lb: (-len(by_label[lb]), lb)):  # big groups first
            self._groups.append(
                self._build_group(graph, by_label[lab], gps_positions, model_store, depth)
            )

    def _build_group(self, graph, g_ids, gps_positions, model_store, connection_depth=0) -> RelaxGroupState:
        """Working set: copies of the poses, the group's camera models, and
        the edges to each node's 10 GPS nearest neighbours. Each round of
        ``connection_depth`` adds the connected out-of-group nodes as
        co-optimised poses; an edge is optimised iff its other end is in the
        original group.

        With intrinsics in the options a group also takes the edges that
        leave it from one of its own nodes (each cross-group edge is owned by
        its source's group, so the joint objective counts it once). The
        far end joins as a co-optimised duplicate that its home group writes
        back: a frozen copy would pin the shared surface and intrinsics at
        their entry values. Such groups carry the whole model store, so all
        of them list the same camera models."""
        import scipy.spatial

        core = set(g_ids)
        ids = sorted(gps_positions.keys())
        tree = scipy.spatial.cKDTree(np.stack([gps_positions[i] for i in ids])) if ids else None
        id_arr = np.asarray(ids)
        edge_ids = set()
        directly_connected = set()
        cross_ok = self._options.any_intrinsics
        cross_halo = set()

        def posed(node):
            return (node is not None and np.isfinite(np.asarray(node.payload.orientation)).all()
                    and np.isfinite(np.asarray(node.payload.position)).all())

        def build_edges(nid):
            if tree is None or nid not in gps_positions:
                return
            _, nn = tree.query(gps_positions[nid], k=min(KNN_NEIGHBOURS + 1, len(ids)))
            ideal = {int(id_arr[j]) for j in np.atleast_1d(nn)} - {nid}
            for eid in graph.get_node(nid).edges:
                e = graph.get_edge(eid)
                other = e.dest if e.source == nid else e.source
                if other in ideal:
                    directly_connected.add(other)
                    if other in core:
                        edge_ids.add(eid)
                    elif cross_ok and nid in core and e.source == nid and posed(graph.get_node(other)):
                        edge_ids.add(eid)
                        cross_halo.add(other)

        local = list(g_ids)
        for nid in g_ids:
            build_edges(nid)
        for _ in range(connection_depth):
            for nid in sorted(directly_connected - set(local)):
                node = graph.get_node(nid)
                if node is None or not np.isfinite(np.asarray(node.payload.position)).all():
                    continue
                local.append(nid)
                build_edges(nid)
        cross_halo -= set(local)
        local.extend(sorted(cross_halo))

        poses = []
        cam_models: Dict[int, CameraModel] = dict(model_store) if self._options.any_intrinsics else {}
        for nid in sorted(local, key=lambda i: graph.get_node(i).payload.path):
            node = graph.get_node(nid)
            poses.append(NodePose(
                node_id=nid,
                orientation=np.asarray(node.payload.orientation, np.float64).copy(),
                position=np.asarray(node.payload.position, np.float64).copy(),
            ))
            mid = node.payload.model_id
            if mid not in cam_models and mid in model_store:
                cam_models[mid] = model_store[mid]
        return RelaxGroupState(poses=poses, cam_models=cam_models, edge_ids=sorted(edge_ids),
                               write_ids=set(g_ids) if cross_halo else None)

    def trim_groups(self, n: int):
        """Keep only the n biggest groups."""
        self._groups = self._groups[:n]

    def reuse_plan(self, plan: RelaxPlan, graph: MeasurementGraph, model_store: Dict[int, CameraModel],
                   options: RelaxOptions):
        """Enter a repeat pass from a cached plan instead of ``init``: restore
        the groups and refresh their poses and models from the graph;
        ``dispatch`` then refreshes the built problems' values instead of
        building them again."""
        self._options = options
        self._surfaces = []
        self._groups = plan.groups
        self._plan = plan
        self.last_plan = None
        for g in self._groups:
            for pose in g.poses:
                node = graph.get_node(pose.node_id)
                if node is None:
                    continue
                pose.orientation = np.asarray(node.payload.orientation, np.float64).copy()
                pose.position = np.asarray(node.payload.position, np.float64).copy()
            for mid in list(g.cam_models):
                if mid in model_store:
                    g.cam_models[mid] = model_store[mid]

    def run_all(self, graph: MeasurementGraph, previous_surfaces=()):
        """Build, solve and write back in one call."""
        self.dispatch(graph, previous_surfaces)
        self.join()

    def dispatch(self, graph: MeasurementGraph, previous_surfaces=()):
        """Build every group's problem (host work and the per-row device
        pass), or refresh the reused plan's; ``join`` solves them."""
        self._inflight = None
        self._surfaces = [SurfaceModel() for _ in self._groups]
        if not self._groups:
            return
        builts, pre_solve, warm, cached_batch = None, False, None, None
        if self._plan is not None:
            with PerformanceMeasure("relax refresh problems"):
                ok = all(
                    b is None or refresh_problem(b, graph, g.poses, g.cam_models, previous_surfaces, self._options)
                    for g, b in zip(self._groups, self._plan.builts)
                )
            if ok:
                builts, pre_solve, warm = self._plan.builts, self._plan.pre_solve, self._plan.warm_lambda
                cached_batch = self._plan.batch
                add_event_count("relax plan reuses", 1.0)
            self._plan = None
        if builts is None:
            builts = []
            with PerformanceMeasure("relax build problems"):
                for g in self._groups:
                    built, pre = build_problem(
                        graph, g.poses, g.cam_models, g.edge_ids, self._options, previous_surfaces,
                        dtype=self.dtype, device=self.device,
                    )
                    builts.append(built)
                    pre_solve = pre_solve or (pre and built is not None)
        live = [i for i, b in enumerate(builts) if b is not None]
        if not live:
            return
        self.last_plan = RelaxPlan(key=(), groups=self._groups, builts=builts, pre_solve=pre_solve)
        # several groups optimising the SAME camera models: one joint solve
        # with the intrinsics (and the surface) shared across the groups
        batch = None
        if self._options.any_intrinsics and len(live) > 1:
            with PerformanceMeasure("relax batch groups"):
                if cached_batch is not None and cached_batch.shared_intrinsics:
                    batch = refresh_group_batch(cached_batch)  # values, masks and anchors only
                else:
                    batch = build_group_batch([builts[i] for i in live], shared_intrinsics=True)
            self.last_plan.batch = batch
        self._inflight = (builts, live, pre_solve, warm, batch)

    def join(self):
        """Solve the dispatched groups and write the results back into the
        groups' working sets."""
        if self._inflight is None:
            return
        builts, live, pre_solve, warm, batch = self._inflight
        self._inflight = None
        iters = self.max_lm_iterations or DEFAULT_MAX_ITERATIONS
        with PerformanceMeasure("relax solve"):
            if batch is not None:
                stacked, info = solve_group_batch_shared(batch, pre_solve, max_iterations=iters)
                add_event_count("lm iterations", float(info.iterations))
                stacked = fetch_solved(stacked)
                solved = [extract_group_params(batch, stacked, k) for k in range(len(live))]
            else:
                solved, infos = solve_groups([builts[i] for i in live], pre_solve, max_iterations=iters,
                                             init_lambda=warm)
                add_event_count("lm iterations", float(sum(int(info.iterations) for info in infos)))
                self.last_plan.warm_lambda = [info.final_lambda for info in infos]
        # solved intrinsics go into the group's models only where the options
        # freed them; otherwise the leaves are the entry models' own
        write_models = self._options.any_intrinsics
        with PerformanceMeasure("relax writeback"):
            for params, i in zip(solved, live):
                g = self._groups[i]
                self._surfaces[i] = apply_solution(builts[i], params, g.poses, g.cam_models if write_models else None)

    def finalize(self, graph: MeasurementGraph, model_store: Dict[int, CameraModel],
                 refit: bool = True) -> List[int]:
        """Write the relaxed poses back to the graph and, after a relax with
        intrinsics, the groups' camera models into ``model_store``; then
        ``refit`` fits every edge again with the new models. The pipeline
        passes ``refit=False`` and refits once at the end of
        CAMERA_PARAMETER_RELAX, which also keeps the cached problem structure
        valid across the option tiers."""
        optimized = []
        model_changed = self._options.any_intrinsics
        for g in self._groups:
            for pose in g.poses:
                if g.write_ids is not None and pose.node_id not in g.write_ids:
                    continue  # a halo duplicate: its home group writes it
                node = graph.get_node(pose.node_id)
                if node is None:
                    continue
                node.payload.orientation = pose.orientation
                node.payload.position = pose.position
                optimized.append(pose.node_id)
            if model_changed:
                model_store.update(g.cam_models)
        if model_changed and refit:
            refit_all_edges(graph, model_store, dtype=self.dtype, device=self.device)
        self._groups = []
        return sorted(set(optimized))

    def surfaces(self) -> List[SurfaceModel]:
        return self._surfaces


REFIT_ROUNDS = 3


def _refit_edges_batch(px1, px2, valid, w0, models1: CameraModel, models2: CameraModel):
    """A bucket of E edges at once: undistort the matches [E, N, 2] to rays,
    then REFIT_ROUNDS times fit the weighted homography and take the matches
    under the inlier threshold as the next weights; decompose the last fit
    into its four poses and score them. Returns (H [E, 3, 3], inliers [E, N],
    quats [E, 4, 4], t_src [E, 4, 3], scores [E, 4]), candidates in the
    decomposition's order."""
    with full_fp32():
        r1, r2 = D.distort_keypoints(px1, px2, models1, models2)
        p1, p2 = M.hnormalize(r1), M.hnormalize(r2)
        w = w0
        for _ in range(REFIT_ROUNDS):
            Hm = M.homography_fit_weighted(p1, p2, w)
            err = M.homography_error(Hm, p1, p2)
            w = ((err < M.HOMOGRAPHY_INLIER_THRESHOLD) & valid).to(w0.dtype)
        Rs, ts, nrm, _ = M.homography_decompose(Hm)
        scores = M.score_homography_poses(Rs, ts, nrm, r1, r2, w)
        quats = M.poses_to_quaternions(Rs)
        t_src = -(Rs.transpose(-1, -2) @ ts[..., None])[..., 0]
    return Hm, w > 0, quats, t_src, scores


def refit_all_edges(graph: MeasurementGraph, model_store: Dict[int, CameraModel], *, dtype, device):
    """Fit every edge's homography again from its previous inliers after the
    camera models changed: a deterministic three-round refit over all of the
    edge's matches, bucketed by padded match count, one device call a bucket.
    An edge keeps its new inliers when more than 6 remain and its best pose
    scores above 0; otherwise its inlier lists are emptied."""
    with PerformanceMeasure("refit all edges"):
        _refit_all_edges(graph, model_store, dtype, resolve_device(device))


def _refit_all_edges(graph, model_store, dtype, device):
    entries = []
    for _, e in sorted(graph.edges()):
        rel = e.payload
        n = len(rel.match_idx1)
        if n == 0:
            continue
        ns, nd = graph.get_node(e.source), graph.get_node(e.dest)
        px1 = ns.payload.features.xy[rel.match_idx1]
        px2 = nd.payload.features.xy[rel.match_idx2]
        inliers = np.zeros(n, bool)
        inliers[rel.inlier_match_index[rel.inlier_match_index < n]] = True
        if inliers.sum() < 4:
            continue
        entries.append((e, n, px1, px2, inliers, model_store[ns.payload.model_id], model_store[nd.payload.model_id]))

    buckets: Dict[int, list] = {}
    for entry in entries:
        buckets.setdefault(_bucket(entry[1], minimum=16), []).append(entry)

    def on_device(m: CameraModel) -> CameraModel:
        return m.map(lambda x: x.to(device=device, dtype=dtype))

    for nb in sorted(buckets):
        group = buckets[nb]
        padded = group + [group[-1]] * (_bucket(len(group), minimum=1) - len(group))

        def stacked(rows, fill=0):
            return torch.as_tensor(np.stack([_pad_rows(r, nb, fill=fill) for r in rows]), device=device)

        out = _refit_edges_batch(
            stacked([g[2].astype(np.float64) for g in padded]).to(dtype),
            stacked([g[3].astype(np.float64) for g in padded]).to(dtype),
            stacked([np.ones(g[1], bool) for g in padded], fill=False),
            stacked([g[4].astype(np.float64) for g in padded]).to(dtype),
            stack_cameras([on_device(g[5]) for g in padded]),
            stack_cameras([on_device(g[6]) for g in padded]),
        )
        Hm_b, inl_b, quats_b, t_b, scores_b = (interop.to_numpy(t) for t in out)
        for i, (e, n, epx1, epx2, _, _, _) in enumerate(group):
            rel = e.payload
            inl = inl_b[i, :n]
            scores = scores_b[i]
            rel.ransac_relation = Hm_b[i].astype(np.float64)
            rel.relation_type = RelationType.HOMOGRAPHY
            order = np.argsort(-scores, kind="stable")
            rel.rel_quats = quats_b[i][order]
            rel.rel_positions = t_b[i][order]
            rel.rel_scores = scores[order]
            if inl.sum() > 4 * 1.5 and scores[order[0]] > 0:
                keep = np.where(inl)[0]
                rel.inlier_idx1 = rel.match_idx1[keep]
                rel.inlier_idx2 = rel.match_idx2[keep]
                rel.inlier_pixel1 = epx1[keep]
                rel.inlier_pixel2 = epx2[keep]
                rel.inlier_match_index = keep.astype(np.int32)
            else:
                rel.inlier_idx1 = np.zeros(0, np.int32)
                rel.inlier_idx2 = np.zeros(0, np.int32)
                rel.inlier_pixel1 = np.zeros((0, 2))
                rel.inlier_pixel2 = np.zeros((0, 2))
                rel.inlier_match_index = np.zeros(0, np.int32)
