"""Reference-format graph.json interchange (twin of
opencalibration_tpu/io/interchange.py; a copy but for the camera models,
which are the port's float64 ``CameraModel``s, and the base64 thumbnails,
which go through the port's own PNG codec, ``io/png.py``).

Reads and writes the EXACT checkpoint graph schema of the reference
implementation (reference src/io/serialize_MeasurementGraph.cpp:210-608 /
deserialize_MeasurementGraph.cpp), so features, descriptors, matches and
poses produced by one implementation can be consumed by the other:

* node objects keyed by decimal id: path, position[3], orientation as
  Eigen coeffs order (x, y, z, w) (serialize_MeasurementGraph.cpp:250-257),
  base64-PNG thumbnail, camera model {id, dimensions, focal_length,
  principal, radial_distortion, tangential_distortion, projection},
  metadata {camera_info, capture_info}, features as
  [{location, strength, descriptor}] with the 486-bit descriptor packed
  LSB-first into 61 bytes then base64 (bitset_to_bytes,
  serialize_MeasurementGraph.cpp:20-27), num_sparse_features;
* edge objects keyed by decimal id: source/dest as STRINGS, matches
  [[i1, i2, distance]], inlier_matches [[[px1], [px2], i1, i2,
  match_index]], relation (row-major 3x3), relation_type,
  relative_pose [{score, orientation(xyzw), position}].

Quaternion convention bridge: this package stores (w, x, y, z); the file
stores Eigen coeffs (x, y, z, w). Descriptor bridge: both pack bit j at
word/byte j>>k LSB-first, so the 61 reference bytes zero-extended to 64
reinterpret exactly as our [16] uint32 words.
"""

from __future__ import annotations

import base64
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from opencalibration_tpu_torch.io.png import decode_png, encode_png
from opencalibration_tpu_torch.types.camera import CameraModel
from opencalibration_tpu_torch.types.graph import (
    CameraRelations,
    FeatureSet,
    ImageMetadata,
    ImageNode,
    MeasurementGraph,
    RelationType,
)

DESCRIPTOR_BITS = 486
DESCRIPTOR_BYTES = (DESCRIPTOR_BITS + 7) // 8  # 61
DESCRIPTOR_WORDS = 16


def _wxyz_from_coeffs(c) -> np.ndarray:
    c = np.asarray(c, np.float64)
    return np.array([c[3], c[0], c[1], c[2]])


def _coeffs_from_wxyz(q) -> list:
    q = np.asarray(q, np.float64)
    return [float(q[1]), float(q[2]), float(q[3]), float(q[0])]


def _desc_from_b64(s: str) -> np.ndarray:
    raw = base64.b64decode(s)
    buf = raw[:DESCRIPTOR_BYTES].ljust(DESCRIPTOR_WORDS * 4, b"\0")
    return np.frombuffer(buf, "<u4").copy()


def _desc_to_b64(words: np.ndarray) -> str:
    raw = np.asarray(words, "<u4").tobytes()[:DESCRIPTOR_BYTES]
    return base64.b64encode(raw).decode("ascii")


def _png_from_b64(s: Optional[str]):
    if not s:
        return None
    return decode_png(base64.b64decode(s))


def _png_to_b64(img) -> str:
    if img is None:
        return ""
    return base64.b64encode(encode_png(img)).decode("ascii")


_RELATION_NAMES = {
    RelationType.HOMOGRAPHY: "homography",
    RelationType.FUNDAMENTAL_MATRIX: "fundamental_matrix",
}
_RELATION_VALUES = {v: k for k, v in _RELATION_NAMES.items()}


def load_reference_graph(
    text: str, pad_features_to: Optional[int] = None
) -> Tuple[MeasurementGraph, Dict[int, CameraModel]]:
    """Parse a reference-format graph.json into a MeasurementGraph +
    model store. Feature lists become padded FeatureSets (optionally to
    ``pad_features_to`` rows for fixed device shapes)."""
    data = json.loads(text)
    if int(data.get("version", -1)) != 1:
        raise ValueError(f"unsupported reference graph version {data.get('version')}")
    graph = MeasurementGraph(seed=0)
    model_store: Dict[int, CameraModel] = {}

    for nid_s, nd in sorted(data["nodes"].items(), key=lambda kv: int(kv[0])):
        md = ImageMetadata()
        m = nd.get("metadata", {})
        ci = m.get("camera_info", {})
        cap = m.get("capture_info", {})
        md.width_px = int(ci.get("dimensions", [0, 0])[0])
        md.height_px = int(ci.get("dimensions", [0, 0])[1])
        md.focal_length_px = float(ci.get("focal_length_px", float("nan")))
        md.principal_point_px = tuple(ci.get("principal", (float("nan"),) * 2))
        md.camera_make = ci.get("make", "")
        md.camera_model = ci.get("model", "")
        md.lens_model = ci.get("lens_model", "")
        md.latitude = float(cap.get("latitude", float("nan")))
        md.longitude = float(cap.get("longitude", float("nan")))
        md.altitude = float(cap.get("altitude", float("nan")))
        md.relative_altitude = float(cap.get("relative_altitude", float("nan")))
        md.gps_accuracy_xy = float(cap.get("accuracy_xy", float("nan")))
        md.gps_accuracy_z = float(cap.get("accuracy_z", float("nan")))

        model = nd.get("model", {})
        model_id = int(model.get("id", 0))
        if model_id not in model_store and model:
            model_store[model_id] = CameraModel.create(
                focal_length_pixels=float(model.get("focal_length", 1.0)),
                principal_point=tuple(model.get("principal", (0.0, 0.0))),
                radial_distortion=tuple(
                    model.get("radial_distortion", (0.0, 0.0, 0.0))
                ),
                tangential_distortion=tuple(
                    model.get("tangential_distortion", (0.0, 0.0))
                ),
                pixels_cols=float(model.get("dimensions", [0, 0])[0]),
                pixels_rows=float(model.get("dimensions", [0, 0])[1]),
                dtype=torch.float64,
                device="cpu",
            )

        feats = nd.get("features", [])
        n = len(feats)
        k = max(n, 1) if pad_features_to is None else max(pad_features_to, n)
        xy = np.zeros((k, 2), np.float32)
        strength = np.zeros(k, np.float32)
        desc = np.zeros((k, DESCRIPTOR_WORDS), np.uint32)
        valid = np.zeros(k, bool)
        for i, f in enumerate(feats):
            xy[i] = f["location"]
            strength[i] = f["strength"]
            desc[i] = _desc_from_b64(f["descriptor"])
            valid[i] = True

        node = ImageNode(
            path=nd.get("path", ""),
            metadata=md,
            model_id=model_id,
            position=np.asarray(nd.get("position", [np.nan] * 3), np.float64),
            orientation=_wxyz_from_coeffs(nd.get("orientation", [0, 0, 0, 1])),
            thumbnail=_png_from_b64(nd.get("thumbnail")),
        )
        node.features = FeatureSet(
            xy=xy, strength=strength, descriptors=desc, valid=valid,
            num_sparse=int(nd.get("num_sparse_features", n)),
        )
        new_id = graph.add_node(node)
        graph._nodes[int(nid_s)] = graph._nodes.pop(new_id)

    for eid_s, ed in sorted(data.get("edges", {}).items(), key=lambda kv: int(kv[0])):
        matches = ed.get("matches", [])
        inliers = ed.get("inlier_matches", [])
        rel = CameraRelations()
        rel.match_idx1 = np.asarray([m[0] for m in matches], np.int32)
        rel.match_idx2 = np.asarray([m[1] for m in matches], np.int32)
        rel.match_distance = np.asarray([m[2] for m in matches], np.float32)
        rel.inlier_pixel1 = np.asarray([p[0] for p in inliers], np.float64).reshape(-1, 2)
        rel.inlier_pixel2 = np.asarray([p[1] for p in inliers], np.float64).reshape(-1, 2)
        rel.inlier_idx1 = np.asarray([p[2] for p in inliers], np.int32)
        rel.inlier_idx2 = np.asarray([p[3] for p in inliers], np.int32)
        rel.inlier_match_index = np.asarray([p[4] for p in inliers], np.int32)
        rel.ransac_relation = np.asarray(
            ed.get("relation", [np.nan] * 9), np.float64
        ).reshape(3, 3)
        rel.relation_type = _RELATION_VALUES.get(
            ed.get("relation_type", "UNKNOWN"), RelationType.UNKNOWN
        )
        poses = ed.get("relative_pose", [])
        rel.rel_quats = np.stack(
            [_wxyz_from_coeffs(p["orientation"]) for p in poses]
        ) if poses else np.zeros((0, 4))
        rel.rel_positions = np.asarray(
            [p["position"] for p in poses], np.float64
        ).reshape(-1, 3)
        rel.rel_scores = np.asarray(
            [p.get("score", 0) for p in poses], np.float64
        )
        source, dest = int(ed["source"]), int(ed["dest"])
        new_id = graph.add_edge(rel, source, dest)
        edge = graph._edges.pop(new_id)
        graph._edges[int(eid_s)] = edge
        graph._sourcedest_to_edge[(source, dest)] = int(eid_s)
        for nid in (source, dest):
            n = graph._nodes[nid]
            n._edges.discard(new_id)
            n._edges.add(int(eid_s))
    return graph, model_store


def save_reference_graph(
    graph: MeasurementGraph, model_store: Dict[int, CameraModel]
) -> str:
    """Serialize to the reference graph.json schema (so reference tools
    can consume our checkpoints)."""
    nodes = {}
    for nid, node in sorted(graph.nodes()):
        p = node.payload
        md = p.metadata
        model = model_store.get(p.model_id)
        feats = []
        if p.features is not None:
            f = p.features
            count = int(np.sum(f.valid)) if f.valid is not None else len(f.xy)
            for i in range(len(f.xy)):
                if f.valid is not None and not f.valid[i]:
                    continue
                feats.append(
                    dict(
                        location=[float(f.xy[i, 0]), float(f.xy[i, 1])],
                        strength=float(f.strength[i]),
                        descriptor=_desc_to_b64(f.descriptors[i]),
                    )
                )
            del count
        nodes[str(nid)] = dict(
            path=p.path,
            position=[float(x) for x in np.asarray(p.position, np.float64)],
            orientation=_coeffs_from_wxyz(p.orientation),
            thumbnail=_png_to_b64(p.thumbnail),
            model=dict(
                id=p.model_id,
                dimensions=[
                    int(float(model.pixels_cols)) if model is not None else md.width_px,
                    int(float(model.pixels_rows)) if model is not None else md.height_px,
                ],
                focal_length=float(model.focal_length_pixels) if model is not None else md.focal_length_px,
                principal=[float(x) for x in np.asarray(model.principal_point)] if model is not None else [0.0, 0.0],
                radial_distortion=[float(x) for x in np.asarray(model.radial_distortion)] if model is not None else [0.0] * 3,
                tangential_distortion=[float(x) for x in np.asarray(model.tangential_distortion)] if model is not None else [0.0] * 2,
                projection="planar",
            ),
            edges=[str(e) for e in sorted(node.edges)],
            metadata=dict(
                camera_info=dict(
                    dimensions=[md.width_px, md.height_px],
                    focal_length_px=md.focal_length_px
                    if np.isfinite(md.focal_length_px or np.nan)
                    else 0.0,
                    principal=[
                        float(x) if np.isfinite(x) else 0.0
                        for x in md.principal_point_px
                    ],
                    make=md.camera_make or "",
                    model=md.camera_model or "",
                    serial_no="",
                    lens_make="",
                    lens_model=md.lens_model or "",
                ),
                capture_info=dict(
                    latitude=md.latitude, longitude=md.longitude,
                    altitude=md.altitude,
                    relative_altitude=md.relative_altitude
                    if np.isfinite(md.relative_altitude or np.nan)
                    else 0.0,
                    roll=0.0, pitch=0.0, yaw=0.0,
                    accuracy_xy=md.gps_accuracy_xy
                    if np.isfinite(md.gps_accuracy_xy or np.nan)
                    else 0.0,
                    accuracy_z=md.gps_accuracy_z
                    if np.isfinite(md.gps_accuracy_z or np.nan)
                    else 0.0,
                    datum="WGS84", timestamp="", datestamp="",
                ),
            ),
            features=feats,
            num_sparse_features=int(p.features.num_sparse)
            if p.features is not None
            else 0,
        )
    edges = {}
    for eid, e in sorted(graph.edges()):
        r = e.payload
        edges[str(eid)] = dict(
            source=str(e.source),
            dest=str(e.dest),
            matches=[
                [int(a), int(b), float(d)]
                for a, b, d in zip(r.match_idx1, r.match_idx2, r.match_distance)
            ],
            inlier_matches=[
                [
                    [float(r.inlier_pixel1[i, 0]), float(r.inlier_pixel1[i, 1])],
                    [float(r.inlier_pixel2[i, 0]), float(r.inlier_pixel2[i, 1])],
                    int(r.inlier_idx1[i]),
                    int(r.inlier_idx2[i]),
                    int(r.inlier_match_index[i]),
                ]
                for i in range(len(r.inlier_idx1))
            ],
            relation=[float(x) for x in np.asarray(r.ransac_relation).reshape(-1)],
            relation_type=_RELATION_NAMES.get(r.relation_type, "UNKNOWN"),
            relative_pose=[
                dict(
                    score=int(round(float(s))),
                    orientation=_coeffs_from_wxyz(q),
                    position=[float(x) for x in t],
                )
                for q, t, s in zip(r.rel_quats, r.rel_positions, r.rel_scores)
            ],
        )
    return json.dumps(dict(version=1, nodes=nodes, edges=edges))
