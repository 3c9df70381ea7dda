"""Measurement-graph serialization (JSON) and visualization exports (twin of
opencalibration_tpu/io/serialize.py).

The document is the one the JAX package writes (same keys, same array
encoding), so each package reads the other's file. Camera models are read as
float64 models on the host. Thumbnails are PNGs written and read by
``io/png.py`` (no OpenCV needed); a node without a thumbnail serialises as
null.

Covers the roles of reference src/io/serialize_MeasurementGraph.cpp /
deserialize_MeasurementGraph.cpp: a complete JSON round-trip of the graph
(nodes with metadata, padded feature arrays with base64 descriptors,
base64-PNG thumbnails, camera models; edges with matches, inliers, ransac
relation, relative poses) plus the GeoJSON graph visualization
(toVisualizedGeoJson, serialize_MeasurementGraph.cpp:98-200).

The schema is version-tagged; arrays are base64 little-endian, a compact
structural analogue of the reference's base64 bitset/PNG encoding.
"""

from __future__ import annotations

import base64
import json
from typing import Dict, Optional, Tuple

import numpy as np

import torch

from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.io.png import decode_png, encode_png
from opencalibration_tpu_torch.types.camera import CameraModel
from opencalibration_tpu_torch.types.graph import (
    CameraRelations,
    FeatureSet,
    ImageMetadata,
    ImageNode,
    MeasurementGraph,
)

VERSION = 1


def _enc(arr: Optional[np.ndarray]):
    if arr is None:
        return None
    arr = np.ascontiguousarray(arr)
    return dict(
        dtype=str(arr.dtype),
        shape=list(arr.shape),
        data=base64.b64encode(arr.tobytes()).decode("ascii"),
    )


def _dec(obj) -> Optional[np.ndarray]:
    if obj is None:
        return None
    buf = base64.b64decode(obj["data"])
    return np.frombuffer(buf, dtype=np.dtype(obj["dtype"])).reshape(obj["shape"]).copy()


def _enc_png(img: Optional[np.ndarray]):
    if img is None:
        return None
    return base64.b64encode(encode_png(img)).decode("ascii")


def _dec_png(s) -> Optional[np.ndarray]:
    if s is None:
        return None
    return decode_png(base64.b64decode(s))


def _metadata_to_json(md: ImageMetadata) -> dict:
    d = dict(md.__dict__)
    d["abs_orientation"] = (
        None if md.abs_orientation is None else list(map(float, md.abs_orientation))
    )
    d["principal_point_px"] = list(md.principal_point_px)
    return d


def _metadata_from_json(d: dict) -> ImageMetadata:
    md = ImageMetadata()
    for k, v in d.items():
        if k == "abs_orientation":
            md.abs_orientation = None if v is None else np.asarray(v)
        elif k == "principal_point_px":
            md.principal_point_px = tuple(v)
        elif hasattr(md, k):
            setattr(md, k, v)
    return md


def _camera_model_to_json(m: CameraModel) -> dict:
    return dict(
        focal_length_pixels=float(m.focal_length_pixels),
        principal_point=[float(x) for x in interop.to_numpy(m.principal_point)],
        radial_distortion=[float(x) for x in interop.to_numpy(m.radial_distortion)],
        tangential_distortion=[float(x) for x in interop.to_numpy(m.tangential_distortion)],
        pixels_cols=float(m.pixels_cols),
        pixels_rows=float(m.pixels_rows),
        tag=m.tag,
    )


def _camera_model_from_json(d: dict) -> CameraModel:
    return CameraModel.create(
        d["focal_length_pixels"], tuple(d["principal_point"]),
        tuple(d["radial_distortion"]), tuple(d["tangential_distortion"]),
        d["pixels_cols"], d["pixels_rows"], tag=d.get("tag", "forward"),
        dtype=torch.float64, device="cpu",
    )


def serialize_graph(
    graph: MeasurementGraph, model_store: Dict[int, CameraModel]
) -> str:
    nodes = {}
    for nid, node in sorted(graph.nodes()):
        p: ImageNode = node.payload
        feats = p.features
        nodes[str(nid)] = dict(
            path=p.path,
            metadata=_metadata_to_json(p.metadata),
            model_id=p.model_id,
            position=list(map(float, np.asarray(p.position, float))),
            orientation=list(map(float, np.asarray(p.orientation, float))),
            thumbnail=_enc_png(p.thumbnail),
            features=None
            if feats is None
            else dict(
                xy=_enc(feats.xy),
                strength=_enc(feats.strength),
                descriptors=_enc(feats.descriptors),
                valid=_enc(feats.valid),
                num_sparse=feats.num_sparse,
            ),
        )
    edges = {}
    for eid, e in sorted(graph.edges()):
        r: CameraRelations = e.payload
        edges[str(eid)] = dict(
            source=e.source,
            dest=e.dest,
            match_idx1=_enc(r.match_idx1),
            match_idx2=_enc(r.match_idx2),
            match_distance=_enc(r.match_distance),
            inlier_idx1=_enc(r.inlier_idx1),
            inlier_idx2=_enc(r.inlier_idx2),
            inlier_pixel1=_enc(r.inlier_pixel1),
            inlier_pixel2=_enc(r.inlier_pixel2),
            inlier_match_index=_enc(r.inlier_match_index),
            ransac_relation=_enc(np.asarray(r.ransac_relation)),
            relation_type=r.relation_type,
            rel_quats=_enc(np.asarray(r.rel_quats)),
            rel_positions=_enc(np.asarray(r.rel_positions)),
            rel_scores=_enc(np.asarray(r.rel_scores)),
        )
    models = {str(mid): _camera_model_to_json(m) for mid, m in sorted(model_store.items())}
    return json.dumps(
        dict(version=VERSION, nodes=nodes, edges=edges, camera_models=models)
    )


def deserialize_graph(
    text: str,
) -> Tuple[MeasurementGraph, Dict[int, CameraModel]]:
    data = json.loads(text)
    if data.get("version") != VERSION:
        raise ValueError(f"unsupported graph version {data.get('version')}")
    graph = MeasurementGraph(seed=0)
    id_map: Dict[int, int] = {}
    for nid_s, nd in sorted(data["nodes"].items(), key=lambda kv: int(kv[0])):
        node = ImageNode(
            path=nd["path"],
            metadata=_metadata_from_json(nd["metadata"]),
            model_id=nd["model_id"],
            position=np.asarray(nd["position"], float),
            orientation=np.asarray(nd["orientation"], float),
            thumbnail=_dec_png(nd.get("thumbnail")),
        )
        f = nd.get("features")
        if f is not None:
            node.features = FeatureSet(
                xy=_dec(f["xy"]),
                strength=_dec(f["strength"]),
                descriptors=_dec(f["descriptors"]),
                valid=_dec(f["valid"]),
                num_sparse=f["num_sparse"],
            )
        # preserve original ids exactly
        new_id = graph.add_node(node)
        graph._nodes[int(nid_s)] = graph._nodes.pop(new_id)
        id_map[int(nid_s)] = int(nid_s)
    for eid_s, ed in sorted(data["edges"].items(), key=lambda kv: int(kv[0])):
        rel = CameraRelations(
            match_idx1=_dec(ed["match_idx1"]),
            match_idx2=_dec(ed["match_idx2"]),
            match_distance=_dec(ed["match_distance"]),
            inlier_idx1=_dec(ed["inlier_idx1"]),
            inlier_idx2=_dec(ed["inlier_idx2"]),
            inlier_pixel1=_dec(ed["inlier_pixel1"]),
            inlier_pixel2=_dec(ed["inlier_pixel2"]),
            inlier_match_index=_dec(ed["inlier_match_index"]),
            ransac_relation=_dec(ed["ransac_relation"]),
            relation_type=ed["relation_type"],
            rel_quats=_dec(ed["rel_quats"]),
            rel_positions=_dec(ed["rel_positions"]),
            rel_scores=_dec(ed["rel_scores"]),
        )
        new_id = graph.add_edge(rel, ed["source"], ed["dest"])
        edge = graph._edges.pop(new_id)
        graph._edges[int(eid_s)] = edge
        graph._sourcedest_to_edge[(ed["source"], ed["dest"])] = int(eid_s)
        for nid in (ed["source"], ed["dest"]):
            n = graph._nodes[nid]
            n._edges.discard(new_id)
            n._edges.add(int(eid_s))
    models = {
        int(mid): _camera_model_from_json(m)
        for mid, m in data.get("camera_models", {}).items()
    }
    return graph, models


def to_visualized_geojson(graph: MeasurementGraph, geocoord) -> str:
    """Camera positions + match links as GeoJSON
    (reference serialize_MeasurementGraph.cpp:98-200)."""
    features = []
    for nid, node in sorted(graph.nodes()):
        pos = np.asarray(node.payload.position, float)
        if not np.isfinite(pos).all() or not geocoord.is_initialized():
            continue
        wgs = geocoord.to_wgs84(pos)
        features.append(
            dict(
                type="Feature",
                geometry=dict(type="Point", coordinates=[float(wgs[1]), float(wgs[0])]),
                properties=dict(node_id=str(nid), path=node.payload.path, altitude=float(wgs[2])),
            )
        )
    for eid, e in sorted(graph.edges()):
        p1 = np.asarray(graph.get_node(e.source).payload.position, float)
        p2 = np.asarray(graph.get_node(e.dest).payload.position, float)
        if not (np.isfinite(p1).all() and np.isfinite(p2).all()):
            continue
        w1 = geocoord.to_wgs84(p1)
        w2 = geocoord.to_wgs84(p2)
        features.append(
            dict(
                type="Feature",
                geometry=dict(
                    type="LineString",
                    coordinates=[[float(w1[1]), float(w1[0])], [float(w2[1]), float(w2[0])]],
                ),
                properties=dict(
                    edge_id=str(eid),
                    inliers=int(len(e.payload.inlier_idx1)),
                ),
            )
        )
    return json.dumps(dict(type="FeatureCollection", features=features))
