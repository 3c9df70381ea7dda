"""The program's answers, read out of a pipeline as plain numpy for the
reference: what the timed path produced, nothing that it did not."""

from __future__ import annotations

import numpy as np


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if hasattr(x, "detach") else x, np.float64)


def graph_answers(pipeline, paths) -> dict:
    """Per image (by its index in flight order): local position, orientation
    (w, x, y, z), focal and principal point of its camera model; per edge:
    the two images, the four decomposed relative rotations and the inlier
    count; the first surface's mesh (vertices [V, 3]
    in the local frame, triangles [T, 3])."""
    k_of = {p: k for k, p in enumerate(paths)}
    nodes = {}
    id_to_k = {}
    for nid, node in pipeline.graph.nodes():
        p = node.payload
        k = k_of[p.path]
        id_to_k[nid] = k
        model = pipeline.model_store[p.model_id]
        nodes[k] = dict(position=_np(p.position), orientation=_np(p.orientation),
                        focal=float(_np(model.focal_length_pixels)), principal=_np(model.principal_point))
    edges = []
    for _, e in pipeline.graph.edges():
        rel = e.payload
        edges.append(dict(a=id_to_k[e.source], b=id_to_k[e.dest], quats=_np(rel.rel_quats),
                          inliers=int(len(rel.inlier_idx1))))
    mesh = next((s.mesh for s in pipeline.surfaces if s.mesh is not None), None)
    return dict(nodes=nodes, edges=edges, k_of_id=id_to_k,
                mesh=None if mesh is None else (_np(mesh.vertices), np.asarray(mesh.triangles, np.int64)))

