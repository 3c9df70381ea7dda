"""Carry state between the JAX package's containers and the port's.

Inputs are read through ``numpy.asarray``, so any array the JAX package holds
(numpy or device arrays) converts without this module importing JAX. Going
back, the functions return plain dicts of numpy arrays that the JAX
package's constructors take as keyword arguments, e.g.
``CameraModel(**camera_to_numpy(m))``.

Packed descriptors are uint32 on the JAX side and int32 bit patterns here;
the conversion is a reinterpretation of the same bits in both directions.

The host containers (measurement graph, its node and edge payloads, surface
models and meshes) are read by attribute and rebuilt, with copied arrays,
from a ``types.graph`` module and a mesh class: the port's own by default,
the JAX package's when a test passes them in to go back.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from opencalibration_tpu_torch.relax.tangent import FIELDS, RelaxParams
from opencalibration_tpu_torch.surface import mesh as _mesh
from opencalibration_tpu_torch.types import graph as _graph
from opencalibration_tpu_torch.types.camera import LEAVES, CameraModel


def to_torch(x, device, dtype=None) -> torch.Tensor:
    """numpy-convertible array -> tensor; uint32 becomes int32 bit patterns."""
    a = np.array(x)  # a writable copy; keeps 0-d arrays 0-d
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(a).to(device)
    return t if dtype is None else t.to(dtype)


def to_numpy(t: torch.Tensor, uint32: bool = False) -> np.ndarray:
    """tensor -> numpy; ``uint32=True`` reinterprets int32 words as uint32."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if uint32 else a


def camera_from(model, device) -> CameraModel:
    """A JAX ``CameraModel`` (or anything with its attributes) -> the port's."""
    return CameraModel(**{k: to_torch(getattr(model, k), device) for k in LEAVES}, tag=model.tag)


def camera_to_numpy(model: CameraModel) -> dict:
    return dict({k: to_numpy(getattr(model, k)) for k in LEAVES}, tag=model.tag)


def relax_params_from(params, device) -> RelaxParams:
    """A JAX ``RelaxParams`` -> the port's."""
    return RelaxParams(**{f: to_torch(getattr(params, f), device) for f in FIELDS})


def relax_params_to_numpy(params: RelaxParams) -> dict:
    return {f: to_numpy(getattr(params, f)) for f in FIELDS}


def block_data_from(data: dict, device) -> dict:
    """A ``BlockSpec.data`` dict -> tensors; integer ids become int64, the
    index type torch wants."""
    out = {}
    for k, v in data.items():
        t = to_torch(v, device)
        out[k] = t.to(torch.int64) if t.dtype == torch.int32 else t
    return out


def block_data_to_numpy(data: dict) -> dict:
    return {k: to_numpy(v) for k, v in data.items()}


def features_from(feats: dict, device) -> dict:
    """An ``extract_features`` dict -> tensors (descriptors as int32 words)."""
    return {k: to_torch(v, device) for k, v in feats.items()}


def features_to_numpy(feats: dict) -> dict:
    """The port's feature dict -> numpy, descriptors back to uint32."""
    return {k: to_numpy(v, uint32=(k == "descriptors")) for k, v in feats.items()}


def _rebuild(obj, cls, **converted):
    """A ``cls`` dataclass from ``obj``'s fields of the same names, deep-copied
    except those given in ``converted``."""
    kw = {f.name: copy.deepcopy(getattr(obj, f.name)) for f in dataclasses.fields(cls) if f.name not in converted}
    return cls(**kw, **converted)


def feature_set_from(features, types=_graph):
    """A ``FeatureSet`` -> ``types.FeatureSet``."""
    return _rebuild(features, types.FeatureSet)


def image_node_from(node, types=_graph):
    """An ``ImageNode`` (metadata and features included) -> ``types.ImageNode``."""
    features = None if node.features is None else feature_set_from(node.features, types)
    return _rebuild(node, types.ImageNode, metadata=_rebuild(node.metadata, types.ImageMetadata),
                    features=features)


def graph_from(graph, types=_graph):
    """A measurement graph -> one of ``types``, with the same node and edge
    ids in the same order and the same state of the id generator, so both
    go on to draw the same ids."""
    out = types.DirectedGraph()
    out._rng.bit_generator.state = copy.deepcopy(graph._rng.bit_generator.state)
    for node_id, node in graph.nodes():
        out._nodes[node_id] = types.GraphNode(image_node_from(node.payload, types))
        out._nodes[node_id]._edges = set(node.edges)
    for edge_id, edge in graph.edges():
        out._edges[edge_id] = types.GraphEdge(_rebuild(edge.payload, types.CameraRelations), edge.source, edge.dest)
        out._sourcedest_to_edge[(edge.source, edge.dest)] = edge_id
    return out


def mesh_from(mesh, mesh_cls=_mesh.TriMesh):
    """A triangle mesh -> ``mesh_cls`` (copied vertices and triangles)."""
    return mesh_cls(np.array(mesh.vertices), np.array(mesh.triangles))


def surface_from(surface, types=_graph, mesh_cls=_mesh.TriMesh):
    """A ``SurfaceModel`` (point clouds and mesh) -> ``types.SurfaceModel``."""
    mesh = None if surface.mesh is None else mesh_from(surface.mesh, mesh_cls)
    return types.SurfaceModel(cloud=[np.array(c) for c in surface.cloud], mesh=mesh)
