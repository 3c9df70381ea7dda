"""Carry state between the JAX package's containers and the port's.

Inputs are read through ``numpy.asarray``, so any array the JAX package holds
(numpy or device arrays) converts without this module importing JAX. Going
back, the functions return plain dicts of numpy arrays that the JAX
package's constructors take as keyword arguments, e.g.
``CameraModel(**camera_to_numpy(m))``.

Packed descriptors are uint32 on the JAX side and int32 bit patterns here;
the conversion is a reinterpretation of the same bits in both directions.

The host containers (measurement graph, its node and edge payloads, node
poses, surface models and meshes) are read by attribute and rebuilt, with
copied arrays, from a ``types.graph`` module and a mesh class: the port's own
by default, the JAX package's when a test passes them in to go back. A camera
model store and a relax option set cross the same way, and so do the
orthomosaic's containers: a thumbnail ``OrthoMosaic``, a list of
``ColorCorrespondence`` and a ``ColorBalanceResult``. Nodes carry their Lab
thumbnails. A stacked relax batch (``GroupBatch``: params, blocks with the
port's residual functions, masks, layout, warm damping) and a solve's
``SolveInfo``, per lane or not, cross into the port for a solve there.
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


def model_store_from(models: dict, device="cpu") -> dict:
    """A JAX-package model store {model id: CameraModel} -> the port's, each
    model in its own dtype on ``device`` (the pipeline keeps its store on the
    host)."""
    return {mid: camera_from(m, device) for mid, m in models.items()}


def model_store_to_numpy(models: dict) -> dict:
    """The port's model store -> {model id: keyword arguments of numpy
    leaves} for the JAX package's ``CameraModel``."""
    return {mid: camera_to_numpy(m) for mid, m in models.items()}


def relax_options_from(options, cls=None):
    """A relax option set -> ``cls`` (the port's ``RelaxOptions`` by
    default), by the fields both have."""
    if cls is None:
        from opencalibration_tpu_torch.relax.problem_builder import RelaxOptions as cls
    return cls(**{f.name: getattr(options, f.name) for f in dataclasses.fields(cls) if hasattr(options, f.name)})


def node_poses_from(poses, types=_graph) -> list:
    """A list of ``NodePose`` -> ``types.NodePose`` with copied arrays."""
    return [types.NodePose(node_id=p.node_id, orientation=np.array(p.orientation, np.float64),
                           position=np.array(p.position, np.float64)) for p in poses]


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


def _port_resid(blk):
    """The port's residual function of ``blk``'s family (the plane-ray
    family by its ray variant)."""
    from opencalibration_tpu_torch.relax import blocks as B

    if blk.name == "plane_ray":
        return B._make_plane_ray_resid("pixel" in blk.data)
    return {
        "decomposed_rotation": B._decomposed_rotation_resid, "downwards_prior": B._downwards_resid,
        "pixel_error": B._pixel_error_resid, "mesh_flat": B._difference_resid, "mesh_anchor": B._difference_resid,
        "mesh_smooth": B._smooth_resid, "monotonicity": B._monotonicity_resid,
    }[blk.name]


def block_from(blk, device):
    """A ``BlockSpec`` (leaves with or without a leading group axis) -> the
    port's, with the port's residual function of its family."""
    from opencalibration_tpu_torch.relax.blocks import BlockSpec

    return BlockSpec(
        slots=to_torch(blk.slots, device, torch.int64), data=block_data_from(blk.data, device),
        weight=to_torch(blk.weight, device), resid_one=_port_resid(blk), num_residuals=blk.num_residuals,
        huber_delta=blk.huber_delta, name=blk.name,
    )


def group_batch_from(batch, device):
    """A stacked ``GroupBatch`` -> the port's: params, blocks, masks, layout,
    model permutations and warm damping. The built problems stay behind
    (``builts`` is empty): the batch solves, it does not write back."""
    from opencalibration_tpu_torch.parallel.group_solver import GroupBatch
    from opencalibration_tpu_torch.relax.tangent import TangentLayout

    lay = batch.layout
    warm = None
    if batch.warm_lambda is not None:
        warm = tuple(None if w is None else to_torch(w, device) for w in batch.warm_lambda)
    return GroupBatch(
        params=relax_params_from(batch.params, device), blocks=tuple(block_from(b, device) for b in batch.blocks),
        free=to_torch(batch.free, device, torch.bool), surface_free=to_torch(batch.surface_free, device, torch.bool),
        layout=TangentLayout(lay.C, lay.V, lay.P, lay.M), builts=[], num_groups=batch.num_groups,
        shared_intrinsics=batch.shared_intrinsics,
        model_perms=None if batch.model_perms is None else [None if m is None else np.array(m)
                                                             for m in batch.model_perms],
        warm_lambda=warm,
    )


def solve_info_from(info, device):
    """A ``SolveInfo`` (0-d leaves, or [G] of a batched solve) -> the port's."""
    from opencalibration_tpu_torch.relax.lm import SolveInfo

    return SolveInfo(**{f.name: to_torch(getattr(info, f.name), device) for f in dataclasses.fields(SolveInfo)})


def solve_info_to_numpy(info) -> dict:
    return {f.name: to_numpy(getattr(info, f.name)) for f in dataclasses.fields(info)}


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


def ortho_mosaic_from(mosaic, cls=None):
    """An ``OrthoMosaic`` -> ``cls`` (the port's by default), arrays copied."""
    if cls is None:
        from opencalibration_tpu_torch.ortho.ortho import OrthoMosaic as cls
    return _rebuild(mosaic, cls)


def color_correspondences_from(correspondences, cls=None) -> list:
    """A list of ``ColorCorrespondence`` -> a list of ``cls`` (the port's by
    default)."""
    if cls is None:
        from opencalibration_tpu_torch.ortho.color_balance import ColorCorrespondence as cls
    return [_rebuild(c, cls) for c in correspondences]


def color_balance_from(result, module=None):
    """A ``ColorBalanceResult`` -> ``module.ColorBalanceResult`` with
    ``module.RadiometricParams`` per image (``module`` is the port's
    ``ortho.color_balance`` by default)."""
    if module is None:
        from opencalibration_tpu_torch.ortho import color_balance as module
    return module.ColorBalanceResult(
        per_image_params={k: _rebuild(v, module.RadiometricParams) for k, v in result.per_image_params.items()},
        per_model_vignetting={k: np.array(v) for k, v in result.per_model_vignetting.items()},
        success=result.success,
        final_cost=result.final_cost,
    )
