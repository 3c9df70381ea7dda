"""Checkpoint / resume (a copy of opencalibration_tpu/io/checkpoint.py that
differs only in its imports; the directory it writes is read by either
package).

Directory format mirroring reference src/io/checkpoint.cpp:162-315:
  metadata.json   {version, state, state_run_count, origin_lat/lon, counts}
  graph.json      full measurement graph + camera models
  surface_<i>.ply mesh of surface i
  pointcloud_<i>_<j>.xyz  cloud j of surface i
"""

from __future__ import annotations

import json
import os
import numpy as np

from opencalibration_tpu_torch.io.mesh_io import load_ply, load_xyz, save_ply, save_xyz
from opencalibration_tpu_torch.io.serialize import deserialize_graph, serialize_graph
from opencalibration_tpu_torch.types.graph import SurfaceModel

CHECKPOINT_VERSION = 1


def save_checkpoint(directory: str, pipeline) -> bool:
    os.makedirs(directory, exist_ok=True)
    lat, lon = pipeline.geocoord.origin
    surfaces = pipeline.surfaces
    meta = dict(
        version=CHECKPOINT_VERSION,
        state=pipeline.get_state(),
        state_run_count=pipeline.state_run_count(),
        origin_latitude=lat if np.isfinite(lat) else None,
        origin_longitude=lon if np.isfinite(lon) else None,
        num_surfaces=len(surfaces),
        cloud_counts=[len(s.cloud) for s in surfaces],
    )
    with open(os.path.join(directory, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
    with open(os.path.join(directory, "graph.json"), "w") as f:
        f.write(serialize_graph(pipeline.graph, pipeline.model_store))
    for i, s in enumerate(surfaces):
        if s.mesh is not None:
            save_ply(os.path.join(directory, f"surface_{i}.ply"), s.mesh)
        for j, cloud in enumerate(s.cloud):
            save_xyz(os.path.join(directory, f"pointcloud_{i}_{j}.xyz"), cloud)
    return True


def validate_checkpoint(directory: str) -> bool:
    meta_path = os.path.join(directory, "metadata.json")
    graph_path = os.path.join(directory, "graph.json")
    if not (os.path.exists(meta_path) and os.path.exists(graph_path)):
        return False
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError):
        return False
    return meta.get("version") == CHECKPOINT_VERSION


def load_checkpoint(directory: str, pipeline) -> bool:
    if not validate_checkpoint(directory):
        return False
    with open(os.path.join(directory, "metadata.json")) as f:
        meta = json.load(f)
    with open(os.path.join(directory, "graph.json")) as f:
        graph, models = deserialize_graph(f.read())
    pipeline.graph = graph
    pipeline.model_store = models
    if meta.get("origin_latitude") is not None:
        pipeline.geocoord.set_origin(
            meta["origin_latitude"], meta["origin_longitude"]
        )
    # rebuild the GPS position index (reference pipeline.cpp:1058-1068)
    pipeline.gps_positions = {}
    for nid, node in graph.nodes():
        pos = np.asarray(node.payload.position, float)
        if np.isfinite(pos[:2]).all():
            pipeline.gps_positions[nid] = pos[:2].copy()
    surfaces = []
    for i in range(meta.get("num_surfaces", 0)):
        s = SurfaceModel()
        ply = os.path.join(directory, f"surface_{i}.ply")
        if os.path.exists(ply):
            s.mesh = load_ply(ply)
        counts = meta.get("cloud_counts", [])
        n_clouds = counts[i] if i < len(counts) else 0
        for j in range(n_clouds):
            xyz = os.path.join(directory, f"pointcloud_{i}_{j}.xyz")
            if os.path.exists(xyz):
                s.cloud.append(load_xyz(xyz))
        surfaces.append(s)
    pipeline.surfaces = surfaces
    pipeline.reset_state(meta["state"], meta.get("state_run_count", 0))
    return True
