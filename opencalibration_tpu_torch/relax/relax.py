"""Problem dispatch from the option set (twin of ``build_problem`` in
opencalibration_tpu/relax/relax.py; problems are solved by
``parallel.group_solver.solve_groups``)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from opencalibration_tpu.types.graph import MeasurementGraph, NodePose, SurfaceModel
from opencalibration_tpu_torch.relax.problem_builder import (
    BuiltProblem,
    RelaxOptions,
    build_decomposition_problem,
    build_mesh_problem,
)
from opencalibration_tpu_torch.types.camera import CameraModel


def build_problem(
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
) -> Tuple[Optional[BuiltProblem], bool]:
    """Build (not solve) the relax problem of one working set. Returns
    (BuiltProblem or None, whether a surface-only pre-solve comes first).
    ``grid_fraction`` defaults to ``options.grid_fraction``."""
    if options.ground_mesh or options.ground_plane:
        built = build_mesh_problem(
            graph, node_poses, cam_models, edge_ids, options, previous_surfaces, grid_fraction,
            dtype=dtype, device=device,
        )
        return built, True
    if options.points_3d:
        raise NotImplementedError(
            "3-d point relax problems are not ported yet: ROADMAP queue 1, B9 (points builder)"
        )
    return build_decomposition_problem(graph, node_poses, edge_ids, dtype=dtype, device=device), False
