"""Pipeline facade and state machine (twin of
opencalibration_tpu/pipeline/pipeline.py), through its first state.

``Pipeline(device=...)`` takes image paths with ``add`` and advances with
``iterate_once``. INITIAL_PROCESSING is software-pipelined across calls: batch
N loads while batch N-1 links and batch N-2 relaxes; the state repeats until
every image is loaded, linked and relaxed. The later states are not ported
yet and raise ``NotImplementedError`` naming their ROADMAP item.

The pipeline holds its device and the dtype of its relax problems
explicitly: float32 on a GPU, float64 where a parity test holds it against
the JAX package's x64 CPU run. Matching and RANSAC always run in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from opencalibration_tpu.geo.geo_coord import GeoCoord
from opencalibration_tpu.types.graph import MeasurementGraph, SurfaceModel
from opencalibration_tpu_torch.pipeline.stages import LinkStage, LoadStage, RelaxStage
from opencalibration_tpu_torch.relax.problem_builder import RelaxOptions
from opencalibration_tpu_torch.types.camera import CameraModel
from opencalibration_tpu_torch.utils.device import resolve_device
from opencalibration_tpu_torch.utils.performance import PerformanceMeasure


class PipelineState:
    INITIAL_PROCESSING = "INITIAL_PROCESSING"
    MESH_REFINEMENT = "MESH_REFINEMENT"
    INITIAL_GLOBAL_RELAX = "INITIAL_GLOBAL_RELAX"
    CAMERA_PARAMETER_RELAX = "CAMERA_PARAMETER_RELAX"
    FINAL_GLOBAL_RELAX = "FINAL_GLOBAL_RELAX"
    GENERATE_THUMBNAIL = "GENERATE_THUMBNAIL"
    DENSIFY_MESH = "DENSIFY_MESH"
    DENSE_MESH_RELAX = "DENSE_MESH_RELAX"
    GENERATE_LAYERS = "GENERATE_LAYERS"
    COLOR_BALANCE = "COLOR_BALANCE"
    BLEND_LAYERS = "BLEND_LAYERS"
    COMPLETE = "COMPLETE"

    ORDER = [
        INITIAL_PROCESSING, MESH_REFINEMENT, INITIAL_GLOBAL_RELAX,
        CAMERA_PARAMETER_RELAX, FINAL_GLOBAL_RELAX, GENERATE_THUMBNAIL,
        DENSIFY_MESH, DENSE_MESH_RELAX, GENERATE_LAYERS, COLOR_BALANCE,
        BLEND_LAYERS, COMPLETE,
    ]


# where each state not ported yet stands in ROADMAP.md (queue 1)
_NOT_PORTED = {
    PipelineState.MESH_REFINEMENT: "queue 1, B1 (MESH_REFINEMENT)",
    PipelineState.INITIAL_GLOBAL_RELAX: "queue 1, B4 (the global relax states)",
    PipelineState.CAMERA_PARAMETER_RELAX: "queue 1, B3 (CAMERA_PARAMETER_RELAX)",
    PipelineState.FINAL_GLOBAL_RELAX: "queue 1, B4 (the global relax states)",
    PipelineState.GENERATE_THUMBNAIL: "queue 1, Slice C (the ortho tail)",
    PipelineState.DENSIFY_MESH: "queue 1, Slice D (dense stereo)",
    PipelineState.DENSE_MESH_RELAX: "queue 1, Slice D (dense stereo)",
    PipelineState.GENERATE_LAYERS: "queue 1, Slice C (the ortho tail)",
    PipelineState.COLOR_BALANCE: "queue 1, Slice C (the ortho tail)",
    PipelineState.BLEND_LAYERS: "queue 1, Slice C (the ortho tail)",
    PipelineState.COMPLETE: "queue 1, Slice C (the ortho tail)",
}

# stage weights for global progress
_STAGE_WEIGHTS = {
    PipelineState.INITIAL_PROCESSING: 10.0,
    PipelineState.MESH_REFINEMENT: 1.0,
    PipelineState.INITIAL_GLOBAL_RELAX: 3.0,
    PipelineState.CAMERA_PARAMETER_RELAX: 3.0,
    PipelineState.FINAL_GLOBAL_RELAX: 3.0,
    PipelineState.GENERATE_THUMBNAIL: 1.0,
    PipelineState.DENSIFY_MESH: 2.0,
    PipelineState.DENSE_MESH_RELAX: 2.0,
    PipelineState.GENERATE_LAYERS: 4.0,
    PipelineState.COLOR_BALANCE: 1.0,
    PipelineState.BLEND_LAYERS: 4.0,
    PipelineState.COMPLETE: 0.0,
}


@dataclasses.dataclass
class StepCompletionInfo:
    """Progress payload passed to ``Pipeline.step_callback``."""

    state: str
    state_iteration: int
    loaded_ids: List[int]
    linked_ids: List[int]
    relaxed_ids: List[int]
    queue_size_remaining: int
    activity: str
    global_progress: float
    local_progress: float
    surfaces_updated: bool = False


class Pipeline:
    def __init__(self, batch_size: int = 10, parallelism: int = 8, *, device,
                 dtype=torch.float32, ransac_uniforms=None):
        """``device`` is required ('cuda' or 'cpu'); a CUDA device without a
        card raises. ``dtype`` is the relax problems' float type.
        ``ransac_uniforms`` [2048, 4] replaces the link's seeded RANSAC draw
        (parity tests pass the reference's)."""
        self.device = resolve_device(device)
        self.dtype = dtype
        self.batch_size = batch_size
        self.parallelism = parallelism
        self.overlap_io = True  # decode / link / relax of consecutive batches overlap
        self.graph: MeasurementGraph = MeasurementGraph(seed=0)
        self.geocoord = GeoCoord()
        self.model_store: Dict[int, CameraModel] = {}
        self._model_key_to_id: Dict[tuple, int] = {}
        self.gps_positions: Dict[int, np.ndarray] = {}
        self.surfaces: List[SurfaceModel] = []

        self._add_queue: List[str] = []
        self._state = PipelineState.INITIAL_PROCESSING
        self._state_run_count = 0

        self._load_stage = LoadStage(device=self.device)
        self._link_stage = LinkStage(device=self.device, uniforms=ransac_uniforms)
        self._relax_stage = RelaxStage(device=self.device, dtype=dtype)

        self._prev_loaded_ids: List[int] = []
        self._prev_linked_ids: List[int] = []
        self.step_callback: Optional[Callable[[StepCompletionInfo], None]] = None

    # --- public API -------------------------------------------------------
    def add(self, paths: Sequence[str]):
        self._add_queue.extend(paths)

    def get_state(self) -> str:
        return self._state

    def state_run_count(self) -> int:
        return self._state_run_count

    def reset_state(self, state: str, run_count: int = 0):
        self._state = state
        self._state_run_count = run_count

    def resume_from_state(self, target: str) -> bool:
        """Rewind only: a later state cannot be skipped to."""
        order = PipelineState.ORDER
        if order.index(target) <= order.index(self._state):
            self._state = target
            self._state_run_count = 0
            return True
        return False

    def iterate_once(self) -> str:
        state = self._state
        if state != PipelineState.INITIAL_PROCESSING:
            raise NotImplementedError(
                f"pipeline state {state} is not ported yet: ROADMAP {_NOT_PORTED[state]}"
            )
        with PerformanceMeasure(f"state {state}"):
            transition = self._run_initial_processing()
        if transition == "NEXT":
            self._state = PipelineState.ORDER[PipelineState.ORDER.index(state) + 1]
            self._state_run_count = 0
        else:
            self._state_run_count += 1
        return self._state

    def run_to_completion(self, max_iterations: int = 10000) -> str:
        """Iterate to COMPLETE; raises at the first state not ported yet."""
        for _ in range(max_iterations):
            if self._state == PipelineState.COMPLETE:
                break
            self.iterate_once()
        return self._state

    # --- progress ---------------------------------------------------------
    def _emit(self, loaded, linked, relaxed, activity, local=1.0, surfaces_updated=False):
        if self.step_callback is None:
            return
        order = PipelineState.ORDER
        total = sum(_STAGE_WEIGHTS.values())
        done = sum(_STAGE_WEIGHTS[s] for s in order[: order.index(self._state)])
        current = _STAGE_WEIGHTS[self._state] * max(0.0, min(1.0, local))
        self.step_callback(StepCompletionInfo(
            state=self._state,
            state_iteration=self._state_run_count,
            loaded_ids=list(loaded),
            linked_ids=list(linked),
            relaxed_ids=list(relaxed),
            queue_size_remaining=len(self._add_queue),
            activity=activity,
            global_progress=(done + current) / total,
            local_progress=local,
            surfaces_updated=surfaces_updated,
        ))

    # --- states -----------------------------------------------------------
    def _run_initial_processing(self) -> str:
        batch = self._add_queue[: self.batch_size]
        self._add_queue = self._add_queue[len(batch):]

        self._load_stage.init(batch)
        self._link_stage.init(self.graph, self.gps_positions, self._prev_loaded_ids)
        self._relax_stage.init(
            self.graph, self._prev_linked_ids, self.gps_positions, self.model_store,
            options=RelaxOptions(orientation=True, ground_plane=True),
        )

        # batch N decodes on host threads while batch N-2's relax problems
        # are built and batch N-1's link work is enqueued on the device; the
        # relax solves, then batch N's extraction runs. overlap_io=False runs
        # the stages one after another (same results).
        if self.overlap_io:
            self._load_stage.start_decode(self.parallelism)
            with PerformanceMeasure("ip: relax dispatch"):
                self._relax_stage.dispatch(self.graph)
            with PerformanceMeasure("ip: link run"):
                self._link_stage.run(self.graph, self.model_store)
            with PerformanceMeasure("ip: relax run"):
                self._relax_stage.join()
            with PerformanceMeasure("ip: load finish"):
                self._load_stage.finish()
        else:
            with PerformanceMeasure("ip: load run"):
                self._load_stage.run(self.parallelism)
            with PerformanceMeasure("ip: link run"):
                self._link_stage.run(self.graph, self.model_store)
            with PerformanceMeasure("ip: relax run"):
                self._relax_stage.run_all(self.graph)

        with PerformanceMeasure("ip: load finalize"):
            loaded = self._load_stage.finalize(
                self.graph, self.geocoord, self.model_store, self._model_key_to_id, self.gps_positions
            )
        with PerformanceMeasure("ip: link finalize"):
            linked = self._link_stage.finalize(self.graph)
        with PerformanceMeasure("ip: relax finalize"):
            relaxed = self._relax_stage.finalize(self.graph)
        new_surfaces = [s for s in self._relax_stage.surfaces() if s.mesh is not None or s.cloud]
        if new_surfaces:
            self.surfaces = self._merge_group_surfaces(new_surfaces)

        total = self.graph.size_nodes() + len(self._add_queue)
        self._emit(loaded, linked, relaxed, "initial processing",
                   self.graph.size_nodes() / total if total else 1.0)

        self._prev_loaded_ids = loaded
        self._prev_linked_ids = linked
        if self._add_queue or loaded or linked:
            return "REPEAT"
        return "NEXT"

    @staticmethod
    def _merge_group_surfaces(surfaces: List[SurfaceModel]) -> List[SurfaceModel]:
        """Per-group surfaces over the same mesh topology merge into one,
        vertex heights weighted by each group's point support."""
        if len(surfaces) <= 1:
            return surfaces
        from opencalibration_tpu.surface.refine import merge_surface_models

        merged = merge_surface_models(surfaces)
        return [merged] if merged is not None else surfaces
