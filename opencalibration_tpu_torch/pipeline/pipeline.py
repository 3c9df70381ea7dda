"""Pipeline facade and state machine (twin of
opencalibration_tpu/pipeline/pipeline.py), from images to COMPLETE, with
checkpoints.

``Pipeline()`` (on the card; ``device="cpu"`` to run on the CPU) takes image
paths with ``add`` and advances with ``iterate_once``. INITIAL_PROCESSING is software-pipelined across calls: batch
N loads while batch N-1 links and batch N-2 relaxes; the state repeats until
every image is loaded, linked and relaxed. MESH_REFINEMENT then alternates a
ground-mesh relax with one point-density refinement of the mesh, level by
level; INITIAL_GLOBAL_RELAX (skipped by default) and FINAL_GLOBAL_RELAX run
the same ground-mesh relax over every image, reusing the problem structure
across their passes. CAMERA_PARAMETER_RELAX runs the same relax with the
camera intrinsics free, tier by tier (focal; then the radial terms one at a
time; then the principal point), over one cached problem structure, and
refits every edge once at its end. GENERATE_THUMBNAIL renders the thumbnail
mosaic; GENERATE_LAYERS, COLOR_BALANCE and BLEND_LAYERS write the DSM, the
colour-balanced blended orthomosaic, the camera-id raster and the textured
OBJ where their paths are set (``ortho_path``, ``dsm_path``,
``camera_id_path``, ``textured_obj_prefix``), and pass through where not.
DENSIFY_MESH and DENSE_MESH_RELAX are skipped by the default
``skip_dense_mesh``; switched on, DENSIFY_MESH adds the dense stereo points to
the first surface's cloud and DENSE_MESH_RELAX refines each mesh by point
density over them. ``iterate_once`` returns "DONE" at COMPLETE.
``save_checkpoint`` / ``load_checkpoint`` write and read the state, the graph
with its camera models, and the surfaces.

The pipeline holds its device and the dtype of its relax problems
explicitly: float64 by default on every device, the precision of the JAX
package's x64 CPU run that the parity tests hold the port to (the JAX
package runs float32 only on the TPU, which has no float64); float32 on
request. Matching and RANSAC always run in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from opencalibration_tpu_torch.geo.geo_coord import GeoCoord
from opencalibration_tpu_torch.pipeline.stages import LinkStage, LoadStage, RelaxStage, refit_all_edges
from opencalibration_tpu_torch.relax.problem_builder import RelaxOptions
from opencalibration_tpu_torch.surface.mesh import build_minimal_mesh
from opencalibration_tpu_torch.surface.refine import merge_surface_models, refine_by_point_density, refine_surfaces
from opencalibration_tpu_torch.types.camera import CameraModel
from opencalibration_tpu_torch.types.graph import MeasurementGraph, SurfaceModel
from opencalibration_tpu_torch.utils.device import resolve_device
from opencalibration_tpu_torch.utils.performance import PerformanceMeasure, begin_job


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


RELAX_MAX_ITERATIONS = 5  # passes of a relax state
FINAL_RELAX_MAX_ITERATIONS = 3  # FINAL_GLOBAL_RELAX: its last pass is one group

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


def _thumbnail_encoder(path: str):
    """The image writer for ``path`` by its extension, as ``cv2.imwrite``
    picks it: PNG keeps the alpha channel, JPEG drops it."""
    ext = path.lower().rsplit(".", 1)[-1]
    if ext == "png":
        from opencalibration_tpu_torch.io.png import encode_png

        return encode_png
    if ext in ("jpg", "jpeg"):
        from opencalibration_tpu_torch.io.jpeg import encode_jpeg

        return lambda rgba: encode_jpeg(rgba[..., :3])
    raise ValueError(f"thumbnail_path {path!r}: the thumbnail is written as .png, .jpg or .jpeg")


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
    # live tile preview during ortho generation
    # (reference pipeline/progress.hpp:15-34 TileUpdate)
    tile_update: Optional[dict] = None


class Pipeline:
    def __init__(self, batch_size: int = 10, parallelism: int = 8, *, device="cuda",
                 dtype=torch.float64, ransac_uniforms=None, devices=None):
        """``device`` is the card unless the caller asks for ``"cpu"``; a CUDA
        device without a card raises, and ``None`` is an error. ``dtype`` is
        the relax problems' float type. ``ransac_uniforms`` [2048, 4]
        replaces the link's seeded RANSAC draw (parity tests pass the
        reference's). ``devices``: the shards of the relax solves (see
        ``RelaxStage``; by default every card when ``device`` is ``"cuda"``)."""
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
        self._relax_stage = RelaxStage(device=self.device, dtype=dtype, devices=devices)

        self._prev_loaded_ids: List[int] = []
        self._prev_linked_ids: List[int] = []

        # problem-structure cache across the passes of one relax state
        self._relax_plan = None
        self._edges_version = 0  # bumped when edge inlier sets change
        self.step_callback: Optional[Callable[[StepCompletionInfo], None]] = None

        # stage-skip flags, with the reference's defaults
        self.skip_initial_global_relax = True
        self.skip_camera_param_relax = False
        self.skip_final_global_relax = False
        self.skip_mesh_refinement = False
        self.skip_dense_mesh = True

        # ortho output configuration (reference Pipeline set_* setters)
        self.ortho_path: Optional[str] = None
        self.dsm_path: Optional[str] = None
        self.camera_id_path: Optional[str] = None
        self.thumbnail_path: Optional[str] = None
        self.textured_obj_prefix: Optional[str] = None
        self.ortho_max_megapixels: float = 64.0
        self.generate_thumbnails = True
        self.thumbnail_mosaic = None
        self._ortho_job = None
        self.dense_stats: dict = {}  # DENSIFY_MESH's counts and matcher time
        begin_job()  # spans and model-fit repeats from here on belong to this pipeline's job

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

    def save_checkpoint(self, directory: str) -> bool:
        from opencalibration_tpu_torch.io.checkpoint import save_checkpoint

        return save_checkpoint(directory, self)

    def load_checkpoint(self, directory: str) -> bool:
        from opencalibration_tpu_torch.io.checkpoint import load_checkpoint

        return load_checkpoint(directory, self)

    def iterate_once(self) -> str:
        state = self._state
        handler = getattr(self, "_run_" + state.lower())
        with PerformanceMeasure(f"state {state}"):
            transition = handler()
        if transition == "NEXT":
            self._state = PipelineState.ORDER[PipelineState.ORDER.index(state) + 1]
            self._state_run_count = 0
            self._relax_plan = None  # the cache is per state
        elif transition == "REPEAT":
            self._state_run_count += 1
        else:  # "DONE" at COMPLETE: neither a later state nor a counted repeat
            return transition
        return self._state

    def run_to_completion(self, max_iterations: int = 10000) -> str:
        """Iterate to COMPLETE (at most ``max_iterations`` calls)."""
        for _ in range(max_iterations):
            if self._state == PipelineState.COMPLETE:
                break
            self.iterate_once()
        return self._state

    # --- progress ---------------------------------------------------------
    def _emit(self, loaded, linked, relaxed, activity, local=1.0, surfaces_updated=False, tile_update=None):
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
            tile_update=tile_update,
        ))

    # --- states -----------------------------------------------------------
    def _run_initial_processing(self) -> str:
        batch = self._add_queue[: self.batch_size]
        self._add_queue = self._add_queue[len(batch):]

        self._load_stage.init(batch)
        self._link_stage.init(self.graph, self.gps_positions, self._prev_loaded_ids)
        self._relax_stage.init(
            self.graph, self._prev_linked_ids, self.gps_positions, self.model_store,
            relax_all=False, disable_parallelism=False,
            options=RelaxOptions(orientation=True, ground_plane=True),
        )

        # batch N decodes on host threads while batch N-2's relax problems
        # are built and batch N-1's link work is enqueued on the device; the
        # relax solves, then batch N's extraction runs. overlap_io=False runs
        # the stages one after another (same results).
        if self.overlap_io:
            self._load_stage.start_decode(self.parallelism)
            with PerformanceMeasure("ip: relax dispatch"):
                self._relax_stage.dispatch(self.graph, self.surfaces)
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
                self._relax_stage.run_all(self.graph, self.surfaces)

        with PerformanceMeasure("ip: load finalize"):
            loaded = self._load_stage.finalize(
                self.graph, self.geocoord, self.model_store, self._model_key_to_id, self.gps_positions
            )
        with PerformanceMeasure("ip: link finalize"):
            linked = self._link_stage.finalize(self.graph)
        with PerformanceMeasure("ip: relax finalize"):
            relaxed = self._relax_stage.finalize(self.graph, self.model_store)
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

    # mesh-refinement constants
    _MESH_MAX_POINTS_PER_TRIANGLE = 20
    _MESH_VARIANCE_GSD_MULTIPLIER = 2.0
    _MESH_BASE_GRID_FRACTION = 0.1
    _MESH_MAX_GRID_LEVELS = 3
    # LM budget of each refinement pass: every pass continues from the last
    # one's solution, so a bounded continuation converges across passes
    _MESH_REFINE_LM_BUDGET = 30

    def _mesh_gsd(self, grid_fraction: float):
        """Mean ground-sample distance and the level's minimum triangle size."""
        surf_z, n = 0.0, 0
        for s in self.surfaces:
            if s.mesh is not None and s.mesh.num_vertices > 0:
                z = s.mesh.vertices[:, 2]
                z = z[np.isfinite(z)]
                surf_z += float(z.sum())
                n += len(z)
        surf_z = surf_z / n if n else 0.0
        cam_z, arc, size, count = 0.0, 0.0, 0.0, 0
        for _, node in self.graph.nodes():
            model = self.model_store.get(node.payload.model_id)
            if model is None:
                continue
            f = float(model.focal_length_pixels)
            if f <= 0 or not np.isfinite(node.payload.position).all():
                continue
            cam_z += float(node.payload.position[2])
            arc += 1.0 / f
            size += max(float(model.pixels_cols), float(model.pixels_rows))
            count += 1
        if count == 0:
            return 0.01, 0.0
        cam_z, arc, size = cam_z / count, arc / count, size / count
        gsd = max(0.001, abs(cam_z - surf_z) * arc)
        reduced = math.sqrt(self._MESH_MAX_POINTS_PER_TRIANGLE / 8.0) * grid_fraction * size * gsd
        return gsd, reduced

    def _run_mesh_refinement(self) -> str:
        """Alternate a ground-mesh relax at the level's grid fraction with one
        point-density refinement pass gated on a plane variance of
        (2 x GSD)^2, starting from a minimal mesh; a level whose pass created
        no triangle moves to the next, finer level."""
        if self.skip_mesh_refinement:
            return "NEXT"
        rc = self._state_run_count
        if rc == 0:
            self._mesh_grid_level = 0
            self._mesh_level_triangles = 0
            cams = [np.asarray(node.payload.position) for _, node in self.graph.nodes()
                    if np.isfinite(node.payload.position).all()]
            clouds = [c for s in self.surfaces for c in s.cloud]
            if len(cams) >= 2:
                mesh = build_minimal_mesh(np.stack(cams), prior_z_points=np.concatenate(clouds) if clouds else None)
                if mesh is not None:
                    self.surfaces = [SurfaceModel(cloud=[], mesh=mesh)]

        frac = self._MESH_BASE_GRID_FRACTION / (2.0 ** self._mesh_grid_level)
        self._relax_stage.max_lm_iterations = self._MESH_REFINE_LM_BUDGET
        try:
            self._global_relax(RelaxOptions(orientation=True, ground_mesh=True, grid_fraction=frac), None, False)
        finally:
            self._relax_stage.max_lm_iterations = None
        if not self.surfaces:
            return "NEXT"

        gsd, reduced = self._mesh_gsd(frac)
        min_var = (self._MESH_VARIANCE_GSD_MULTIPLIER * gsd) ** 2
        created = 0
        refined_surfaces = []
        for s in self.surfaces:
            if s.mesh is None or not s.cloud:
                refined_surfaces.append(s)
                continue
            refined = refine_by_point_density(
                s.mesh, np.concatenate(s.cloud), self._MESH_MAX_POINTS_PER_TRIANGLE,
                min_distance_variance=min_var, max_iterations=1, min_triangle_size=reduced,
            )
            created += refined.num_triangles - s.mesh.num_triangles
            refined_surfaces.append(SurfaceModel(cloud=s.cloud, mesh=refined))
        self.surfaces = refined_surfaces
        self._emit([], [], [], f"mesh refinement L{self._mesh_grid_level}", surfaces_updated=True)

        if rc >= RELAX_MAX_ITERATIONS * (self._MESH_MAX_GRID_LEVELS + 1):
            return "NEXT"  # the safety cap on passes
        if created > 0:
            self._mesh_level_triangles += created
            return "REPEAT"
        if self._mesh_level_triangles == 0 or self._mesh_grid_level >= self._MESH_MAX_GRID_LEVELS:
            return "NEXT"  # a whole level converged without any refinement
        self._mesh_grid_level += 1
        self._mesh_level_triangles = 0
        return "REPEAT"

    def _relax_structure_key(self, options: RelaxOptions, trim, last) -> tuple:
        """Cache key of the relax problem STRUCTURE: whatever changes
        measurement selection, block families or group membership. Values
        (poses, mesh heights, intrinsics) are refreshed on reuse instead. The
        radial tier is not structural: the monotonicity prior is built with
        any intrinsics and switched by its weight, so the whole
        camera-parameter schedule reuses one structure."""
        mesh_topo = tuple((s.mesh.num_vertices, s.mesh.num_triangles) for s in self.surfaces if s.mesh is not None)
        struct = (
            options.ground_mesh, options.ground_plane, options.points_3d, options.any_intrinsics,
            round(options.grid_fraction, 9),
        )
        return (
            self._state, self.graph.size_nodes(), self.graph.size_edges(), self._edges_version,
            mesh_topo, struct, trim, last,
        )

    def _global_relax(self, options: RelaxOptions, trim: Optional[int], last: bool) -> List[int]:
        """One relax pass over every image: from the cached plan when its key
        still holds, else from new groups (one group when ``last``)."""
        key = self._relax_structure_key(options, trim, last)
        plan = self._relax_plan if self._relax_plan is not None and self._relax_plan.key == key else None
        if plan is not None:
            self._relax_stage.reuse_plan(plan, self.graph, self.model_store, options)
        else:
            self._relax_stage.init(
                self.graph, [], self.gps_positions, self.model_store,
                relax_all=True, disable_parallelism=last, options=options,
            )
            if trim is not None:
                self._relax_stage.trim_groups(trim)
        self._relax_stage.run_all(self.graph, self.surfaces)
        relaxed = self._relax_stage.finalize(self.graph, self.model_store, refit=False)
        new_plan = self._relax_stage.last_plan
        if new_plan is not None and (options.ground_mesh or options.ground_plane):
            new_plan.key = key
            self._relax_plan = new_plan
        else:
            self._relax_plan = None
        surfaces = [s for s in self._relax_stage.surfaces() if s.mesh is not None or s.cloud]
        if surfaces:
            self.surfaces = self._merge_group_surfaces(surfaces)
        return relaxed

    def _run_initial_global_relax(self) -> str:
        if self.skip_initial_global_relax:
            return "NEXT"
        relaxed = self._global_relax(RelaxOptions(orientation=True, ground_mesh=True), None, False)
        self._emit([], [], relaxed, "initial global relax", surfaces_updated=True)
        return "NEXT" if self._state_run_count >= RELAX_MAX_ITERATIONS else "REPEAT"

    def _run_camera_parameter_relax(self) -> str:
        """The ground-mesh relax with intrinsics free, by run count: focal
        (passes 0 and 1), plus one more radial term each pass (2, 3), then
        all three with the principal point. All groups take part: several
        groups are coupled through their shared camera models by the joint
        solver. After the last pass every edge is refitted once with the
        final intrinsics, which invalidates the next state's cached plan."""
        if self.skip_camera_param_relax:
            return "NEXT"
        rc = self._state_run_count
        options = RelaxOptions(
            orientation=True, ground_mesh=True, focal=True,
            radial_tier=min(max(rc - 1, 0), 3), principal=rc >= 4,
        )
        relaxed = self._global_relax(options, trim=None, last=False)
        self._emit([], [], relaxed, "camera parameter relax", surfaces_updated=True)
        if self._state_run_count >= RELAX_MAX_ITERATIONS:
            refit_all_edges(self.graph, self.model_store, dtype=self.dtype, device=self.device)
            self._edges_version += 1
            return "NEXT"
        return "REPEAT"

    def _run_final_global_relax(self) -> str:
        if self.skip_final_global_relax:
            return "NEXT"
        last = self._state_run_count >= FINAL_RELAX_MAX_ITERATIONS
        relaxed = self._global_relax(RelaxOptions(orientation=True, ground_mesh=True), None, last)
        self._emit([], [], relaxed, "final global relax", surfaces_updated=True)
        return "NEXT" if last else "REPEAT"

    def _run_generate_thumbnail(self) -> str:
        if self.generate_thumbnails and self.surfaces:
            from opencalibration_tpu_torch.ortho.ortho import generate_orthomosaic

            encode = _thumbnail_encoder(self.thumbnail_path) if self.thumbnail_path else None
            self.thumbnail_mosaic = generate_orthomosaic(
                self.surfaces, self.graph, self.model_store, device=self.device
            )
            if self.thumbnail_mosaic is not None and encode is not None:
                with open(self.thumbnail_path, "wb") as f:
                    f.write(encode(self.thumbnail_mosaic.rgba))
        self._emit([], [], [], "thumbnail")
        return "NEXT"

    def _run_densify_mesh(self) -> str:
        if self.skip_dense_mesh:
            return "NEXT"
        from opencalibration_tpu_torch.dense.dense_stereo import densify_mesh

        self.dense_stats = {}
        densify_mesh(self.graph, self.model_store, self.surfaces, device=self.device, stats=self.dense_stats)
        self._emit([], [], [], "densify", surfaces_updated=True)
        return "NEXT"

    def _run_dense_mesh_relax(self) -> str:
        if self.skip_dense_mesh:
            return "NEXT"
        self.surfaces = refine_surfaces(self.surfaces)
        self._emit([], [], [], "dense mesh relax", surfaces_updated=True)
        return "NEXT"

    def _wants_ortho(self) -> bool:
        return bool(self.ortho_path or self.textured_obj_prefix or self.dsm_path)

    def _run_generate_layers(self) -> str:
        if not self._wants_ortho() or not self.surfaces:
            return "NEXT"
        from opencalibration_tpu_torch.ortho.ortho import OrthoJob, generate_dsm_geotiff

        if self.dsm_path:
            generate_dsm_geotiff(
                self.dsm_path, self.surfaces, self.graph, self.model_store,
                self.geocoord, max_megapixels=self.ortho_max_megapixels, device=self.device,
            )
        if self.ortho_path or self.textured_obj_prefix:
            self._ortho_job = OrthoJob(
                self.surfaces, self.graph, self.model_store, self.geocoord,
                max_megapixels=self.ortho_max_megapixels, device=self.device,
            )
            if self._ortho_job.ok:
                self._ortho_job.pass_layers()
        self._emit([], [], [], "generate layers")
        return "NEXT"

    def _run_color_balance(self) -> str:
        if self._ortho_job is not None and self._ortho_job.ok:
            self._ortho_job.solve_balance()
        self._emit([], [], [], "color balance")
        return "NEXT"

    def _run_blend_layers(self) -> str:
        if self._ortho_job is not None and self._ortho_job.ok:
            out_path = self.ortho_path or ((self.textured_obj_prefix or "ortho") + "_texture.tif")

            def on_tile(info):
                self._emit([], [], [], "blend tile", local=info.get("fraction_done", 0.0), tile_update=info)

            self._ortho_job.tile_callback = on_tile
            self._ortho_job.pass_blend(out_path, camera_id_path=self.camera_id_path)
            if self.textured_obj_prefix:
                from opencalibration_tpu_torch.io.geotiff import read_geotiff
                from opencalibration_tpu_torch.ortho.ortho import generate_textured_obj

                img, origin, px, _ = read_geotiff(out_path)
                generate_textured_obj(self.textured_obj_prefix, self.surfaces, img, origin, px[0])
        self._emit([], [], [], "blend layers")
        return "NEXT"

    def _run_complete(self) -> str:
        # terminal: neither NEXT (no later state) nor REPEAT (callers looping
        # on iterate_once() would spin the run counter)
        return "DONE"

    @staticmethod
    def _merge_group_surfaces(surfaces: List[SurfaceModel]) -> List[SurfaceModel]:
        """Per-group surfaces over the same mesh topology merge into one,
        vertex heights weighted by each group's point support."""
        if len(surfaces) <= 1:
            return surfaces
        merged = merge_surface_models(surfaces)
        return [merged] if merged is not None else surfaces
