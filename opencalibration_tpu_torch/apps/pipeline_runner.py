"""Pipeline runner CLI (twin of apps/pipeline_runner.py).

A directory of geotagged images in (JPEG, PNG, TIFF, binary PGM / PPM), the
calibrated camera graph, point cloud, mesh, orthomosaic, DSM, camera-id
raster, textured OBJ, thumbnail and camera database out, with a checkpoint
saved on every state transition. Runs on the card unless ``--device cpu``
is given::

    python -m opencalibration_tpu_torch.apps.pipeline_runner -i <dir> --device cuda \\
        -g graph.geojson --graph-file graph.json -p cloud.xyz -m mesh.ply -o ortho.tif \\
        --dsm-file dsm.tif --camera-id-file camera_ids.tif -x textured.obj -t thumb.png \\
        --update-camera-db camera_db.json -c ckpt --dense-mesh 1

``--dtype`` is the relax problems' float type, float64 by default on every
device (the reference's own semantics, which the JAX package keeps on the CPU
with x64 on; it runs float32 only on the TPU, which has no float64).
``main`` is ``make_pipeline``, ``run_pipeline`` and ``write_outputs`` in turn.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys
import time

import numpy as np
import torch

IMAGE_PATTERNS = ("*.jpg", "*.JPG", "*.jpeg", "*.JPEG", "*.png", "*.tif", "*.tiff", "*.pgm", "*.ppm")
_LEVELS = [logging.CRITICAL + 1, logging.CRITICAL, logging.ERROR, logging.WARNING, logging.INFO, logging.DEBUG]
log = logging.getLogger("pipeline_runner")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-i", "--input", required=False, help="Input directory of images")
    p.add_argument("-d", "--debug", type=int, default=3, help="Log verbosity: 0=off .. 5=debug")
    p.add_argument("--log-file", default=None, help="Append log output to file")
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--device", default="cuda", help="Torch device (default cuda; cpu runs on the host)")
    p.add_argument("--dtype", choices=("float32", "float64"), default="float64",
                   help="Relax problems' float type")

    p.add_argument("-g", "--geojson-file", default=None, help="Output GeoJSON camera graph")
    p.add_argument("--graph-file", default=None, help="Output serialized camera graph JSON")
    p.add_argument("-p", "--pointcloud-file", default=None, help="Output pointcloud XYZ")
    p.add_argument("-m", "--mesh-file", default=None, help="Output mesh PLY")
    p.add_argument("-o", "--geotiff-file", default=None, help="Output orthomosaic GeoTIFF")
    p.add_argument("--dsm-file", default=None, help="Output DSM GeoTIFF")
    p.add_argument("--camera-id-file", default=None,
                   help="Output camera-id sidecar GeoTIFF (one uint64 band of node ids)")
    p.add_argument("-x", "--textured-mesh-file", default=None, help="Output textured OBJ")
    p.add_argument("-t", "--thumbnail-file", default=None, help="Output thumbnail image (.png, .jpg)")
    p.add_argument("--ortho-max-megapixels", type=float, default=64.0,
                   help="Cap on the orthomosaic's and the DSM's pixels (default 64 MP, the reference's)")

    p.add_argument("--mesh-refinement", type=int, default=1)
    p.add_argument("--initial-relax", type=int, default=0)
    p.add_argument("--camera-param-relax", type=int, default=1)
    p.add_argument("--final-relax", type=int, default=1)
    p.add_argument("--dense-mesh", type=int, default=0)

    p.add_argument("-c", "--checkpoint-save", default=None, help="Save checkpoint dir on state transitions")
    p.add_argument("-r", "--checkpoint-restore", default=None, help="Restore from checkpoint dir")
    p.add_argument("--resume-from", default=None, help="Rewind to a pipeline state")
    p.add_argument("--update-camera-db", default=None, help="Write optimized intrinsics back to this camera DB json")
    p.add_argument("--perf", action="store_true", help="Print performance counter summary")
    return p.parse_args(argv)


def make_pipeline(args):
    """A ``Pipeline`` on ``args.device`` with the flags' outputs and state
    switches set, restored from ``--checkpoint-restore`` and rewound to
    ``--resume-from`` where given, with the input images queued. Returns
    None (after logging why) when it cannot be made."""
    from opencalibration_tpu_torch.pipeline.pipeline import Pipeline

    pipeline = Pipeline(batch_size=args.batch_size, device=args.device, dtype=getattr(torch, args.dtype))
    pipeline.ortho_path = args.geotiff_file
    pipeline.dsm_path = args.dsm_file
    pipeline.camera_id_path = args.camera_id_file
    pipeline.thumbnail_path = args.thumbnail_file
    pipeline.ortho_max_megapixels = args.ortho_max_megapixels
    if args.textured_mesh_file:
        pipeline.textured_obj_prefix = args.textured_mesh_file.removesuffix(".obj")
    pipeline.skip_mesh_refinement = not args.mesh_refinement
    pipeline.skip_initial_global_relax = not args.initial_relax
    pipeline.skip_camera_param_relax = not args.camera_param_relax
    pipeline.skip_final_global_relax = not args.final_relax
    pipeline.skip_dense_mesh = not args.dense_mesh

    if args.checkpoint_restore:
        if not pipeline.load_checkpoint(args.checkpoint_restore):
            log.error("failed to load checkpoint %s", args.checkpoint_restore)
            return None
        log.info("restored checkpoint at state %s", pipeline.get_state())
    if args.resume_from:
        if not pipeline.resume_from_state(args.resume_from):
            log.error("cannot resume forward to %s", args.resume_from)
            return None
    if args.input:
        paths = sorted(p for ext in IMAGE_PATTERNS for p in glob.glob(os.path.join(args.input, ext)))
        if not paths and not args.checkpoint_restore:
            log.error("no images found in %s", args.input)
            return None
        pipeline.add(paths)
        log.info("queued %d images", len(paths))
    return pipeline


def run_pipeline(pipeline, args) -> float:
    """Iterate to COMPLETE, saving a checkpoint on every state transition
    where ``--checkpoint-save`` is given. Returns the seconds taken."""
    from opencalibration_tpu_torch.pipeline.pipeline import PipelineState

    def on_step(info):
        log.info("[%5.1f%%] %s it=%d loaded=%d linked=%d relaxed=%d queue=%d",
                 100 * info.global_progress, info.state, info.state_iteration, len(info.loaded_ids),
                 len(info.linked_ids), len(info.relaxed_ids), info.queue_size_remaining)

    pipeline.step_callback = on_step
    t0 = time.time()
    prev_state = pipeline.get_state()
    while pipeline.get_state() != PipelineState.COMPLETE:
        pipeline.iterate_once()
        if pipeline.get_state() != prev_state:
            prev_state = pipeline.get_state()
            if args.checkpoint_save:
                pipeline.save_checkpoint(args.checkpoint_save)
                log.info("checkpoint saved at %s", prev_state)
    seconds = time.time() - t0
    log.info("pipeline complete in %.1fs", seconds)
    return seconds


def camera_db_entry(md, model, notes: str):
    """A camera database entry of ``model``'s intrinsics for the camera of
    ``md`` (the principal point stored as its offset from the centre)."""
    from opencalibration_tpu_torch.extract.camera_database import CameraDBEntry

    center = np.array([md.width_px / 2.0, md.height_px / 2.0])
    return CameraDBEntry(
        make=md.camera_make, model=md.camera_model, lens_model=md.lens_model,
        sensor_width_px=md.width_px, sensor_height_px=md.height_px,
        radial_distortion=np.asarray(model.radial_distortion.cpu(), np.float64),
        tangential_distortion=np.asarray(model.tangential_distortion.cpu(), np.float64),
        principal_point_offset=np.asarray(model.principal_point.cpu(), np.float64) - center,
        focal_length_pixels=float(model.focal_length_pixels), notes=notes,
    )


def write_outputs(pipeline, args):
    """The checkpoint, graph JSON, GeoJSON, XYZ cloud (3-sigma filtered), PLY
    mesh and camera database the flags ask for; the rasters, OBJ and
    thumbnail are written by the pipeline's own states."""
    if args.checkpoint_save:
        pipeline.save_checkpoint(args.checkpoint_save)
    if args.graph_file:
        from opencalibration_tpu_torch.io.serialize import serialize_graph

        with open(args.graph_file, "w") as f:
            f.write(serialize_graph(pipeline.graph, pipeline.model_store))
    if args.geojson_file:
        from opencalibration_tpu_torch.io.serialize import to_visualized_geojson

        with open(args.geojson_file, "w") as f:
            f.write(to_visualized_geojson(pipeline.graph, pipeline.geocoord))
    if args.pointcloud_file:
        from opencalibration_tpu_torch.io.mesh_io import save_xyz

        clouds = [c for s in pipeline.surfaces for c in s.cloud]
        save_xyz(args.pointcloud_file, np.concatenate(clouds) if clouds else np.zeros((0, 3)), filter_stddev=3.0)
    if args.mesh_file:
        from opencalibration_tpu_torch.io.mesh_io import save_ply

        mesh = next((s.mesh for s in pipeline.surfaces if s.mesh is not None), None)
        if mesh is not None:
            save_ply(args.mesh_file, mesh)
    if args.update_camera_db:
        from opencalibration_tpu_torch.extract.camera_database import CameraDatabase

        db = CameraDatabase()
        db.load(args.update_camera_db)
        for _, node in pipeline.graph.nodes():
            model = pipeline.model_store.get(node.payload.model_id)
            if model is not None:
                db.add_or_update(camera_db_entry(node.payload.metadata, model, "opencalibration_tpu optimized"))
        db.save(args.update_camera_db)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=_LEVELS[min(args.debug, 5)], format="[%(asctime)s] [%(levelname)s] %(message)s",
                        filename=args.log_file)
    from opencalibration_tpu_torch.utils.performance import enable_performance_counters, total_performance_summary

    if args.perf:
        enable_performance_counters(True)
    pipeline = make_pipeline(args)
    if pipeline is None:
        return 1
    run_pipeline(pipeline, args)
    write_outputs(pipeline, args)
    if args.perf:
        print(total_performance_summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
