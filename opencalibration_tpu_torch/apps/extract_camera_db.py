"""Extract optimized camera intrinsics from a checkpoint into the camera
database (twin of apps/extract_camera_db.py)::

    python -m opencalibration_tpu_torch.apps.extract_camera_db -c ckpt -o camera_db.json [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-c", "--checkpoint", required=True, help="Checkpoint directory")
    ap.add_argument("-o", "--output", required=True, help="Camera database JSON to update")
    ap.add_argument("--notes", default="extracted from checkpoint")
    ap.add_argument("--device", default="cuda", help="Torch device of the loaded pipeline (default cuda)")
    args = ap.parse_args(argv)

    from opencalibration_tpu_torch.apps.pipeline_runner import camera_db_entry
    from opencalibration_tpu_torch.extract.camera_database import CameraDatabase
    from opencalibration_tpu_torch.pipeline.pipeline import Pipeline

    p = Pipeline(device=args.device)
    if not p.load_checkpoint(args.checkpoint):
        print(f"error: cannot load checkpoint {args.checkpoint}", file=sys.stderr)
        return 1

    db = CameraDatabase()
    db.load(args.output)
    seen = set()
    for _, node in p.graph.nodes():
        model = p.model_store.get(node.payload.model_id)
        if model is None or node.payload.model_id in seen:
            continue
        seen.add(node.payload.model_id)
        db.add_or_update(camera_db_entry(node.payload.metadata, model, args.notes))
    if not db.save(args.output):
        print(f"error: cannot write {args.output}", file=sys.stderr)
        return 1
    print(f"updated {len(seen)} camera entries in {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
