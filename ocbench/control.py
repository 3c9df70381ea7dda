"""Readings that set the limits of ``correct``: a cell run on several seeds
in one process, as the program is, as its lower-precision control, or with
a fault planted underneath the timed path.

    python3 -m ocbench.control --workload <name> --seconds <s> --seeds 1,2,3 --variant <variant>

Variants: ``program``; ``float32``, the control: the relax in float32, the
runner's ``--dtype float32``, one step below the configuration's float64;
and the faults ``stale_relax`` (every LM solve returns its entry state),
``half_batch`` (the load stage takes every other image of each batch) and
``altered_answer`` (where the pipeline produces its answers, one is altered:
a loaded image's position by 0.5 m; a new edge's relative rotations and a
camera of each INITIAL_PROCESSING batch by 5 degrees; at the end of
FINAL_GLOBAL_RELAX a camera by 5 degrees and the mesh by 0.5 m).
One JSON line per seed: the variant, the seed, every number the reference
read, ``correct`` under the cell's limits, and the end-to-end values. The
benchmark's own runs never run this. Needs the cell's cards, like ``run``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from ocbench.trace import Patch

FAULTS = ("stale_relax", "half_batch", "altered_answer")
VARIANTS = ("program", "float32") + FAULTS


def _stale(solve):
    def stale(params, *args, **kw):
        out, info = solve(params, *args, max_iterations=0, **{k: v for k, v in kw.items() if k != "max_iterations"})
        return params, info

    return stale


def _half(init):
    def half(self, paths):
        return init(self, list(paths)[::2])

    return half


def _turn(q, degrees=5.0):
    """Quaternion q (w, x, y, z) turned about the vertical by ``degrees``."""
    c, s = math.cos(math.radians(degrees / 2)), math.sin(math.radians(degrees / 2))
    w, x, y, z = q
    return np.array([c * w - s * z, c * x - s * y, c * y + s * x, c * z + s * w])


def _altered_load(finalize):
    def altered(self, graph, *args, **kw):
        ids = finalize(self, graph, *args, **kw)
        if ids:
            graph.get_node(ids[0]).payload.position = graph.get_node(ids[0]).payload.position + [0.5, 0.0, 0.0]
        return ids

    return altered


def _altered_link(finalize):
    def altered(self, graph):
        ids = finalize(self, graph)
        if ids:
            rel = graph.get_edge(sorted(graph.get_node(ids[0]).edges)[0]).payload
            rel.rel_quats = np.stack([_turn(q) for q in rel.rel_quats])
        return ids

    return altered


def _altered_batch(finalize):
    """INITIAL_PROCESSING's write-back (the call that refits): the first
    camera it wrote turned."""
    def altered(self, graph, model_store, refit=True):
        ids = finalize(self, graph, model_store, refit)
        if refit and ids:
            node = graph.get_node(ids[0]).payload
            node.orientation = _turn(node.orientation)
        return ids

    return altered


def _altered_final(run_final):
    """FINAL_GLOBAL_RELAX's last pass: a camera turned, the mesh raised 0.5 m."""
    def altered(self):
        out = run_final(self)
        if out == "NEXT":
            nid = min(self.graph.node_ids())
            self.graph.get_node(nid).payload.orientation = _turn(self.graph.get_node(nid).payload.orientation)
            for s in self.surfaces:
                if s.mesh is not None:
                    s.mesh.vertices[:, 2] += 0.5
        return out

    return altered


@contextlib.contextmanager
def planted(variant: str):
    """The program with ``variant``'s fault underneath it (none for the
    program and for the control, which is a configuration)."""
    from opencalibration_tpu_torch.pipeline import stages
    from opencalibration_tpu_torch.pipeline.pipeline import Pipeline
    from opencalibration_tpu_torch.relax import lm

    with contextlib.ExitStack() as stack:
        if variant == "stale_relax":
            stack.enter_context(Patch(lm, "solve", _stale))
            stack.enter_context(Patch(lm, "solve_batch", _stale))
        elif variant == "half_batch":
            stack.enter_context(Patch(stages.LoadStage, "init", _half))
        elif variant == "altered_answer":
            stack.enter_context(Patch(stages.LoadStage, "finalize", _altered_load))
            stack.enter_context(Patch(stages.LinkStage, "finalize", _altered_link))
            stack.enter_context(Patch(stages.RelaxStage, "finalize", _altered_batch))
            stack.enter_context(Patch(Pipeline, "_run_final_global_relax", _altered_final))
        yield


def variant_config(config: dict, variant: str) -> dict:
    config = copy.deepcopy(config)
    if variant == "float32":
        config["pipeline"]["dtype"] = "float32"
    return config


def read(cell: dict, benchmark: dict, variant: str, seed: int, seconds: float, device: str) -> dict:
    """One run of ``cell`` as ``variant``: the numbers, ``correct`` and the
    end-to-end values."""
    from ocbench import cell as C

    config = variant_config(C.load_json("configs", cell["config"] + ".json"), variant)
    workdir = tempfile.mkdtemp(prefix="ocbench-control-", dir=os.environ.get("TMPDIR"))
    try:
        with planted(variant):
            result = C.run_cell(cell, seed, seconds, False, device, workdir, time.perf_counter(), config=config,
                                benchmark=benchmark)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return dict(variant=variant, seed=seed, correct=result["correct"], numbers=result["_numbers"],
                metrics={k: v["value"] for k, v in result["metrics"].items()})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--variant", choices=VARIANTS, action="append", required=True)
    args = p.parse_args(argv)
    import torch

    from ocbench import cell as C
    from ocbench.run import cache_env

    if not torch.cuda.is_available():
        print("ocbench.control: no CUDA card", file=sys.stderr)
        return 2
    cache_env(os.getcwd())
    with open("BENCHMARK.json") as f:
        benchmark = json.load(f)
    cell = C.find_cell(benchmark, args.workload)
    for variant in args.variant:
        for seed in (int(s) for s in args.seeds.split(",")):
            out = read(cell, benchmark, variant, seed, args.seconds, "cuda")
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
