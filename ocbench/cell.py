"""One run of one cell: what ``run.py`` drives and the CPU tests drive too.

Everything that belongs to one configuration, traffic mix, cell or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the survey deployment and the pipeline's flags;
* ``traffic/<traffic>.json``: the part of the pipeline the window drives, as
  a ``mode`` (a module in ``modes/``) and its parameters;
* ``limits/<workload>.json``: the limit of each number that decides
  ``correct``, compared by ``reference/<mode>.py``;
* ``metrics/<metric>.py``: a reader with ``read(record) -> float | None``;
  ``<name>.py`` is looked up first, then the part of the name before its
  first dot (``lm_ms_per_iter.py`` reads ``lm_ms_per_iter.ingest`` and
  ``lm_ms_per_iter.calibrate``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Optional

import torch

from ocbench.trace import Trace

HERE = os.path.dirname(os.path.abspath(__file__))
JAX_NAMES = ("jax", "jaxlib", "flax", "opencalibration_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def find_cell(benchmark: dict, workload: str) -> dict:
    for cell in benchmark["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metric_reader(name: str, root: str = HERE):
    """The ``read`` function of the reader file of metric ``name``."""
    for stem in (name, name.split(".", 1)[0]):
        path = os.path.join(root, "metrics", stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"ocbench_metric_{stem.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {root}/metrics")


def cell_metrics(benchmark: dict, cell: dict, key: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
    return [m for m in benchmark[key] if cell["name"] in m.get("workloads", [cell["name"]])]


def jax_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(JAX_NAMES))


@dataclasses.dataclass
class Run:
    """What a mode needs: the cell's files, the seed, the window's length,
    the device, a scratch directory for the survey and the recorders;
    ``times`` gathers the wall seconds of the run's phases."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: str
    workdir: str
    trace: Trace
    times: dict = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = time.perf_counter() - t0


@dataclasses.dataclass
class Window:
    """What a mode's window hands back: the end-to-end values it measured
    (name -> value), the record the per-layer readers read, the answers the
    reference judges and how many were attempted and failed."""

    values: dict
    record: dict
    answers: object
    attempted: int
    failed: int


def pipeline_args(config: dict, images_dir: str, device: str) -> list:
    """The runner's command line for this configuration: its defaults but
    for the flags the configuration sets, no outputs."""
    p = config["pipeline"]
    return ["-i", images_dir, "--device", device, "--batch-size", str(p["batch_size"]), "--dtype", p["dtype"],
            "--mesh-refinement", str(p["mesh_refinement"]), "--initial-relax", str(p["initial_relax"]),
            "--camera-param-relax", str(p["camera_param_relax"]), "--final-relax", str(p["final_relax"]),
            "--dense-mesh", str(p["dense_mesh"]), "-d", "0"]


def make_pipeline(config: dict, images_dir: str, device: str):
    """``Pipeline`` as ``apps/pipeline_runner.py`` makes it, images queued."""
    from opencalibration_tpu_torch.apps import pipeline_runner

    pipeline = pipeline_runner.make_pipeline(pipeline_runner.parse_args(pipeline_args(config, images_dir, device)))
    if pipeline is None:
        raise RuntimeError(f"the runner made no pipeline from {images_dir}")
    return pipeline


def host_clocks() -> dict:
    """CPU seconds so far of this thread (``thread_cpu``), which launches
    the card's work, and of the whole process (``process_cpu``). Their
    differences over a job, beside its wall time, say whether the main
    thread was held back or ran slower."""
    return {"thread_cpu": time.thread_time(), "process_cpu": time.process_time()}


def sync(device: str):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str, workdir: str,
             t_start: float, limits: Optional[dict] = None, config: Optional[dict] = None,
             traffic: Optional[dict] = None, benchmark: Optional[dict] = None) -> dict:
    """Set up, warm up, measure for ``seconds`` and judge one cell. Returns
    the result: the contract's keys, then ``checks`` (each compared number's
    value, limit and kind, "max" or "min"), ``_numbers`` (every number the
    reference read) and ``_times`` (wall seconds of the run's phases).
    ``t_start`` is the process's start on the ``time.perf_counter`` clock.
    ``limits``, ``config`` and ``traffic`` default to the cell's files."""
    config = config or load_json("configs", cell["config"] + ".json")
    traffic = traffic or load_json("traffic", cell["traffic"] + ".json")
    limits = limits or load_json("limits", cell["name"] + ".json")
    mode = importlib.import_module(f"ocbench.modes.{traffic['mode']}")
    reference = importlib.import_module(f"ocbench.reference.{traffic['mode']}")
    is_cuda = torch.device(device).type == "cuda"

    with Trace(trace) as tr:
        run = Run(cell, config, traffic, seed, seconds, device, workdir, tr)
        state = mode.setup(run)
        sync(device)
        setup_s = time.perf_counter() - t_start
        with run.phase("window_s"):
            window = mode.window(run, state)
        t_judge = time.perf_counter()
        if is_cuda:
            sync(device)
            peak = torch.cuda.max_memory_allocated()
        else:
            peak = 0
        del state
        gc.collect()
        if is_cuda:
            torch.cuda.empty_cache()
        sl = tr.slice.reduce() if trace and tr.slice is not None else None
        numbers = reference.compare(window.answers, config, traffic, seed)
    run.times["judge_s"] = time.perf_counter() - t_judge
    checks = []
    for name, lim in limits["numbers"].items():
        value = numbers[name]
        kind, bound = ("max", lim["max"]) if "max" in lim else ("min", lim["min"])
        checks.append((name, value, bound, kind))
    correct = window.failed == 0 and all(
        v == v and (v <= b if k == "max" else v >= b) for _, v, b, k in checks)

    result = {"correct": correct, "attempted": window.attempted, "failed": window.failed}
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        record = dict(window.record, slice=sl)
        metrics = {}
        for m in cell_metrics(benchmark, cell, "per_layer"):
            value = metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if sl is not None:
            dev["busy_s"] = sl["busy_s"]
            dev["window_s"] = sl["window_s"]
            result["breakdown"] = {"device_ops": [list(x) for x in sl["device_ops"]],
                                   "idle_gaps": [list(x) for x in sl["idle_gaps"]]}
    else:
        values = dict(window.values, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(benchmark, cell, "end_to_end")}
    result["metrics"] = metrics
    result["device"] = dev
    result["checks"] = {name: {"value": v, "limit": b, "kind": k} for name, v, b, k in checks}
    result["_numbers"] = numbers
    result["_times"] = dict(run.times, setup_s=setup_s)
    return result
