"""A run end to end: on the CPU at a small size with the look for a card
skipped, the program judged correct and its float32 control and each
planted fault judged not correct; without a card, or without the program,
no result; on a card (``gpu``), one short run of a cell through the
benchmark's command."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from ocbench import cell as C
from ocbench import control

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2**31 + 4242


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


INGEST_METRICS = ("load_wait_ms_per_image", "jpeg_decode_ms", "extract_ms_per_image", "link_ms_per_image",
                  "hamming_top2_roofline", "ip_relax_ms_per_image", "model_inversion_ms_per_image", "lm_steps",
                  "lm_step_ms", "device_idle")


def small_ingest():
    """``ingest.nadir1600``, the cell whose files wait under ``ocbench/`` for
    its entry in BENCHMARK.json, at 320 x 240 (focal and texture scaled with
    it, so footprints and overlaps stay), three lines of four, batches of
    two, a window of two batches."""
    bench = load_benchmark()
    cell = {"name": "ingest.nadir1600", "config": "nadir1600", "traffic": "ingest", "chips": 1}
    bench["workloads"].append(cell)
    bench["end_to_end"].append({"name": "ingest_images_per_s", "unit": "images/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock", "workloads": [cell["name"]]})
    bench["per_layer"] += [{"name": f"{m}.ingest", "unit": "-", "better": "lower", "source": "program_span",
                            "layer": "-", "moves": "ingest_images_per_s", "workloads": [cell["name"]]}
                           for m in INGEST_METRICS]
    config = C.load_json("configs", "nadir1600.json")
    config["survey"].update(width=320, height=240, focal_px=400.0, texture_px_per_150m=512, lines=3, per_line=4)
    config["pipeline"]["batch_size"] = 2
    traffic = dict(C.load_json("traffic", "ingest.json"), min_inliers=20, window_images=4)
    # pixels five times as wide as the cell's: angles read about five times
    # larger (0.07-0.3 degrees here against 0.002-0.007 at 1600 x 1200)
    limits = C.load_json("limits", "ingest.nadir1600.json")
    limits["numbers"].update(orientation_deg={"max": 1.0}, edge_deg={"max": 5.0})
    return bench, cell, config, traffic, limits


@pytest.fixture
def survey_cache(tmp_path, monkeypatch):
    from ocbench.modes import ingest

    monkeypatch.setattr(ingest, "SURVEY_CACHE", str(tmp_path / "cache"))


def small_calibrate():
    """``calibrate.fixed1600`` at 320 x 240 (focal and texture scaled with
    it), a block of two lines of three, no warm job."""
    bench = load_benchmark()
    cell = C.find_cell(bench, "calibrate.fixed1600")
    config = C.load_json("configs", "fixed1600.json")
    config["survey"].update(width=320, height=240, focal_px=400.0, texture_px_per_150m=512)
    traffic = dict(C.load_json("traffic", "calibrate.json"), block_lines=2, block_per_line=3, warm_jobs=0)
    # pixels five times as wide as the cell's: orientations and the surface
    # read about five times larger (0.05 degrees and 0.03 m here)
    limits = C.load_json("limits", "calibrate.fixed1600.json")
    limits["numbers"].update(orientation_deg={"max": 1.0}, surface_m={"max": 0.25})
    return bench, cell, config, traffic, limits


@pytest.mark.parametrize("variant", control.VARIANTS)
def test_small_run_on_the_cpu(variant, tmp_path, survey_cache):
    bench, cell, config, traffic, limits = small_ingest()
    torch.set_num_threads(4)
    # the window holds the same batches however fast the CPU runs
    with control.planted(variant):
        result = C.run_cell(cell, SEED, 6.0, False, "cpu", str(tmp_path), time.perf_counter(),
                            limits=limits, config=control.variant_config(config, variant), traffic=traffic,
                            benchmark=bench)
    assert result["correct"] is (variant == "program"), result["checks"]
    assert list(result)[-3:] == ["checks", "_numbers", "_times"]
    assert set(result["metrics"]) == {"setup_s", "ingest_images_per_s"}
    assert result["metrics"]["ingest_images_per_s"]["value"] > 0
    assert len(result["_times"]["window_batch_s"]) == 2
    if variant == "float32":  # fails only the precision number
        assert failed_checks(result) == {"quat_norm_gap"}


def test_small_traced_run_on_the_cpu(tmp_path, survey_cache):
    """A traced run profiles the untraced run's window, the same batches;
    its per-layer readers find the program's spans and counters there."""
    bench, cell, config, traffic, limits = small_ingest()
    torch.set_num_threads(4)
    result = C.run_cell(cell, SEED, 6.0, True, "cpu", str(tmp_path), time.perf_counter(), limits=limits,
                        config=config, traffic=traffic, benchmark=bench)
    assert result["correct"] is True, result["checks"]
    assert len(result["_times"]["window_batch_s"]) == 2
    assert {"link_ms_per_image.ingest", "ip_relax_ms_per_image.ingest", "extract_ms_per_image.ingest",
            "lm_steps.ingest", "lm_step_ms.ingest"} <= set(result["metrics"])


def failed_checks(result) -> set:
    return {k for k, c in result["checks"].items()
            if not (c["value"] <= c["limit"] if c["kind"] == "max" else c["value"] >= c["limit"])}


@pytest.mark.parametrize("variant", control.VARIANTS)
def test_small_calibrate_on_the_cpu(variant, tmp_path):
    bench, cell, config, traffic, limits = small_calibrate()
    torch.set_num_threads(2)
    with control.planted(variant):
        result = C.run_cell(cell, SEED, 120.0, False, "cpu", str(tmp_path), time.perf_counter(),
                            limits=limits, config=control.variant_config(config, variant), traffic=traffic,
                            benchmark=bench)
    assert result["correct"] is (variant == "program"), result["checks"]
    assert set(result["metrics"]) == {"setup_s", "calibrate_s"}
    assert result["metrics"]["calibrate_s"]["value"] > 0
    if variant == "float32":
        assert failed_checks(result) == {"quat_norm_gap"}


def test_without_a_card_there_is_no_result():
    out = subprocess.run([sys.executable, "-m", "ocbench.run", "--workload", "calibrate.fixed1600", "--seed",
                          str(SEED), "--seconds", "5", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_there_is_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "ocbench"), tmp_path / "ocbench",
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "-m", "ocbench.run", "--workload", "calibrate.fixed1600", "--seed",
                          str(SEED), "--seconds", "5", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload, seconds, trace", [
    ("calibrate.fixed1600", 25, 0), ("calibrate.fixed1600", 25, 1)])
def test_short_run_on_the_card(card, workload, seconds, trace):
    out = subprocess.run([sys.executable, "-m", "ocbench.run", "--workload", workload, "--seed", str(SEED),
                          "--seconds", str(seconds), "--trace", str(trace)], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert list(result)[-1] == "checks"
    bench = load_benchmark()
    cell = C.find_cell(bench, workload)
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert f"hamming_top2_roofline.{cell['traffic']}" in result["metrics"]
    else:
        assert set(result["metrics"]) == {m["name"] for m in C.cell_metrics(bench, cell, "end_to_end")}
