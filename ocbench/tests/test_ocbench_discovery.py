"""A configuration, a traffic mix, a cell and a per-layer metric added as new
files (and new entries of BENCHMARK.json) are found without editing any file
that is there."""

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OCBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(OCBENCH)


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(OCBENCH, tmp_path / "ocbench", ignore=shutil.ignore_patterns(".build", "__pycache__"))
    before = {p: (tmp_path / "ocbench" / p).read_bytes() for p in _files(tmp_path / "ocbench")}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)

    cfg = json.loads((tmp_path / "ocbench/configs/nadir1600.json").read_text())
    cfg["name"] = "wide1600"
    cfg["survey"]["across_track_m"] = 24.0
    (tmp_path / "ocbench/configs/wide1600.json").write_text(json.dumps(cfg))
    (tmp_path / "ocbench/traffic/ingest_long.json").write_text(json.dumps(
        {"mode": "ingest", "warm_batches": 5, "window_images": 256, "min_inliers": 50}))
    (tmp_path / "ocbench/limits/ingest_long.wide1600.json").write_text(json.dumps({"numbers": {"missing": {"max": 0}}}))
    (tmp_path / "ocbench/metrics/batches_per_s.py").write_text(
        "def read(record):\n    return record['batches'] / record['window_s'] if record.get('batches') else None\n")
    bench["configs"].append({"name": "wide1600", "source": "a", "file": "ocbench/configs/wide1600.json",
                             "reduced": [], "why": "b"})
    bench["workloads"].append({"name": "ingest_long.wide1600", "config": "wide1600", "traffic": "ingest_long",
                               "chips": 1, "why": "c"})
    bench["per_layer"].append({"name": "batches_per_s.ingest_long", "unit": "1/s", "better": "higher",
                               "source": "program_counter", "layer": "pipeline states",
                               "moves": "ingest_images_per_s", "workloads": ["ingest_long.wide1600"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    probe = (
        "import json\n"
        "from ocbench import cell as C\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "c = C.find_cell(b, 'ingest_long.wide1600')\n"
        "print(C.HERE)\n"
        "print(C.load_json('configs', c['config'] + '.json')['survey']['across_track_m'])\n"
        "print(C.load_json('traffic', c['traffic'] + '.json')['warm_batches'])\n"
        "print(list(C.load_json('limits', c['name'] + '.json')['numbers']))\n"
        "print([m['name'] for m in C.cell_metrics(b, c, 'per_layer')])\n"
        "print(C.metric_reader('batches_per_s.ingest_long')({'batches': 10, 'window_s': 4.0}))\n"
        "print(C.metric_reader('lm_ms_per_iter.ingest')({'lm': {'iterations': 2, 'seconds': 1.0}}))\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)), timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == str(tmp_path / "ocbench")
    assert lines[1:] == ["24.0", "5", "['missing']", "['batches_per_s.ingest_long']", "2.5", "500.0"]
    # nothing that was there changed
    assert all((tmp_path / "ocbench" / p).read_bytes() == data for p, data in before.items())


def _files(root):
    return [os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs]
