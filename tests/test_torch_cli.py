"""The port's runner (``python -m opencalibration_tpu_torch.apps.pipeline_runner``)
from a directory of JPEGs to COMPLETE on the CPU, in a process where jax,
the JAX package, cv2 and PIL cannot be imported: the 2 x 3 colour survey at
320 x 240 written as JPEG by the port's encoder, every flag of the JAX
package's tests/test_cli.py and ``--dense-mesh 1``, the orthomosaic capped
at 0.15 MP to keep the run short. It writes the reference's 14 artifacts.
The graph JSON reads back through the JAX package's deserializer as the
port's own reading of it, and the two packages' ``extract_camera_db``, run
on the one checkpoint, write equal camera databases.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.io import serialize as TSer
from opencalibration_tpu_torch.testing import survey as TS
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARTIFACTS = [
    "graph.geojson", "graph.json", "cloud.xyz", "mesh.ply", "ortho.tif", "dsm.tif", "camera_ids.tif",
    "textured.obj", "textured.mtl", "textured.jpg", "thumb.png", "camera_db.json",
    os.path.join("ckpt", "metadata.json"), os.path.join("ckpt", "graph.json"),
]
MEGAPIXELS = 0.15

_CODE = """
    import runpy, sys
    for name in ("jax", "opencalibration_tpu", "cv2", "PIL"):
        sys.modules[name] = None  # any import of it raises
    sys.argv = ["pipeline_runner"] + {argv!r}
    try:
        runpy.run_module("opencalibration_tpu_torch.apps.pipeline_runner", run_name="__main__")
    except SystemExit as e:
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "opencalibration_tpu",
                                                                       "cv2", "PIL") and sys.modules[m])
        print("LOADED", loaded)
        print("RC", e.code)
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    images = str(tmp_path_factory.mktemp("jpeg_survey"))
    out = str(tmp_path_factory.mktemp("cli_out"))
    paths, _, _ = TS.write_survey(images, 2, 3, color=True, gains=TS.survey_gains(6), fmt="jpg", device="cpu")
    assert all(p.endswith(".jpg") for p in paths)
    o = lambda name: os.path.join(out, name)  # noqa: E731
    argv = [
        "-i", images, "--device", "cpu", "--batch-size", "4", "--camera-param-relax", "0", "--final-relax", "1",
        "-c", o("ckpt"), "-g", o("graph.geojson"), "--graph-file", o("graph.json"), "-p", o("cloud.xyz"),
        "-m", o("mesh.ply"), "-o", o("ortho.tif"), "--dsm-file", o("dsm.tif"), "--camera-id-file", o("camera_ids.tif"),
        "-x", o("textured.obj"), "-t", o("thumb.png"), "--update-camera-db", o("camera_db.json"),
        "--dense-mesh", "1", "--ortho-max-megapixels", str(MEGAPIXELS), "-d", "4", "--log-file", o("log.txt"),
    ]
    env = dict(os.environ, OMP_NUM_THREADS="1")  # one torch thread, as in this process
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_CODE.format(argv=argv))], capture_output=True,
                       text=True, timeout=900, cwd=root, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return out, r.stdout


def test_runner_writes_every_artifact_without_jax_or_opencv(run):
    out, stdout = run
    assert "RC 0" in stdout and "LOADED []" in stdout, stdout
    for name in ARTIFACTS:
        path = os.path.join(out, name)
        assert os.path.exists(path) and os.path.getsize(path) > 0, name
    assert "map_Kd textured.jpg" in open(os.path.join(out, "textured.mtl")).read()
    log = open(os.path.join(out, "log.txt")).read()
    assert "DENSIFY_MESH" in log and "DENSE_MESH_RELAX" in log and "pipeline complete" in log
    gj = json.loads(open(os.path.join(out, "graph.geojson")).read())
    assert len(gj["features"]) > 0
    db = json.loads(open(os.path.join(out, "camera_db.json")).read())
    assert db["version"] == 1 and len(db["cameras"]) == 1
    cloud = np.loadtxt(os.path.join(out, "cloud.xyz"))
    assert cloud.shape[1] == 3 and len(cloud) > 100 and np.isfinite(cloud).all()


def test_graph_json_reads_back_in_both_packages(run):
    from opencalibration_tpu.io import serialize as JSer

    out, _ = run
    text = open(os.path.join(out, "graph.json")).read()
    j_graph, j_models = JSer.deserialize_graph(text)[:2]
    t_graph, t_models = TSer.deserialize_graph(text)[:2]
    carried = interop.graph_from(j_graph)
    assert sorted(i for i, _ in carried.nodes()) == sorted(i for i, _ in t_graph.nodes())
    assert t_graph.size_nodes() == 6 and t_graph.size_edges() >= 5
    for nid, node in t_graph.nodes():
        other = carried.get_node(nid).payload
        np.testing.assert_array_equal(node.payload.orientation, other.orientation)
        np.testing.assert_array_equal(node.payload.position, other.position)
        assert node.payload.path == other.path and node.payload.model_id == other.model_id
    assert sorted(i for i, _ in carried.edges()) == sorted(i for i, _ in t_graph.edges())
    for mid, m in interop.model_store_from(j_models).items():
        assert float(m.focal_length_pixels) == float(t_models[mid].focal_length_pixels)


def test_extract_camera_db_twins_write_equal_json(run, tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "apps"))
    import extract_camera_db as j_app

    from opencalibration_tpu_torch.apps import extract_camera_db as t_app

    out, _ = run
    ckpt = os.path.join(out, "ckpt")
    assert j_app.main(["-c", ckpt, "-o", str(tmp_path / "j.json")]) == 0
    assert t_app.main(["-c", ckpt, "-o", str(tmp_path / "t.json"), "--device", "cpu"]) == 0
    j, t = (json.loads(open(str(tmp_path / n)).read()) for n in ("j.json", "t.json"))
    assert t == j and len(t["cameras"]) == 1
    assert t["cameras"][0]["focal_length_pixels"] > 0
