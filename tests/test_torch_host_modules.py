"""The port's own copies of the JAX package's host modules (geodesy, EXIF and
sidecar metadata, the native EXIF parser, the camera database, spectral
clustering, the surface mesh and its refinement) against the originals on the
same inputs, and the ``interop`` conversions of graphs and surfaces between
the two packages.

Tolerances: none. The copies run the same numpy code, so every result is
compared for equality (NaN equal to NaN)."""

import dataclasses
import os

import numpy as np
import pytest

from opencalibration_tpu.extract import camera_database as JDB
from opencalibration_tpu.extract import image_loader as JL
from opencalibration_tpu.extract import metadata as JMD
from opencalibration_tpu.geo.geo_coord import GeoCoord as JGeoCoord
from opencalibration_tpu.ops.clustering import spectral_cluster as j_cluster
from opencalibration_tpu.pipeline.stages import _apply_sidecar_metadata as j_sidecar
from opencalibration_tpu.surface import mesh as JM
from opencalibration_tpu.surface import refine as JR
from opencalibration_tpu.types import graph as JG
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch import native as TN
from opencalibration_tpu_torch.extract import camera_database as TDB
from opencalibration_tpu_torch.extract import image_loader as TL
from opencalibration_tpu_torch.extract import metadata as TMD
from opencalibration_tpu_torch.geo.geo_coord import GeoCoord as TGeoCoord
from opencalibration_tpu_torch.ops.clustering import spectral_cluster as t_cluster
from opencalibration_tpu_torch.pipeline.stages import _apply_sidecar_metadata as t_sidecar
from opencalibration_tpu_torch.surface import mesh as TM
from opencalibration_tpu_torch.surface import refine as TR
from opencalibration_tpu_torch.testing import survey as TS
from opencalibration_tpu_torch.types import graph as TG
from tests.test_metadata import _write_jpeg_with_metadata
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _same_fields(a, b):
    """Equal dataclass fields by name, arrays and NaNs included."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, (np.ndarray, tuple, list, float)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    """The 2 x 3 PGM survey with its JSON geotag sidecars."""
    return TS.write_survey(str(tmp_path_factory.mktemp("host_survey")), 2, 3, device="cpu")


# ---------------------------------------------------------------------------
# Geodesy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("origin", [(47.3769, 8.5417), (-33.8688, 151.2093), (64.1466, -21.9426), (0.0, 0.0)],
                         ids=["zurich", "sydney", "reykjavik", "null_island"])
def test_geo_coord(origin):
    rng = np.random.default_rng(0)
    lat = origin[0] + rng.uniform(-0.02, 0.02, 20)
    lon = origin[1] + rng.uniform(-0.02, 0.02, 20)
    alt = rng.uniform(0.0, 400.0, 20)
    ref, got = JGeoCoord(), TGeoCoord()
    assert not got.is_initialized()
    assert got.set_origin(*origin) == ref.set_origin(*origin)
    assert got.is_initialized() and got.origin == ref.origin
    local = got.to_local(lat, lon, alt)
    np.testing.assert_array_equal(local, ref.to_local(lat, lon, alt))
    np.testing.assert_array_equal(got.to_wgs84(local), ref.to_wgs84(local))
    assert got.get_wkt() == ref.get_wkt()


# ---------------------------------------------------------------------------
# Metadata and the native EXIF parser
# ---------------------------------------------------------------------------


def test_metadata_from_survey_files_and_sidecars(survey):
    paths = survey[0]
    for path in paths:
        ref, got = JG.ImageNode(path=path), TG.ImageNode(path=path)
        ref.metadata, got.metadata = JMD.extract_metadata(path), TMD.extract_metadata(path)
        assert got.metadata == interop.image_node_from(ref).metadata
        j_sidecar(ref)
        t_sidecar(got)
        assert got.metadata == interop.image_node_from(ref).metadata
        assert got.metadata.has_gps() and got.metadata.focal_length_px == TS.FOCAL


@pytest.mark.parametrize("native", [True, False], ids=["native_parser", "pil_fallback"])
def test_metadata_from_exif_and_xmp(tmp_path, native):
    path = str(tmp_path / "meta.jpg")
    _write_jpeg_with_metadata(path)
    if native:
        ref, got = JMD.extract_metadata(path), TMD.extract_metadata(path)
    else:
        ref, got = JMD._extract_metadata_pil(path), TMD._extract_metadata_pil(path)
    assert got.camera_make == "TestMake" and got.has_gps()
    assert got == interop.image_node_from(JG.ImageNode(metadata=ref)).metadata
    assert JMD.parse_xmp(path) == TMD.parse_xmp(path)


def test_native_library_builds_outside_the_package(tmp_path):
    """The port's EXIF parser builds into build/native/, named by a hash of
    its source, and parses as the JAX package's does."""
    path = str(tmp_path / "meta.jpg")
    _write_jpeg_with_metadata(path)
    got = TN.parse_exif_native(path)
    if TN.exif_library() is None:  # no compiler: both packages use PIL
        assert got is None
        return
    from opencalibration_tpu.native import parse_exif_native as j_parse

    ref = j_parse(path)
    for name, _ in TN.ExifResult._fields_:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    package = os.path.dirname(TN.__file__)
    assert not any(f.endswith(".so") for f in os.listdir(package))
    built = [f for f in os.listdir(TN.BUILD_DIR) if f.startswith("libocexif_")]
    assert built and os.path.basename(os.path.dirname(TN.BUILD_DIR)) == "build"


# ---------------------------------------------------------------------------
# Camera database
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("query", [
    dict(camera_make="DJI", camera_model="FC330", width_px=4000, height_px=3000),
    dict(camera_make="dji", camera_model="fc6310", width_px=5472, height_px=3648),
    dict(camera_make="DJI", camera_model="FC330", width_px=1000, height_px=750),
    dict(camera_make="Nobody", camera_model="Nothing", width_px=640, height_px=480),
], ids=["exact", "case_insensitive", "make_model_only", "unknown"])
def test_camera_database_lookup(query):
    with open(TDB.default_database_path()) as a, open(JDB.default_database_path()) as b:
        assert a.read() == b.read()
    ref_db, got_db = JDB.CameraDatabase(), TDB.CameraDatabase()
    assert got_db.load(TDB.default_database_path()) and ref_db.load(JDB.default_database_path())
    ref_md, got_md = JG.ImageMetadata(**query), TG.ImageMetadata(**query)
    ref_md.focal_length_px = got_md.focal_length_px = 3000.0
    ref, got = ref_db.lookup(ref_md), got_db.lookup(got_md)
    assert (got is None) == (ref is None) == (query["camera_make"] == "Nobody")
    if ref is not None:
        _same_fields(got, ref)
    kw_ref, kw_got = JL.camera_model_kwargs(ref_md, ref_db), TL.camera_model_kwargs(got_md, got_db)
    assert kw_got.keys() == kw_ref.keys()
    for k in kw_ref:
        np.testing.assert_array_equal(np.asarray(kw_got[k]), np.asarray(kw_ref[k]), err_msg=k)


# ---------------------------------------------------------------------------
# Spectral clustering
# ---------------------------------------------------------------------------


def _camera_graph(seed=0, rows=8, cols=10):
    """A rows x cols camera grid with edges to the 4 nearest neighbours
    (weights from distance) and one isolated pair."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(cols) * 12.0, np.arange(rows) * 12.0)
    pts = np.column_stack([xs.ravel(), ys.ravel(), np.full(rows * cols, 60.0)]) + rng.normal(scale=1.0, size=(rows * cols, 3))
    pts = np.vstack([pts, [[500.0, 500.0, 60.0], [512.0, 500.0, 60.0]]])
    n = len(pts)
    edges, weights = set(), {}
    for i in range(n - 2):
        d = np.linalg.norm(pts[: n - 2, :2] - pts[i, :2], axis=1)
        for j in np.argsort(d)[1:5]:
            key = (min(i, int(j)), max(i, int(j)))
            edges.add(key)
            weights[key] = 1.0 / (1.0 + d[j])
    edges = sorted(edges) + [(n - 2, n - 1)]
    weights = [weights.get(e, 1.0) for e in edges]
    return n, edges, weights, pts


@pytest.mark.parametrize("max_cluster_size", [6, 20, 200])
def test_spectral_cluster_labels(max_cluster_size):
    n, edges, weights, pts = _camera_graph()
    ref = j_cluster(n, edges, weights, pts, max_cluster_size)
    got = t_cluster(n, edges, weights, pts, max_cluster_size)
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got)) >= max(2, n // (2 * max_cluster_size))


# ---------------------------------------------------------------------------
# Surface mesh: minimal mesh, point-density refinement, merged surfaces
# ---------------------------------------------------------------------------


def _points(seed=1, n=3000):
    """Ground points over a 60 x 50 m patch with 3 m of relief, denser in
    one corner."""
    rng = np.random.default_rng(seed)
    xy = np.vstack([rng.uniform([-10, -10], [50, 40], size=(n, 2)), rng.uniform([30, 20], [50, 40], size=(n, 2))])
    z = 3.0 * np.sin(xy[:, 0] / 8.0) * np.cos(xy[:, 1] / 10.0)
    return np.column_stack([xy, z])


def _assert_same_mesh(got, ref):
    assert type(got) is TM.TriMesh
    np.testing.assert_array_equal(got.vertices, ref.vertices)
    np.testing.assert_array_equal(got.triangles, ref.triangles)


@pytest.mark.parametrize("prior", [True, False], ids=["with_points", "cameras_only"])
def test_minimal_mesh_and_refinement(prior):
    cams = np.column_stack([np.tile([0.0, 12.0, 24.0, 36.0], 2), np.repeat([0.0, 25.0], 4), np.full(8, 60.0)])
    points = _points()
    ref = JM.build_minimal_mesh(cams, points if prior else None)
    got = TM.build_minimal_mesh(cams, points if prior else None)
    _assert_same_mesh(got, ref)
    kw = dict(max_points_per_triangle=50, min_distance_variance=0.05, max_iterations=6)
    ref_refined, got_refined = JR.refine_by_point_density(ref, points, **kw), TR.refine_by_point_density(got, points, **kw)
    _assert_same_mesh(got_refined, ref_refined)
    assert got_refined.num_triangles > got.num_triangles


def test_merge_surface_models():
    points = _points()
    mesh = JR.refine_by_point_density(JM.build_minimal_mesh(points[:, :]), points, max_points_per_triangle=200)
    rng = np.random.default_rng(2)
    ref_surfaces = []
    for k in range(3):
        moved = mesh.copy()
        moved.vertices[:, 2] += rng.normal(scale=0.2, size=moved.num_vertices)
        ref_surfaces.append(JG.SurfaceModel(cloud=[points[k::3]], mesh=moved))
    ref = JR.merge_surface_models(ref_surfaces)
    got = TR.merge_surface_models([interop.surface_from(s) for s in ref_surfaces])
    assert type(got) is TG.SurfaceModel
    _assert_same_mesh(got.mesh, ref.mesh)
    assert len(got.cloud) == len(ref.cloud) == 3
    # meshes of different topology are not merged
    other = JG.SurfaceModel(cloud=[], mesh=JM.build_minimal_mesh(points))
    assert JR.merge_surface_models(ref_surfaces + [other]) is None
    assert TR.merge_surface_models([interop.surface_from(s) for s in ref_surfaces + [other]]) is None


# ---------------------------------------------------------------------------
# interop: graphs and surfaces across the two packages
# ---------------------------------------------------------------------------


def _reference_graph(seed=3):
    """A JAX-package graph of 4 image nodes with metadata and features and 3
    edges with relations, one node removed and re-added."""
    rng = np.random.default_rng(seed)
    graph = JG.MeasurementGraph(seed=0)
    ids = []
    for i in range(5):
        md = JG.ImageMetadata(width_px=320, height_px=240, focal_length_px=400.0, latitude=47.0 + i * 1e-4,
                              longitude=8.0, camera_make="Make", abs_orientation=np.asarray([1.0, 0, 0, 0]))
        feats = JG.FeatureSet(xy=rng.uniform(0, 300, (20, 2)), strength=rng.random(20).astype(np.float32),
                              descriptors=rng.integers(0, 2**32, (20, 16), dtype=np.uint64).astype(np.uint32),
                              valid=rng.random(20) < 0.9, num_sparse=7)
        node = JG.ImageNode(path=f"IMG_{i}.pgm", metadata=md, features=feats, model_id=1 + i % 2,
                            position=rng.normal(size=3), orientation=rng.normal(size=4) if i % 2 else np.full(4, np.nan))
        ids.append(graph.add_node(node))
    graph.remove_node(ids.pop(2))
    for a, b in ((0, 1), (1, 2), (2, 3)):
        rel = JG.CameraRelations(match_idx1=np.arange(5, dtype=np.int32), match_idx2=np.arange(5, 10, dtype=np.int32),
                                 match_distance=rng.random(5).astype(np.float32), inlier_idx1=np.arange(3, dtype=np.int32),
                                 inlier_pixel1=rng.normal(size=(3, 2)), ransac_relation=rng.normal(size=(3, 3)),
                                 relation_type=JG.RelationType.HOMOGRAPHY, rel_scores=np.asarray([4.0, 3.0, 2.0, 1.0]))
        graph.add_edge(rel, ids[a], ids[b])
    return graph


def test_graph_round_trip():
    ref = _reference_graph()
    got = interop.graph_from(ref)
    assert type(got) is TG.DirectedGraph
    assert list(got.node_ids()) == list(ref.node_ids()) and list(got.edge_ids()) == list(ref.edge_ids())
    for node_id, node in got.nodes():
        assert type(node.payload) is TG.ImageNode and type(node.payload.metadata) is TG.ImageMetadata
        assert node.edges == ref.get_node(node_id).edges
        np.testing.assert_array_equal(node.payload.features.descriptors, ref.get_node(node_id).payload.features.descriptors)
    for edge_id, edge in got.edges():
        assert type(edge.payload) is TG.CameraRelations
        assert got.get_edge_id(edge.source, edge.dest) == edge_id
    assert got == interop.graph_from(ref, TG)
    back = interop.graph_from(got, JG)
    assert type(back) is JG.DirectedGraph and back == ref
    # the copies share no arrays with the original
    first = next(iter(got.node_ids()))
    got.get_node(first).payload.position[:] = 0.0
    assert not np.array_equal(ref.get_node(first).payload.position, got.get_node(first).payload.position)
    # both id generators go on alike
    assert got.add_node(TG.ImageNode(path="new")) == ref.add_node(JG.ImageNode(path="new"))


def test_surface_round_trip():
    points = _points()
    mesh = JM.build_minimal_mesh(points)
    ref = JG.SurfaceModel(cloud=[points[:10], points[10:30]], mesh=mesh)
    got = interop.surface_from(ref)
    assert type(got) is TG.SurfaceModel and type(got.mesh) is TM.TriMesh
    back = interop.surface_from(got, JG, JM.TriMesh)
    assert type(back) is JG.SurfaceModel and type(back.mesh) is JM.TriMesh
    _assert_same_mesh(got.mesh, back.mesh)
    for a, b in zip(back.cloud, ref.cloud):
        np.testing.assert_array_equal(a, b)
    assert interop.surface_from(JG.SurfaceModel()).mesh is None
