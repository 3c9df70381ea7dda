"""Host-side graph containers.

Python re-design of the reference's header-only graph layer
(reference include/opencalibration/types/graph.hpp:14-296,
 image.hpp, camera_relations.hpp, mesh_graph.hpp, surface_model.hpp).

Design choices vs the reference:
* node/edge ids are deterministic per-graph counters seeded like the
  reference's per-graph RNG (graph.hpp uses random u64 keys from a
  default-seeded engine — here we draw from numpy's PCG64 with a fixed
  seed so serialized graphs are reproducible run-to-run);
* per-image numeric payloads (features, descriptors) are stored as
  padded numpy/jax arrays, not vectors of structs, so stages can batch
  them straight onto the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Generic, Iterator, Optional, Set, Tuple, TypeVar

import numpy as np

NP = TypeVar("NP")
EP = TypeVar("EP")


class GraphEdge(Generic[EP]):
    __slots__ = ("payload", "_source", "_dest")

    def __init__(self, payload: EP, source: int, dest: int):
        self.payload = payload
        self._source = source
        self._dest = dest

    @property
    def source(self) -> int:
        return self._source

    @property
    def dest(self) -> int:
        return self._dest

    def __eq__(self, other):
        return (
            isinstance(other, GraphEdge)
            and self._source == other._source
            and self._dest == other._dest
            and self.payload == other.payload
        )


class GraphNode(Generic[NP]):
    __slots__ = ("payload", "_edges")

    def __init__(self, payload: NP):
        self.payload = payload
        self._edges: Set[int] = set()

    @property
    def edges(self) -> Set[int]:
        return self._edges

    def __eq__(self, other):
        return (
            isinstance(other, GraphNode)
            and self.payload == other.payload
            and self._edges == other._edges
        )


class DirectedGraph(Generic[NP, EP]):
    """Mirrors the reference DirectedGraph API (graph.hpp:14-296):
    addNode/addEdge with unique u64-style ids, (source, dest) -> edge
    lookup, removal, equality, iteration."""

    def __init__(self, seed: int = 0):
        self._nodes: Dict[int, GraphNode[NP]] = {}
        self._edges: Dict[int, GraphEdge[EP]] = {}
        self._sourcedest_to_edge: Dict[Tuple[int, int], int] = {}
        self._rng = np.random.Generator(np.random.PCG64(seed))

    # --- id generation: random-looking but deterministic per graph ---
    def _new_id(self, table) -> int:
        while True:
            candidate = int(self._rng.integers(0, 2**63, dtype=np.int64))
            if candidate not in table:
                return candidate

    def add_node(self, payload: NP) -> int:
        node_id = self._new_id(self._nodes)
        self._nodes[node_id] = GraphNode(payload)
        return node_id

    def add_edge(self, payload: EP, source: int, dest: int) -> int:
        if source not in self._nodes or dest not in self._nodes:
            raise KeyError("source/dest node missing")
        if (source, dest) in self._sourcedest_to_edge:
            raise ValueError("edge already exists")
        edge_id = self._new_id(self._edges)
        self._edges[edge_id] = GraphEdge(payload, source, dest)
        self._nodes[source]._edges.add(edge_id)
        self._nodes[dest]._edges.add(edge_id)
        self._sourcedest_to_edge[(source, dest)] = edge_id
        return edge_id

    def get_node(self, node_id: int) -> Optional[GraphNode[NP]]:
        return self._nodes.get(node_id)

    def get_edge(self, edge_id: int) -> Optional[GraphEdge[EP]]:
        return self._edges.get(edge_id)

    def get_edge_id(self, source: int, dest: int) -> Optional[int]:
        return self._sourcedest_to_edge.get((source, dest))

    def remove_edge(self, edge_id: int) -> bool:
        e = self._edges.pop(edge_id, None)
        if e is None:
            return False
        self._sourcedest_to_edge.pop((e.source, e.dest), None)
        for nid in (e.source, e.dest):
            n = self._nodes.get(nid)
            if n is not None:
                n._edges.discard(edge_id)
        return True

    def remove_node(self, node_id: int) -> bool:
        n = self._nodes.get(node_id)
        if n is None:
            return False
        for edge_id in list(n._edges):
            self.remove_edge(edge_id)
        del self._nodes[node_id]
        return True

    def size_nodes(self) -> int:
        return len(self._nodes)

    def size_edges(self) -> int:
        return len(self._edges)

    def nodes(self) -> Iterator[Tuple[int, GraphNode[NP]]]:
        return iter(self._nodes.items())

    def edges(self) -> Iterator[Tuple[int, GraphEdge[EP]]]:
        return iter(self._edges.items())

    def node_ids(self):
        return self._nodes.keys()

    def edge_ids(self):
        return self._edges.keys()

    def __eq__(self, other):
        return (
            isinstance(other, DirectedGraph)
            and self._nodes == other._nodes
            and self._edges == other._edges
        )


# ---------------------------------------------------------------------------
# Payload types
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ImageMetadata:
    """EXIF-derived per-image metadata (reference types/image_metadata.hpp)."""

    width_px: int = 0
    height_px: int = 0
    focal_length_px: float = float("nan")
    principal_point_px: Tuple[float, float] = (float("nan"), float("nan"))
    latitude: float = float("nan")
    longitude: float = float("nan")
    altitude: float = float("nan")
    relative_altitude: float = float("nan")
    rotation_offset: float = float("nan")  # yaw/pitch/roll packed later
    abs_orientation: Optional[np.ndarray] = None  # wxyz or None
    gps_accuracy_xy: float = float("nan")
    gps_accuracy_z: float = float("nan")
    camera_make: str = ""
    camera_model: str = ""
    lens_model: str = ""
    capture_time: str = ""

    def has_gps(self) -> bool:
        return np.isfinite(self.latitude) and np.isfinite(self.longitude)

    def __eq__(self, other):
        if not isinstance(other, ImageMetadata):
            return False

        def eq(a, b):
            if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                if a is None or b is None:
                    return a is b
                return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
            if isinstance(a, float) and isinstance(b, float):
                return a == b or (np.isnan(a) and np.isnan(b))
            if isinstance(a, tuple) and isinstance(b, tuple):
                return len(a) == len(b) and all(eq(x, y) for x, y in zip(a, b))
            return a == b

        return all(
            eq(getattr(self, f.name), getattr(other, f.name))
            for f in dataclasses.fields(self)
        )


@dataclasses.dataclass
class FeatureSet:
    """Padded per-image feature arrays (device-friendly layout).

    Replaces std::vector<feature_2d> (reference types/feature_2d.hpp):
    xy [K, 2] float32, strength [K], descriptors [K, 16] uint32, valid [K].
    """

    xy: np.ndarray
    strength: np.ndarray
    descriptors: np.ndarray
    valid: np.ndarray
    num_sparse: int = 0  # strongest-first count like image.num_sparse_features

    def __eq__(self, other):
        return (
            isinstance(other, FeatureSet)
            and np.array_equal(self.xy, other.xy)
            and np.array_equal(self.strength, other.strength)
            and np.array_equal(self.descriptors, other.descriptors)
            and np.array_equal(self.valid, other.valid)
            and self.num_sparse == other.num_sparse
        )


@dataclasses.dataclass
class ImageNode:
    """Per-image node payload (reference types/image.hpp:19-48)."""

    path: str = ""
    metadata: ImageMetadata = dataclasses.field(default_factory=ImageMetadata)
    features: Optional[FeatureSet] = None
    thumbnail: Optional[np.ndarray] = None  # [h, w, 3] uint8 Lab
    model_id: int = 0  # key into the camera-model store
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(3, np.nan)
    )
    orientation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(4, np.nan)
    )  # wxyz

    def __eq__(self, other):
        if not isinstance(other, ImageNode):
            return False
        return (
            self.path == other.path
            and self.metadata == other.metadata
            and self.features == other.features
            and self.model_id == other.model_id
            and _nan_array_eq(self.position, other.position)
            and _nan_array_eq(self.orientation, other.orientation)
            and _optional_array_eq(self.thumbnail, other.thumbnail)
        )


def _nan_array_eq(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return bool(np.all(np.isnan(a) & np.isnan(b) | (a == b)))


def _optional_array_eq(a, b):
    if a is None or b is None:
        return a is b
    return np.array_equal(a, b)


class RelationType:
    HOMOGRAPHY = "homography"
    FUNDAMENTAL_MATRIX = "fundamental_matrix"
    UNKNOWN = "unknown"


@dataclasses.dataclass
class CameraRelations:
    """Edge payload (reference types/camera_relations.hpp:14-37).

    inlier_* are parallel padded arrays over inlier matches;
    relative_poses holds 4 scored (quat wxyz, t, score) candidates.
    """

    # all matches (feature_index_1, feature_index_2, distance)
    match_idx1: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    match_idx2: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    match_distance: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.float32))
    # inliers, denormalized
    inlier_idx1: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    inlier_idx2: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    inlier_pixel1: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 2), np.float64))
    inlier_pixel2: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 2), np.float64))
    inlier_match_index: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    ransac_relation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full((3, 3), np.nan)
    )
    relation_type: str = RelationType.UNKNOWN
    # 4 candidates: quats [4,4] wxyz, positions [4,3], scores [4]
    rel_quats: np.ndarray = dataclasses.field(default_factory=lambda: np.full((4, 4), np.nan))
    rel_positions: np.ndarray = dataclasses.field(default_factory=lambda: np.full((4, 3), np.nan))
    rel_scores: np.ndarray = dataclasses.field(default_factory=lambda: np.full(4, -1.0))

    def __eq__(self, other):
        if not isinstance(other, CameraRelations):
            return False
        def eq(a, b):
            a, b = np.asarray(a), np.asarray(b)
            if a.shape != b.shape:
                return False
            if a.dtype.kind == "f":
                return bool(np.all((np.isnan(a) & np.isnan(b)) | (a == b)))
            return np.array_equal(a, b)
        return (
            eq(self.match_idx1, other.match_idx1)
            and eq(self.match_idx2, other.match_idx2)
            and eq(self.match_distance, other.match_distance)
            and eq(self.inlier_idx1, other.inlier_idx1)
            and eq(self.inlier_idx2, other.inlier_idx2)
            and eq(self.inlier_pixel1, other.inlier_pixel1)
            and eq(self.inlier_pixel2, other.inlier_pixel2)
            and eq(self.ransac_relation, other.ransac_relation)
            and self.relation_type == other.relation_type
            and eq(self.rel_quats, other.rel_quats)
            and eq(self.rel_positions, other.rel_positions)
            and eq(self.rel_scores, other.rel_scores)
        )


# MeasurementGraph: nodes are images, edges are pairwise relations
MeasurementGraph = DirectedGraph  # [ImageNode, CameraRelations]


@dataclasses.dataclass
class MeshNode:
    location: np.ndarray  # [3]

    def __eq__(self, other):
        return isinstance(other, MeshNode) and np.array_equal(
            self.location, other.location
        )


@dataclasses.dataclass
class MeshEdge:
    border: bool = False
    triangle_opposite_nodes: Tuple[int, int] = (0, 0)

    def __eq__(self, other):
        return (
            isinstance(other, MeshEdge)
            and self.border == other.border
            and self.triangle_opposite_nodes == other.triangle_opposite_nodes
        )


MeshGraph = DirectedGraph  # [MeshNode, MeshEdge]


@dataclasses.dataclass
class SurfaceModel:
    """reference types/surface_model.hpp: point clouds + mesh."""

    cloud: list = dataclasses.field(default_factory=list)  # list of [N,3] arrays
    mesh: Optional[DirectedGraph] = None


@dataclasses.dataclass
class NodePose:
    """reference types/node_pose.hpp."""

    node_id: int
    orientation: np.ndarray  # wxyz
    position: np.ndarray
