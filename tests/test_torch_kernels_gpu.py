"""The port's hand-written CUDA kernel against its plain PyTorch version, and
the port's solvers and its orthomosaic tail on the card against the CPU.

Tests marked ``gpu`` need a CUDA device and skip without one; the device is
looked up inside a fixture, so every worker collects the same tests. This
file imports no JAX, so it also runs on a machine without the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest`` skips tests/conftest.py, which imports JAX.) The unmarked
tests check the dispatch rules and run anywhere.
"""

import numpy as np
import pytest
import torch

from opencalibration_tpu_torch.ops import hamming as H
from opencalibration_tpu_torch.ops import hamming_cuda
from opencalibration_tpu_torch.testing import hamming_cases as HC


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(rng, shape, garbage_padding=True):
    w = rng.integers(0, 2**32, size=shape + (16,), dtype=np.uint64).astype(np.uint32)
    if not garbage_padding:
        w[..., 15] &= np.uint32((1 << 6) - 1)
    return torch.from_numpy(w.view(np.int32))


def _near_copies(rng, words, rate):
    flips = rng.random(tuple(words.shape) + (32,)) < rate
    mask = np.sum(flips.astype(np.uint64) << np.arange(32, dtype=np.uint64), axis=-1)
    return torch.from_numpy((words.numpy().view(np.uint32) ^ mask.astype(np.uint32)).view(np.int32))


def _inputs(seed, pairs, n1, n2, valid_rate):
    """Descriptors where half of set 2 are near copies of set 1 (so rows pass
    the Lowe test), with invalid rows and garbage padding bits."""
    rng = np.random.default_rng(seed)
    shape1 = (n1,) if pairs is None else (pairs, n1)
    shape2 = (n2,) if pairs is None else (pairs, n2)
    p1, p2 = _words(rng, shape1), _words(rng, shape2)
    k = min(n1, n2) // 2
    p2[..., :k, :] = _near_copies(rng, p1[..., :k, :], 0.05)
    v1 = torch.from_numpy(rng.random(shape1) < 0.95)
    v2 = torch.from_numpy(rng.random(shape2) < valid_rate)
    return p1, p2, v1, v2


def _assert_bit_exact(cuda, p1, p2, v1, v2):
    """The kernel, alone and inside match_descriptors, against the plain
    version: all outputs equal; two launches give the same bits."""
    p1, p2, v1, v2 = (t.to(cuda).contiguous() for t in (p1, p2, v1, v2))
    before = hamming_cuda.hamming_top2.launches
    top2 = hamming_cuda.hamming_top2(p1, p2, v2)
    again = hamming_cuda.hamming_top2(p1, p2, v2)
    got = top2 + H.match_descriptors(p1, p2, v1, v2)
    want = H.hamming_top2_reference(p1, p2, v2) + H.match_descriptors_reference(p1, p2, v1, v2)
    torch.cuda.synchronize()
    assert hamming_cuda.hamming_top2.launches == before + 3
    for name, g, w in zip(("best", "second", "idx", "idx2", "distance", "matched"), got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), f"{name}: {int((g != w).sum())} entries differ"
    for g, r in zip(top2, again):
        assert torch.equal(g, r)
    return want


@pytest.mark.gpu
@pytest.mark.parametrize(
    "pairs,n1,n2,valid_rate",
    [
        (None, 200, 300, 1.0),
        (None, 130, 257, 0.9),
        (None, 1, 1, 1.0),
        (None, 64, 90, 0.0),  # no valid column
        (3, 129, 127, 0.9),
        (42, 2048, 2048, 0.97),  # the calibration main path
    ],
)
def test_kernel_bit_exact_with_plain_version(cuda, pairs, n1, n2, valid_rate):
    _assert_bit_exact(cuda, *_inputs(n1 + n2, pairs, n1, n2, valid_rate))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [name for name, *_ in HC.kernel_cases(np.random.default_rng(0))])
def test_kernel_contract_cases(cuda, case):
    """The contract's edge cases: ties, 0 and 1 valid columns, garbage
    padding bits, a shape that is no multiple of any tile."""
    cases = {name: tensors for name, *tensors in HC.kernel_cases(np.random.default_rng(0))}
    _assert_bit_exact(cuda, *cases[case])


@pytest.mark.gpu
@pytest.mark.parametrize("pairs,n", [(42, 2048), (16, 1024)], ids=["calibration_step", "link_chunk"])
def test_kernel_main_path_shapes(cuda, pairs, n):
    _assert_bit_exact(cuda, *HC.main_path_case(np.random.default_rng(pairs), pairs, n))


@pytest.mark.gpu
def test_kernel_split_set_two_with_ties_across_splits(cuda):
    """One 128-row block, so set 2 is split over several blocks of a cluster
    (1000 columns: 8 tiles, one per split); each row's exact copies lie in
    two splits."""
    best, second, _ = _assert_bit_exact(cuda, *HC.split_ties_case(np.random.default_rng(11)))[:3]
    assert int((best == second).sum()) > 50 and int((best == 0).sum()) > 50


@pytest.mark.gpu
def test_kernel_one_valid_column_passes_lowe(cuda):
    p1, p2, v1, _ = (t.to(cuda) for t in _inputs(5, None, 40, 60, 1.0))
    v2 = torch.zeros(60, dtype=torch.bool, device=cuda)
    v2[33] = True
    idx, _, matched = H.match_descriptors(p1, p2, v1, v2)
    assert torch.equal(matched, v1) and bool((idx == 33).all())


@pytest.mark.gpu
def test_kernel_refuses_bad_inputs(cuda):
    p1, p2, _, v2 = (t.to(cuda) for t in _inputs(6, 2, 32, 48, 1.0))
    with pytest.raises(TypeError):
        hamming_cuda.hamming_top2(p1.to(torch.int64), p2, v2)
    with pytest.raises(ValueError):
        hamming_cuda.hamming_top2(p1[..., :8], p2, v2)
    with pytest.raises(ValueError):
        hamming_cuda.hamming_top2(p1.transpose(0, 1), p2, v2)


def test_wrapper_refuses_cpu_tensors():
    p1, p2, _, v2 = _inputs(7, None, 8, 9, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        hamming_cuda.hamming_top2(p1, p2, v2)


def test_cpu_tensors_take_the_plain_version():
    p1, p2, v1, v2 = _inputs(8, 2, 50, 70, 0.9)
    before = hamming_cuda.hamming_top2.launches
    got = H.match_descriptors(p1, p2, v1, v2)
    want = H.match_descriptors_reference(p1, p2, v1, v2)
    assert hamming_cuda.hamming_top2.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _mesh_relax_problem(device, seed=0, dtype=torch.float32):
    """A small ground-mesh relax on ``device``: 4 cameras over a refined
    3 x 3 vertex mesh, plane-ray rows of 2 to 5 rays and the three mesh
    priors. Returns (params, blocks, layout, free mask)."""
    from opencalibration_tpu_torch.relax import blocks as B
    from opencalibration_tpu_torch.relax import problem_builder as PB
    from opencalibration_tpu_torch.relax.tangent import RelaxParams, TangentLayout
    from opencalibration_tpu_torch.surface.mesh import TriMesh

    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid([0.0, 30.0, 60.0], [0.0, 30.0, 60.0])
    verts = np.column_stack([xs.ravel(), ys.ravel(), rng.normal(scale=0.5, size=9)])
    tris = np.asarray([[0, 1, 4], [0, 4, 3], [1, 2, 5], [1, 5, 4], [3, 4, 7], [3, 7, 6], [4, 5, 8], [4, 8, 7]])
    mesh = TriMesh(verts, tris.astype(np.int32))
    C, nb = 4, 64
    layout = TangentLayout(C, 32, 0, 1)
    floats, ids, flags = PB._tensors(dtype, device)
    quats = np.tile([0.0, 1.0, 0.0, 0.0], (C, 1)) + rng.normal(scale=0.02, size=(C, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    mesh_z = np.zeros(32)
    mesh_z[:9] = verts[:, 2]
    params = RelaxParams.create(floats(quats), floats(rng.uniform([10, 10, 60], [50, 50, 80], size=(C, 3))),
                                mesh_z=floats(mesh_z), dtype=dtype)
    tri = rng.integers(0, len(tris), nb)
    cam = np.stack([rng.permutation(C).tolist() + [0] for _ in range(nb)])
    dirs = rng.normal(scale=0.2, size=(nb, 5, 3))
    dirs[..., 2] = 1.0
    blocks = [
        B.plane_ray_block(layout, ids(tris[tri]), floats(verts[tris[tri]][:, :, :2]), ids(cam),
                          flags(np.arange(5)[None] < rng.integers(2, 6, size=(nb, 1))), floats(np.ones(nb)),
                          fixed_dir=floats(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True))),
        B.downwards_prior_block(layout, ids(np.arange(C)), floats(np.ones(C))),
    ] + PB._mesh_prior_blocks(layout, mesh, floats, ids)
    free = layout.build_free_mask(mesh_free=np.arange(32) < 9, device=device)
    return params, blocks, layout, free


@pytest.mark.gpu
@pytest.mark.parametrize("precond", ["jacobi", "block"])
def test_cg_solve_is_bit_identical_across_runs(cuda, precond):
    from opencalibration_tpu_torch.relax import lm

    params, blocks, layout, free = _mesh_relax_problem(cuda)
    runs = [lm.solve(params, blocks, layout, free, max_iterations=20, linear_solver="cg", cg_precond=precond)
            for _ in range(2)]
    (a, ia), (b, ib) = runs
    assert int(ia.iterations) == int(ib.iterations) > 0
    for f in ("quats", "mesh_z"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert torch.isfinite(a.mesh_z).all() and torch.equal(ia.final_cost, ib.final_cost)


@pytest.mark.gpu
def test_ground_mesh_relax_cuda_matches_cpu(cuda, tmp_path):
    """One MESH_REFINEMENT pass (ground-mesh relax, then refinement) from the
    same INITIAL_PROCESSING graph on CUDA and on the CPU, both in float32:
    orientations within 0.1 degrees, equal mesh topology."""
    import copy

    from opencalibration_tpu_torch.ops import ransac as R
    from opencalibration_tpu_torch.ops.quaternion import quat_angle, quat_conjugate, quat_multiply
    from opencalibration_tpu_torch.pipeline import stages as ST
    from opencalibration_tpu_torch.pipeline.pipeline import Pipeline
    from opencalibration_tpu_torch.testing import survey as S

    paths, _, _ = S.write_survey(str(tmp_path), 2, 3, relief_amplitude=8.0, relief_wavelength=70.0, device="cpu")
    uniforms = R.default_uniforms(ST.LINK_HYPOTHESES, 4, R.DEFAULT_SEED, "cpu")
    cpu = Pipeline(batch_size=3, device="cpu", ransac_uniforms=uniforms)
    cpu.add(paths)
    while cpu.get_state() == "INITIAL_PROCESSING":
        cpu.iterate_once()
    gpu = Pipeline(batch_size=3, device="cuda", ransac_uniforms=uniforms)
    for attr in ("graph", "surfaces", "gps_positions", "model_store"):
        setattr(gpu, attr, copy.deepcopy(getattr(cpu, attr)))
    gpu.reset_state("MESH_REFINEMENT")
    cpu.iterate_once()
    gpu.iterate_once()
    for p in (cpu, gpu):
        assert p.get_state() == "MESH_REFINEMENT" and len(p.surfaces) == 1
    a, b = cpu.surfaces[0].mesh, gpu.surfaces[0].mesh
    np.testing.assert_array_equal(a.triangles, b.triangles)
    nodes = {n.payload.path: n.payload.orientation for _, n in gpu.graph.nodes()}
    for _, n in cpu.graph.nodes():
        qa = torch.as_tensor(n.payload.orientation, dtype=torch.float64)
        qb = torch.as_tensor(nodes[n.payload.path], dtype=torch.float64)
        assert float(np.degrees(quat_angle(quat_multiply(qa, quat_conjugate(qb))))) < 0.1


def _points_groups(device, dtype, groups=3, cams=4, side=4, focal=600.0, seed=0):
    """Small bundle-adjustment groups that share one camera model, made
    without JAX: per group ``cams`` nadir cameras at varied altitudes over a
    ``side`` x ``side`` grid of points, pixels projected through the true
    model, then orientations and points perturbed and the focal started 2 %
    high. Returns the groups as built problems."""
    from opencalibration_tpu_torch.ops.distort import image_from_3d_world
    from opencalibration_tpu_torch.ops.quaternion import quat_boxplus, quat_normalize
    from opencalibration_tpu_torch.relax import blocks as B
    from opencalibration_tpu_torch.relax import problem_builder as PB
    from opencalibration_tpu_torch.relax.tangent import RelaxParams, TangentLayout
    from opencalibration_tpu_torch.types.camera import CameraModel

    rng = np.random.default_rng(seed)
    floats, ids, _ = PB._tensors(dtype, device)
    n_pts = side * side
    layout = TangentLayout(cams, 0, n_pts, 1)
    model = CameraModel.create(focal, (400.0, 300.0), pixels_cols=800, pixels_rows=600, dtype=torch.float64,
                               device="cpu")
    down = torch.tensor([0.0, 1.0, 0.0, 0.0], dtype=torch.float64)
    gx, gy = np.meshgrid(np.arange(side), np.arange(side))
    builts = []
    for g in range(groups):
        offset = np.asarray([100.0 * g, 0.0, 0.0])
        positions = np.asarray([[9, 9, 9], [11, 9, 14], [11, 11, 20], [9, 11, 27]], np.float64)[:cams] + offset
        quats = quat_normalize(quat_boxplus(down.expand(cams, 4), torch.as_tensor(rng.normal(scale=0.05, size=(cams, 3)))))
        points = np.column_stack([5.0 + gx.ravel(), 5.0 + gy.ravel(), ((gx + gy) % 2).ravel() - 10.0]) + offset
        pixels = torch.stack([image_from_3d_world(torch.as_tensor(points), model, torch.as_tensor(positions[c]), quats[c])
                              for c in range(cams)])  # [cams, n_pts, 2]
        start = quat_normalize(quat_boxplus(quats, torch.as_tensor(rng.normal(scale=0.02, size=(cams, 3)))))
        params = RelaxParams.create(
            floats(start.numpy()), floats(positions), points=floats(points + rng.normal(scale=0.05, size=points.shape)),
            focal=floats([focal * 1.02]), principal=floats([[400.0, 300.0]]), dtype=dtype,
        )
        blk = B.pixel_error_block(
            layout, ids(np.repeat(np.arange(cams), n_pts)), ids(np.tile(np.arange(n_pts), cams)),
            ids(np.zeros(cams * n_pts)), floats(pixels.reshape(-1, 2).numpy()), floats(np.ones(cams * n_pts)),
        )
        builts.append(PB.BuiltProblem(
            params=params, layout=layout, blocks=[blk],
            free_mask=layout.build_free_mask(points_free=True, focal_free=True, device=device),
            surface_free_mask=torch.zeros(layout.dim, dtype=torch.bool, device=device), cam_index={},
            model_index={7: 0}, mesh=None, inverse_models=False, track_points=np.zeros((0, 3)),
            track_errors=np.zeros(0),
        ))
    return builts


def _shared_solve(device, dtype):
    from opencalibration_tpu_torch.parallel import group_solver as GS

    batch = GS.build_group_batch(_points_groups(device, dtype), shared_intrinsics=True)
    solved, info = GS.solve_group_batch_shared(batch, pre_solve=False, max_iterations=40)
    return batch, solved, info


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_shared_solver_recovers_the_focal_on_the_cpu(dtype):
    """The joint solver over three groups on the CPU, in float64 and in the
    card's float32: the shared focal comes back from 612 to the true 600 px
    within 0.5 px, the same in every group, in the dtype and on the device
    the problem was given in."""
    batch, solved, info = _shared_solve("cpu", dtype)
    assert batch.layout.M == 1 and batch.num_groups == 3
    assert solved.focal.device.type == "cpu" and solved.focal.dtype == solved.quats.dtype == dtype
    assert abs(float(solved.focal[0, 0]) - 600.0) < 0.5 and float(info.final_cost) < 1e-2 * float(info.initial_cost)
    assert torch.equal(solved.focal[0], solved.focal[1]) and torch.equal(solved.focal[0], solved.focal[2])


@pytest.mark.gpu
def test_shared_solver_cuda_matches_cpu(cuda):
    """The joint solver in float32 on the card against the CPU: on each
    device every group's copy of the shared focal equal bit for bit; between
    the devices the focal within 1e-3 relative and quaternions within 1e-3."""
    _, gpu, gpu_info = _shared_solve(cuda, torch.float32)
    _, cpu, cpu_info = _shared_solve("cpu", torch.float32)
    assert gpu.focal.device.type == "cuda" and int(gpu_info.iterations) > 2 and int(cpu_info.iterations) > 2
    for solved in (gpu, cpu):
        assert torch.isfinite(solved.quats).all()
        assert torch.equal(solved.focal[0], solved.focal[1]) and torch.equal(solved.focal[0], solved.focal[2])
    f_gpu, f_cpu = float(gpu.focal[0, 0]), float(cpu.focal[0, 0])
    assert abs(f_gpu - 600.0) < 2.0 and abs(f_gpu / f_cpu - 1.0) < 1e-3
    flip = torch.sign(torch.sum(gpu.quats.cpu() * cpu.quats, dim=-1, keepdim=True))
    assert float((flip * gpu.quats.cpu() - cpu.quats).abs().max()) < 1e-3


# --- the orthomosaic tail ------------------------------------------------------


@pytest.mark.gpu
def test_lab_to_bgr_on_the_card_equals_numpy(cuda):
    from opencalibration_tpu_torch.ops.color import lab_u8_to_bgr

    lab = np.random.default_rng(0).integers(0, 256, (256, 256, 3), dtype=np.uint8)
    got = lab_u8_to_bgr(torch.from_numpy(lab).to(cuda))
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.cpu().numpy(), lab_u8_to_bgr(lab))


@pytest.mark.gpu
def test_color_balance_is_bit_identical_across_runs(cuda, tmp_path):
    """``solve_color_balance`` twice on the card from one set of
    correspondences: every parameter and the cost equal to the bit."""
    from opencalibration_tpu_torch.ortho.color_balance import solve_color_balance
    from opencalibration_tpu_torch.testing import ortho_cases

    state = ortho_cases.ground_truth_state(str(tmp_path))
    job = ortho_cases.run_ortho_tail(state, str(tmp_path), "cuda")["job"]
    assert len(job.correspondences) > 50
    positions = {nid: np.asarray(n.payload.position[:2]) for nid, n in state["graph"].nodes()}
    a = solve_color_balance(job.correspondences, positions, device="cuda")
    b = solve_color_balance(job.correspondences, positions, device="cuda")
    assert a.success and a.final_cost == b.final_cost
    np.testing.assert_array_equal(ortho_cases.balance_vector(a), ortho_cases.balance_vector(b))
    np.testing.assert_array_equal(ortho_cases.balance_vector(a), ortho_cases.balance_vector(job.balance))


@pytest.mark.gpu
def test_ortho_tail_cuda_matches_cpu(cuda, tmp_path):
    """Layers, balance and blend from one ground-truth state on the card and
    on the CPU, within ``ortho_cases``' stated tolerances."""
    from opencalibration_tpu_torch.testing import ortho_cases

    state = ortho_cases.ground_truth_state(str(tmp_path))
    on_card = ortho_cases.run_ortho_tail(state, str(tmp_path), "cuda")
    on_cpu = ortho_cases.run_ortho_tail(state, str(tmp_path), "cpu")
    print(ortho_cases.compare_ortho_tails(on_card, on_cpu))


@pytest.fixture
def one_thread():
    """One intra-op thread: beside other test processes torch's default of a
    thread a core makes many small CPU ops tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ortho_tail_runs_are_reproducible_on_the_cpu(tmp_path, one_thread):
    """The same comparison between two CPU runs holds trivially and to the
    bit: what the card is held to is a real bound, not a loose one."""
    from opencalibration_tpu_torch.testing import ortho_cases

    state = ortho_cases.ground_truth_state(str(tmp_path))
    a = ortho_cases.run_ortho_tail(state, str(tmp_path), "cpu", name="a")
    b = ortho_cases.run_ortho_tail(state, str(tmp_path), "cpu", name="b")
    out = ortho_cases.compare_ortho_tails(a, b)
    assert out["rgba_equal_share"] == 1.0 and out["balance_max_abs"] == 0.0 and out["correspondences"] > 50
    median, share = ortho_cases.median_l_error(a["ortho_path"], state["positions"])
    assert share > 0.6 and median <= 8.0


def _gated_case(seed, n1=2048, n2=2048):
    """Set 1 near copies of set 2 with duplicated columns (ties), predictions
    around the true positions, some far from every candidate."""
    rng = np.random.default_rng(seed)
    w2 = _words(rng, (n2,), garbage_padding=False)
    w2[1::7] = w2[0::7][: len(w2[1::7])]
    src = torch.from_numpy(rng.integers(0, n2, n1))
    w1 = _near_copies(rng, w2[src], 0.05)
    xy2 = torch.from_numpy(rng.uniform(0, 1600, (n2, 2)).astype(np.float32))
    pred = xy2[src] + torch.from_numpy(rng.normal(0, 40, (n1, 2)).astype(np.float32))
    pred[::11] = 9000.0
    v1 = torch.from_numpy(rng.random(n1) > 0.05)
    v2 = torch.from_numpy(rng.random(n2) > 0.05)
    xy1 = torch.from_numpy(rng.uniform(0, 1600, (n1, 2)).astype(np.float32))
    return w1, xy1, v1, w2, xy2, v2, pred


@pytest.mark.gpu
def test_gated_match_cuda_matches_cpu(cuda):
    """The dense matcher on the card equals the CPU bit for bit (idx, best,
    good): integer distances from a float32 product with TF32 off."""
    from opencalibration_tpu_torch.dense.dense_stereo import gated_match

    args = _gated_case(0)
    want = gated_match(*args)
    got = gated_match(*(a.to(cuda) for a in args))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert 0 < int(want[2].sum()) < len(want[2])


def _dense_entry(directory):
    """The 2 x 3 ground-truth state with each node's features its own dense
    set, extracted on the CPU, and those sets."""
    from opencalibration_tpu_torch.dense.dense_stereo import extract_dense_featuresets
    from opencalibration_tpu_torch.testing import ortho_cases

    state = ortho_cases.ground_truth_state(directory)
    graph = state["graph"]
    dense = extract_dense_featuresets(graph, [nid for nid, _ in sorted(graph.nodes())], device="cpu")
    for nid, node in graph.nodes():
        node.payload.features = dense[nid]
    return state, dense


@pytest.mark.gpu
def test_densify_mesh_cuda_matches_cpu(cuda, tmp_path):
    """densify_mesh from one state and one set of dense features on the card
    and on the CPU, float64 geometry on both: the same point count, the
    points within 1e-9 m."""
    import copy

    from opencalibration_tpu_torch.dense.dense_stereo import densify_mesh

    state, dense = _dense_entry(str(tmp_path))
    out = {}
    for dev in ("cpu", "cuda"):
        surfaces = copy.deepcopy(state["surfaces"])
        stats = {}
        n = densify_mesh(state["graph"], state["model_store"], surfaces, dense_features=dense, device=dev,
                         stats=stats)
        out[dev] = (n, surfaces[0].cloud[-1], stats)
    (n_c, pts_c, _), (n_g, pts_g, stats) = out["cpu"], out["cuda"]
    print(f"densify_mesh: {n_g} points on the card, {n_c} on the CPU; {stats['pairs']} pairs, "
          f"gated_match {1e3 * stats['match_seconds'] / stats['pairs']:.3f} ms a pair")
    assert n_g == n_c > 50
    np.testing.assert_allclose(pts_g, pts_c, rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def three_group_batch(tmp_path_factory):
    """The first MESH_REFINEMENT pass of the 2 x 3 relief survey with pose
    groups of 2 (three groups, four lanes), from the port's own
    INITIAL_PROCESSING state on the CPU in float64: (the batch as it entered
    the solve, the pre-solve flag, the LM budget, the CPU's result)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import copy

    from opencalibration_tpu_torch.parallel import group_solver as GS
    from opencalibration_tpu_torch.pipeline import stages as ST
    from opencalibration_tpu_torch.pipeline.pipeline import Pipeline, PipelineState
    from opencalibration_tpu_torch.testing import survey as TS

    paths, _, _ = TS.write_survey(str(tmp_path_factory.mktemp("groups")), 2, 3, relief_amplitude=8.0,
                                  relief_wavelength=70.0, device="cpu")
    p = Pipeline(batch_size=3, device="cpu", dtype=torch.float64)
    p.add(paths)
    while p.get_state() == PipelineState.INITIAL_PROCESSING:
        p.iterate_once()
    calls = []
    orig, size = ST.solve_group_batch, ST.POSE_GROUP_SIZE

    def recording(batch, pre_solve, **kw):
        entry = copy.deepcopy(batch)
        out = orig(batch, pre_solve, **kw)
        calls.append((entry, pre_solve, kw["max_iterations"], GS.fetch_solved(out[0]), out[1]))
        return out

    ST.solve_group_batch, ST.POSE_GROUP_SIZE = recording, 2
    try:
        p.iterate_once()
    finally:
        ST.solve_group_batch, ST.POSE_GROUP_SIZE = orig, size
    assert calls and calls[0][0].num_groups == 3
    return calls[0]


@pytest.mark.gpu
def test_batched_group_solve_cuda_matches_cpu(cuda, three_group_batch):
    """The three-group batch carried to the card and solved there: every
    lane's rotations and mesh heights within 1e-4 of the CPU's."""
    from opencalibration_tpu_torch import interop
    from opencalibration_tpu_torch.ops.quaternion import quat_angle, quat_conjugate, quat_multiply
    from opencalibration_tpu_torch.parallel import group_solver as GS

    batch, pre_solve, iters, cpu, cpu_info = three_group_batch
    on_card = interop.group_batch_from(batch, cuda)
    solved, info = GS.solve_group_batch(on_card, pre_solve, max_iterations=iters)
    got = GS.fetch_solved(solved)
    q_got, q_cpu = torch.from_numpy(got.quats), torch.from_numpy(cpu.quats)
    ang = quat_angle(quat_multiply(q_got, quat_conjugate(q_cpu)))
    assert float(ang.max()) <= 1e-4
    np.testing.assert_allclose(got.mesh_z, cpu.mesh_z, rtol=0, atol=1e-4)
    assert info.iterations.shape == (3,) and info.iterations.is_cuda


@pytest.mark.gpu
def test_batched_group_solve_on_two_card_shards_matches_one_device(cuda, three_group_batch):
    """The three-group batch on the card, its lanes cut into two shards of
    the same card: every lane equal to the one-device solve bit for bit or
    within 1e-12 of each leaf's largest magnitude (at least 1), with equal
    iterations. (A lane's last bits depend on its batch through the batched
    products; the lane-batched LM pins cuSOLVER for the factorisations.)"""
    import copy

    from opencalibration_tpu_torch import interop
    from opencalibration_tpu_torch.parallel import group_solver as GS
    from opencalibration_tpu_torch.relax.tangent import FIELDS

    batch, pre_solve, iters, _, _ = three_group_batch
    on_card = interop.group_batch_from(batch, cuda)
    one, one_info = GS.solve_group_batch(copy.deepcopy(on_card), pre_solve, max_iterations=iters)
    two, two_info = GS.solve_group_batch(on_card, pre_solve, max_iterations=iters, devices=[cuda, cuda])
    assert torch.equal(one_info.iterations, two_info.iterations) and two.quats.is_cuda
    for f in FIELDS:
        a, b = getattr(two, f), getattr(one, f)
        assert torch.equal(a, b) or float((a - b).abs().max()) <= 1e-12 * max(1.0, float(b.abs().max())), f


@pytest.mark.gpu
def test_shared_solver_on_three_card_shards_matches_one(cuda):
    """The joint solver of three groups in float64 on the card, on three
    shards of it against one: within 1e-9 relative, equal iterations, the
    shared focal equal in every group."""
    from opencalibration_tpu_torch.parallel import group_solver as GS
    from opencalibration_tpu_torch.relax.tangent import FIELDS

    out = []
    for devices in (None, [cuda] * 3):
        batch = GS.build_group_batch(_points_groups(cuda, torch.float64), shared_intrinsics=True)
        out.append(GS.solve_group_batch_shared(batch, pre_solve=False, max_iterations=40, devices=devices))
    (one, one_info), (three, three_info) = out
    assert int(one_info.iterations) == int(three_info.iterations) > 2
    assert torch.equal(three.focal[0], three.focal[1]) and torch.equal(three.focal[0], three.focal[2])
    assert abs(float(three.focal[0, 0]) - 600.0) < 0.5
    for f in FIELDS:
        a, b = getattr(three, f), getattr(one, f)
        if a.numel():
            assert float((a - b).abs().max()) <= 1e-9 * max(float(b.abs().max()), 1e-300), f


@pytest.mark.gpu
def test_dryrun_multidevice_on_two_card_shards(cuda):
    from opencalibration_tpu_torch.parallel import dryrun

    dryrun.dryrun_multidevice([cuda, cuda])
    fn, args = dryrun.entry(cuda)
    assert all(torch.isfinite(x).all() and x.is_cuda for x in fn(*args))


@pytest.mark.gpu
def test_fed_extraction_cuda_matches_cpu(cuda):
    """``extract_features(diffusion="fed")`` of two overlapping texture crops:
    equal keypoint counts, 99 % of the keypoints within 0.01 px."""
    from opencalibration_tpu_torch.ops import features as F
    from opencalibration_tpu_torch.testing import survey as TS

    tex = TS.make_texture(0, size=512)
    images = torch.from_numpy(np.stack([tex[0:120, 0:160], tex[30:150, 40:200]]).astype(np.float32))
    got = F.extract_features(images.to(cuda), 256, diffusion="fed")
    want = F.extract_features(images, 256, diffusion="fed")
    valid = want["valid"]
    assert torch.equal(got["valid"].sum(1).cpu(), valid.sum(1)) and valid.sum() > 20
    close = ((got["xy"].cpu() - want["xy"]).abs() <= 0.01).all(-1) & valid
    assert int(close.sum()) >= 0.99 * int(valid.sum())
