"""The port's hand-written CUDA kernel against its plain PyTorch version.

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
