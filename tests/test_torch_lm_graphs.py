"""The LM step's CUDA graphs (``relax/lm.py``: ``graph_key``, ``GraphCache``,
``_StepGraphs``) and the device-side constants of the residual families.

On the CPU: what the key holds, the cache's second-sighting rule and its
least-recently-used bound, that a CPU solve captures nothing, that the
buffered step (with a capture that reruns the functions eagerly) gives the
eager solve's bits, and that ``device_constant`` gives every family the
residuals and Jacobians of the old ``torch.tensor`` constants to the bit.

Tests marked ``gpu`` run the replayed solve on the card against the eager
one and skip without a card; the device is looked up inside a fixture. This
file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_lm_graphs.py
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from opencalibration_tpu_torch.ops import quaternion as Q
from opencalibration_tpu_torch.relax import blocks as B
from opencalibration_tpu_torch.relax import lm
from opencalibration_tpu_torch.relax.tangent import FIELDS, RelaxParams, TangentLayout
from opencalibration_tpu_torch.utils import performance as perf

try:
    from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
except ImportError:  # run alone on the card, where another package may be named ``tests``
    pass

ROWS, COLS = 4, 8  # mesh grid: V = 32, with C = 16 cameras T = 88 as in the calibrate cell
SPACING, HEIGHT, FOCAL, PRINCIPAL = 10.0, 30.0, 600.0, (400.0, 300.0)


def _problem(kind, rays=64, *, cameras=16, device="cpu", dtype=torch.float64, seed=0):
    """A ground-mesh problem whose rays meet on the mesh, the cameras turned
    a little off the truth. ``final``: fixed-direction plane rays and the
    downward prior (FINAL_GLOBAL_RELAX's families); ``mesh``: the same with
    the mesh priors (MESH_REFINEMENT's); ``camera``: pixel-form plane rays,
    the mesh priors and the radial monotonicity prior with the intrinsics
    free (CAMERA_PARAMETER_RELAX's); ``all``: every family, points and
    pixel errors too. Returns (params, blocks, layout, free mask)."""
    rng = np.random.default_rng(seed)
    C, V, P = cameras, ROWS * COLS, 4 if kind == "all" else 0
    layout = TangentLayout(C, V, P, 1)
    f64 = torch.float64
    gx, gy = np.meshgrid(np.arange(COLS) * SPACING, np.arange(ROWS) * SPACING)
    verts = np.stack([gx.ravel(), gy.ravel(), rng.normal(0.0, 0.2, V)], 1)
    pos = np.stack([rng.uniform(0, (COLS - 1) * SPACING, C), rng.uniform(0, (ROWS - 1) * SPACING, C),
                    np.full(C, HEIGHT)], 1)
    down = torch.tensor([0.0, 1.0, 0.0, 0.0], dtype=f64)
    truth = Q.quat_boxplus(down.expand(C, 4), torch.as_tensor(rng.normal(0, 0.02, (C, 3))))
    quats = Q.quat_boxplus(truth, torch.as_tensor(rng.normal(0, 0.005, (C, 3))))

    def cam_dirs(cam, pts):  # camera-frame unit directions to world points [..., 3]
        d = torch.as_tensor(pts) - torch.as_tensor(pos[cam])
        d = Q.quat_rotate_inverse(truth[torch.as_tensor(cam)], d)
        return d / torch.linalg.norm(d, dim=-1, keepdim=True)

    def pixels(d):
        return FOCAL * d[..., :2] / d[..., 2:] + torch.tensor(PRINCIPAL, dtype=f64)

    # plane rays: a triangle of a random grid cell, up to five cameras at a
    # point inside it
    r, c = rng.integers(0, ROWS - 1, rays), rng.integers(0, COLS - 1, rays)
    i00 = r * COLS + c
    tri = np.stack([i00, i00 + 1, i00 + COLS], 1)
    w = rng.dirichlet(np.ones(3), rays)
    target = np.einsum("bk,bkd->bd", w, verts[tri])
    cam5 = np.stack([rng.permutation(C)[:5] for _ in range(rays)])
    valid = np.arange(5)[None, :] < rng.integers(2, 6, rays)[:, None]
    dirs = cam_dirs(cam5, target[:, None, :].repeat(5, 1))

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt)

    def ids(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int64)

    form = dict(pixel=t(pixels(dirs))) if kind in ("camera", "all") else dict(fixed_dir=t(dirs))
    blocks = [
        B.plane_ray_block(layout, ids(tri), t(verts[tri][..., :2]), ids(cam5), torch.as_tensor(valid),
                          t(np.ones(rays)), model_i=ids(np.zeros(rays)), **form),
        B.downwards_prior_block(layout, ids(np.arange(C)), t(np.ones(C))),
    ]
    if kind != "final":
        flat = [(i, i + 1) for i in range(V) if (i + 1) % COLS] + [(i, i + COLS) for i in range(V - COLS)]
        flat = np.asarray(flat)
        cells = np.asarray([rr * COLS + cc for rr in range(ROWS - 1) for cc in range(COLS - 1)])
        a, b, cc, d = cells + 1, cells + COLS, cells, cells + COLS + 1
        blocks += [
            B.mesh_flat_block(layout, ids(flat[:, 0]), ids(flat[:, 1]), t(np.ones(len(flat)))),
            B.mesh_anchor_block(layout, ids(np.arange(V)), t(verts[:, 2]), t(np.ones(V))),
            B.mesh_smooth_block(layout, ids(a), ids(b), ids(cc), ids(d), *(t(verts[v][:, :2]) for v in (a, b, cc, d)),
                                t(np.ones(len(cells)))),
        ]
    if kind in ("camera", "all"):
        blocks.append(B.monotonicity_block(layout, ids([0]), t([0.8]), t([np.sqrt(rays / 10.0)]), t([1.0])))
    points = np.zeros((0, 3))
    if kind == "all":
        points = verts[rng.integers(0, V, P)] + rng.normal(0, 0.5, (P, 3))
        obs_cam, obs_pt = rng.integers(0, C, 3 * P), np.repeat(np.arange(P), 3)
        obs_px = pixels(cam_dirs(obs_cam, points[obs_pt])) + torch.as_tensor(rng.normal(0, 0.5, (3 * P, 2)))
        blocks.append(B.pixel_error_block(layout, ids(obs_cam), ids(obs_pt), ids(np.zeros(3 * P)), t(obs_px),
                                          t(np.ones(3 * P))))
        pa, pb = ids(np.arange(C - 1)), ids(np.arange(1, C))
        rel = Q.quat_multiply(truth[pb], Q.quat_conjugate(truth[pa]))
        rel_q = Q.quat_boxplus(rel[:, None].expand(C - 1, 4, 4), torch.as_tensor(rng.normal(0, 0.3, (C - 1, 4, 3))))
        tdir = torch.as_tensor(pos[1:] - pos[:-1])
        rel_t = Q.quat_rotate_inverse(truth[pa], tdir)[:, None] + torch.as_tensor(rng.normal(0, 0.3, (C - 1, 4, 3)))
        scores = torch.as_tensor(np.sort(rng.uniform(5, 200, (C - 1, 4)))[:, ::-1].copy())
        blocks.append(B.decomposed_rotation_block(layout, pa, pb, t(rel_q), t(rel_t), t(scores),
                                                  scores > 50.0, t(np.ones(C - 1))))
    intrinsics = kind in ("camera", "all")
    params = RelaxParams.create(
        t(quats), t(pos), mesh_z=t(verts[:, 2] + rng.normal(0, 0.3, V)), points=t(points.reshape(-1, 3)),
        focal=t([FOCAL * 1.02]), principal=t([PRINCIPAL]), radial=t([[0.01, 0.0, 0.0]]),
        tangential=t([[0.0, 0.0]]), dtype=dtype,
    )
    free = layout.build_free_mask(mesh_free=True, points_free=kind == "all", focal_free=intrinsics,
                                  principal_free=intrinsics, radial_tiers=3 if intrinsics else 0, device="cpu")
    move = lambda x: x.to(device)  # noqa: E731
    params = RelaxParams(**{f: move(getattr(params, f)) for f in FIELDS})
    blocks = tuple(dataclasses.replace(b, slots=move(b.slots), weight=move(b.weight),
                                       data={k: move(v) for k, v in b.data.items()}) for b in blocks)
    return params, blocks, layout, move(free)


def _nudged(params, seed=1):
    """Other values of the same structure: every camera turned a little."""
    g = torch.Generator().manual_seed(seed)
    turn = 0.003 * torch.randn(params.C, 3, generator=g, dtype=torch.float64)
    return dataclasses.replace(params, quats=Q.quat_boxplus(params.quats, turn.to(params.quats)))


def _bits(x):
    x = torch.as_tensor(x).contiguous()
    if x.is_floating_point():
        return x.view(torch.int64 if x.element_size() == 8 else torch.int32)
    return x


def _assert_same_solve(got, want):
    (p, info), (p_ref, info_ref) = got, want
    for f in FIELDS:
        assert torch.equal(_bits(getattr(p, f)), _bits(getattr(p_ref, f))), f
    for f in dataclasses.fields(lm.SolveInfo):
        assert torch.equal(_bits(getattr(info, f.name)).cpu(), _bits(getattr(info_ref, f.name)).cpu()), f.name


@pytest.fixture
def counters():
    perf.reset_performance_counters()
    yield lambda: {k: perf.get_event_count(k) for k in ("lm graph captures", "lm graph steps", "lm steps")}
    perf.reset_performance_counters()


# --- the key ----------------------------------------------------------------


def _key(params, blocks, layout, free, linear_solver="cholesky", tolerances=(1e-8, 1e-6)):
    return lm.graph_key(params, blocks, layout, free, linear_solver, tolerances)


def _grown(blk, n=1):
    """The block with ``n`` more instances (copies of its last)."""
    def grow(x):
        return torch.cat([x, x[-1:].expand((n,) + x.shape[1:])])
    return dataclasses.replace(blk, slots=grow(blk.slots), weight=grow(blk.weight),
                               data={k: grow(v) for k, v in blk.data.items()})


def _with_first(blocks, **changes):
    return (dataclasses.replace(blocks[0], **changes),) + tuple(blocks[1:])


CHANGES = {
    "route": lambda p, b, lay, fr: _key(p, b, lay, fr, linear_solver="cg"),
    "huber_delta": lambda p, b, lay, fr: _key(p, _with_first(b, huber_delta=0.5), lay, fr),
    "leaf_shape": lambda p, b, lay, fr: _key(p, (_grown(b[0]),) + b[1:], lay, fr),
    "leaf_dtype": lambda p, b, lay, fr: _key(
        p, _with_first(b, data={**b[0].data, "ray_valid": b[0].data["ray_valid"].to(torch.uint8)}), lay, fr),
    "layout_dim": lambda p, b, lay, fr: _key(p, b, TangentLayout(lay.C, lay.V, lay.P, 2), fr),
    "parameter_tolerance": lambda p, b, lay, fr: _key(p, b, lay, fr, tolerances=(1e-7, 1e-6)),
    "function_tolerance": lambda p, b, lay, fr: _key(p, b, lay, fr, tolerances=(1e-8, 1e-5)),
}


@pytest.mark.parametrize("change", ["none"] + sorted(CHANGES))
def test_graph_key(change):
    params, blocks, layout, free = _problem("mesh", seed=0)
    key = _key(params, blocks, layout, free)
    if change == "none":
        # another problem of the same structure: other values, other tensors
        other = _problem("mesh", seed=5)
        assert _key(*other) == key
        assert hash(_key(*other)) == hash(key)
    else:
        assert CHANGES[change](params, blocks, layout, free) != key


# --- the cache's bookkeeping --------------------------------------------------


def _builds(cache, keys):
    """What ``lookup`` returns for each key in turn, a stub building the
    graphs: None, or the number of the build."""
    built = []

    def build():
        built.append(len(built))
        return built[-1]

    return [cache.lookup(k, build) for k in keys]


def test_second_sighting_captures_and_later_sightings_reuse():
    cache = lm.GraphCache(capacity=2, capture=None)
    assert _builds(cache, ["a", "b", "a", "a", "b", "c", "b"]) == [None, None, 0, 0, 1, None, 1]
    assert len(cache) == 2


def test_least_recently_used_key_leaves_first():
    cache = lm.GraphCache(capacity=2, capture=None)
    got = _builds(cache, ["a", "a", "b", "b", "a", "c", "c", "b", "a", "b"])
    # a, b captured; a used again; c's capture pushes b (least recent) out;
    # b is then new again (seen once), while a is still held
    assert got == [None, 0, None, 1, 0, None, 2, None, 0, 3]
    assert len(cache) == 2


# --- the CPU path -------------------------------------------------------------


def test_cpu_solve_captures_nothing(counters):
    params, blocks, layout, free = _problem("final")
    runs = [lm.solve(params, blocks, layout, free, max_iterations=3) for _ in range(3)]
    counts = counters()
    assert counts["lm graph captures"] == 0 and counts["lm graph steps"] == 0
    assert counts["lm steps"] == sum(int(info.iterations) for _, info in runs) > 0
    assert len(lm._GRAPHS) == 0


def _eager_capture(fns, device):
    """A capture that reruns each function at every replay."""
    return fns


def _starts(params, blocks, layout, free, **kw):
    """Four solves of one structure: twice from ``params``, from the first
    solve's answer, and from other values with the mesh alone free (the
    surface pre-solve's mask). On the mesh problem the first two end on
    rejected steps and the third starts with them, so the damping state
    carried across steps and reset across solves is read."""
    solved, _ = lm.solve(params, blocks, layout, free, **kw)
    surface = layout.build_free_mask(rot_free=torch.zeros(layout.C, dtype=torch.bool), mesh_free=True,
                                     device=free.device)
    return (params, free), (params, free), (solved, free), (_nudged(params), surface)


@pytest.mark.parametrize("linear_solver", ["cholesky", "cg"])
@pytest.mark.parametrize("kind", ["mesh", "camera"])
def test_buffered_step_gives_the_eager_bits(monkeypatch, counters, kind, linear_solver):
    """The graph path's buffers, loads and write-backs, with a capture that
    reruns the functions: the solves of one structure match the eager ones
    bit for bit, the first from its eager run, later ones from the cache."""
    params, blocks, layout, free = _problem(kind, rays=32)
    kw = dict(max_iterations=8, linear_solver=linear_solver, init_lambda=1e-4)
    starts = _starts(params, blocks, layout, free, **kw)
    eager = [lm.solve(p, blocks, layout, fr, **kw) for p, fr in starts]
    assert counters()["lm graph steps"] == 0
    monkeypatch.setattr(lm, "_GRAPHS", lm.GraphCache(lm.GRAPH_CACHE_SIZE, _eager_capture, device_type="cpu"))
    buffered = [lm.solve(p, blocks, layout, fr, **kw) for p, fr in starts]
    for got, want in zip(buffered, eager):
        _assert_same_solve(got, want)
    iterations = [int(info.iterations) for _, info in buffered]
    assert min(iterations) > 1
    counts = counters()
    assert counts["lm graph captures"] == 1
    assert counts["lm graph steps"] == sum(iterations[1:])


# --- the device-side constants ------------------------------------------------


def _old_constant(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


def _residuals_and_jacobians(params, blk):
    z = torch.zeros(blk.slots.shape[1], dtype=params.quats.dtype)
    r = vmap(lambda d: blk.resid_one(z, d, params))(blk.data)
    J = vmap(lambda d: jacfwd(lambda dl: blk.resid_one(dl, d, params))(z))(blk.data)
    return r, J


def _families(dtype):
    params, blocks, _, _ = _problem("all", rays=16, cameras=6, dtype=dtype)
    fixed = _problem("final", rays=16, cameras=6, dtype=dtype)[1][0]
    found = {b.name: b for b in blocks}
    found["plane_ray_fixed_dir"] = fixed
    return params, found


FAMILIES = ("decomposed_rotation", "downwards_prior", "mesh_anchor", "mesh_flat", "mesh_smooth", "monotonicity",
            "pixel_error", "plane_ray", "plane_ray_fixed_dir")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("family", FAMILIES)
def test_device_constants_give_the_old_bits(monkeypatch, family, dtype):
    params, families = _families(dtype)
    blk = families[family]
    new = _residuals_and_jacobians(params, blk)
    monkeypatch.setattr(B, "device_constant", _old_constant)
    monkeypatch.setattr(Q, "device_constant", _old_constant)
    old = _residuals_and_jacobians(params, blk)
    for a, b in zip(new, old):
        assert a.dtype == dtype and torch.isfinite(a).all()
        assert torch.equal(_bits(a), _bits(b))


# --- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CARD_CASES = {  # the calibrate cell's two structures at 1600 px, and CAMERA_PARAMETER_RELAX's families
    "final": dict(kind="final", rays=4096),
    "mesh": dict(kind="mesh", rays=1024),
    "camera": dict(kind="camera", rays=1024),
}


@pytest.mark.gpu
@pytest.mark.parametrize("linear_solver", ["auto", "cg"])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_replayed_solve_is_the_eager_solve(cuda, monkeypatch, counters, case, linear_solver):
    """``_starts``' four solves of each structure in a fresh cache (eager,
    then captured and replayed, then replayed) against the eager solves of
    the same starts on the same card, bit for bit."""
    params, blocks, layout, free = _problem(device=cuda, **CARD_CASES[case])
    kw = dict(max_iterations=12, linear_solver=linear_solver, init_lambda=1e-4)
    monkeypatch.setattr(lm, "_GRAPHS", lm.GraphCache(lm.GRAPH_CACHE_SIZE, device_type="none"))
    starts = _starts(params, blocks, layout, free, **kw)
    eager = [lm.solve(p, blocks, layout, fr, **kw) for p, fr in starts]
    monkeypatch.setattr(lm, "_GRAPHS", lm.GraphCache(lm.GRAPH_CACHE_SIZE))
    perf.reset_performance_counters()
    replayed = [lm.solve(p, blocks, layout, fr, **kw) for p, fr in starts]
    torch.cuda.synchronize()
    iterations = [int(info.iterations) for _, info in replayed]
    counts = counters()
    assert counts["lm graph captures"] == 1
    assert counts["lm graph steps"] == sum(iterations[1:]) > 0
    for got, want in zip(replayed, eager):
        _assert_same_solve(got, want)
