"""The port's bench_kernels and bench_lm_solvers twins and bench_fed_ab's
reprojection against the repository's root scripts, on the CPU; every
twin's lines at a small size; the twins without jax, cv2 or PIL. About 60 s
alone on this suite's one torch thread.

- bench_kernels.py's inputs and counts are captured without its heavy work:
  its module-level ``timeit`` records ``(fn, args)`` and returns a fixed
  time, its ``report`` records ``(name, flops, bytes)``. The twin's inputs
  at the original's sizes equal them bit for bit (the descriptors as int32
  bit patterns of the same words; the LM problem's blocks and free mask from
  the original's jitted closure). The Hamming, RANSAC and LM operation
  counts equal the original's formulas, and the kernel line's equals the
  Hamming line's. The byte counts and the extraction's operations differ by
  design and equal the hand counts below.
- ``make_big_mesh_problem`` at C = 12, Vg = 64, NB = 256 in both packages:
  every parameter and every block field equal (ids by value). LM iterations
  of each solver against the JAX package's, equal counts and every field
  within a bound relative to its largest magnitude: on the problem as built
  (float32) within 1e-4, ROADMAP 3b's floor, after one Cholesky iteration
  and after one and two CG iterations; on the problem cast to float64 within
  1e-9 after one and two iterations of each (measured 3e-15 relative). Not
  after two float32 Cholesky iterations: there the JAX package's own float32
  dense solve leaves its float64 result (cost 1.09363 against 1.09517,
  quaternions 2.1e-3 apart) while the port's stays with it (1.09517), a
  reference-side float32 behaviour (ROADMAP 3b).
- ``_reproject`` of both packages on the same float64 inputs within 1e-9 px.
"""

import dataclasses
import inspect
import io
import json
import os
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_fed_ab as JFA  # noqa: E402
import bench_kernels as JK  # noqa: E402
import bench_lm_solvers as JLS  # noqa: E402
from opencalibration_tpu.relax import lm as JLM  # noqa: E402
from opencalibration_tpu_torch.bench import bench_extract_profile as TEP  # noqa: E402
from opencalibration_tpu_torch.bench import bench_fed_ab as TFA  # noqa: E402
from opencalibration_tpu_torch.bench import bench_kernels as TK  # noqa: E402
from opencalibration_tpu_torch.bench import bench_lm_solvers as TLS  # noqa: E402
from opencalibration_tpu_torch.relax import lm as TLM  # noqa: E402
from opencalibration_tpu_torch.relax.tangent import FIELDS  # noqa: E402
from tests.torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

SMALL_PROBLEM = (12, 64, 256)  # C, Vg, NB
FLOAT32_REL = 1e-4
FLOAT64_REL = 1e-9
REPROJECT_PX = 1e-9

# hand counts at the original's sizes
N = 4096
B, H, W, K = 8, 1200, 1600, 2048
OCTAVE_PIXELS = [B * H * W, B * 600 * 800, B * 300 * 400, B * 150 * 200]
# taps of a blur pass (radius ceil(3 sigma)): the base blur at 1.6 has 11; the
# sublevel increments 1.03, 1.6, 2.16 have 9, 11, 15; the blur to the next
# octave's base (1.73) 13; describe's blur at 1.0 7. A Sobel derivative in
# separable form is 3 + 2 multiply-adds a pixel: the Hessian's five (Lx, Ly,
# Lxx, Lxy, Lyy) with its determinant and scale are 54 operations a pixel and
# level, describe's two gradients 20
EXTRACT_OPS = (
    2 * 2 * 11 * OCTAVE_PIXELS[0]
    + sum(2 * 2 * (9 + 11 + 15) * p + 4 * (5 * 2 * 5 + 4) * p for p in OCTAVE_PIXELS)
    + sum(2 * 2 * 13 * p for p in OCTAVE_PIXELS[:3])
    + 2 * 2 * 7 * OCTAVE_PIXELS[0] + 2 * 2 * 5 * OCTAVE_PIXELS[0]
    + B * K * (9 + 29) * 3 * 4 * 2
)
HAMMING_OPS = 2 * N * N * 486  # a multiply-add per descriptor bit and distance
# images in; per keypoint xy 8, strength 4, sigma 4, level 8, valid 1, angle 4, descriptor 64 out
EXTRACT_BYTES = B * H * W * 4 + B * K * 93
HAMMING_BYTES = 2 * N * 64 + N * N * 4  # packed words in, int32 distances out
TOP2_BYTES = 2 * N * 64 + N + 3 * 4 * N  # packed words and valid2 in, best / second / index out
# rays, rays, quality (float32) and valid in; model, inliers, score, four
# quaternions, translations and scores out
RANSAC_BYTES = 1024 * (12 + 12 + 4 + 1) + (36 + 1024 + 4 + 64 + 48 + 16)
# parameters (C = 50, V = 512, M = 1, float32), the plane-ray block (slots
# [2048, 24], vertex and camera ids, model ids: int64; triangle xy and fixed
# rays float32; ray validity bool; weight), the prior (slots [50, 3], ids,
# prior weights, weights), the free mask [670]; out the quaternions and the
# iteration count
LM_BYTES = (
    (50 * 16 + 50 * 12 + 512 * 4 + 4 + 8 + 12 + 8)
    + (2048 * 24 * 8 + 2048 * 3 * 8 + 2048 * 6 * 4 + 2048 * 5 * 8 + 2048 * 5 + 2048 * 8 + 2048 * 15 * 4 + 2048 * 4)
    + (50 * 3 * 8 + 50 * 8 + 50 * 4 + 50 * 4) + 670
    + 50 * 16 + 8
)


def _capture(module, names, **kw):
    """Run ``module``'s bench functions ``names`` with its ``timeit`` and
    ``report`` replaced: {line: dict(fn, args, flops, bytes)}."""
    calls, reports = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(module, "timeit", lambda fn, *args, **k: calls.append((fn, args)) or 1.0)
    mp.setattr(module, "report", lambda name, seconds, flops, bytes_moved, *a, **k: reports.append(
        (name, flops, bytes_moved)))
    try:
        for name in names:
            getattr(module, name)(**kw)
    finally:
        mp.undo()
    return {name: dict(fn=fn, args=args, flops=r[1], bytes=r[2], label=r[0])
            for name, (fn, args), r in zip(names, calls, reports)}


LINES = ("bench_extract", "bench_hamming", "bench_ransac", "bench_lm")


@pytest.fixture(scope="module")
def captured():
    return (_capture(JK, LINES), _capture(TK, LINES + ("bench_hamming_top2",), device="cpu"))


def _closure(fn):
    """The free variables of a (jitted) function."""
    return inspect.getclosurevars(getattr(fn, "__wrapped__", fn)).nonlocals


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind == "f":
        assert got.dtype == want.dtype and np.array_equal(got.view(np.uint8), want.view(np.uint8))
    else:
        np.testing.assert_array_equal(got, want)


def test_extract_and_ransac_inputs_equal_the_original(captured):
    jax_lines, port_lines = captured
    for line in ("bench_extract", "bench_ransac"):
        j_args, t_args = jax_lines[line]["args"], port_lines[line]["args"]
        assert len(j_args) == len(t_args)
        for j, t in zip(j_args, t_args):
            _same_bits(t.numpy(), j)
    assert port_lines["bench_extract"]["args"][0].shape == (B, H, W)


def test_hamming_inputs_equal_the_original_words(captured):
    jax_lines, port_lines = captured
    j1, j2 = (np.asarray(a) for a in jax_lines["bench_hamming"]["args"])
    assert j1.dtype == np.uint32 and j1.shape == (N, 16)
    for line, lead in (("bench_hamming", ()), ("bench_hamming_top2", (1,))):
        args = port_lines[line]["args"]
        for t, j in zip(args[:2], (j1, j2)):
            assert t.dtype == torch.int32 and t.shape == lead + (N, 16)
            np.testing.assert_array_equal(t.numpy().reshape(N, 16).view(np.uint32), j)
    valid2 = port_lines["bench_hamming_top2"]["args"][2]
    assert valid2.shape == (1, N) and bool(valid2.all())


def _assert_block_equal(t_blk, j_blk):
    assert t_blk.name == j_blk.name and t_blk.num_residuals == j_blk.num_residuals
    assert t_blk.huber_delta == j_blk.huber_delta
    _same_bits(t_blk.slots.numpy(), np.asarray(j_blk.slots))
    _same_bits(t_blk.weight.numpy(), np.asarray(j_blk.weight))
    assert t_blk.data.keys() == j_blk.data.keys()
    for k, v in j_blk.data.items():
        _same_bits(t_blk.data[k].numpy(), np.asarray(v))


def _assert_params_equal(t_params, j_params):
    for f in FIELDS:
        _same_bits(getattr(t_params, f).numpy(), np.asarray(getattr(j_params, f)))


def test_lm_problem_equals_the_original(captured):
    jax_lines, port_lines = captured
    j, t = jax_lines["bench_lm"], port_lines["bench_lm"]
    _assert_params_equal(t["args"][0], j["args"][0])
    jc, tc = _closure(j["fn"]), _closure(t["fn"])
    assert tc["layout"].dim == jc["layout"].dim == 670 and tc["n_iter"] == jc["n_iter"] == 30
    for t_blk, j_blk in zip(tc["blocks"], (jc["blk"], jc["down"])):
        _assert_block_equal(t_blk, j_blk)
    _same_bits(tc["free"].numpy(), np.asarray(jc["free"]))


def test_counts(captured):
    """Operations: the original's formulas where the work is the same;
    bytes and the Hamming and extraction operations: the hand counts above,
    each input byte read once and each output byte written once."""
    jax_lines, port_lines = captured
    for line in ("bench_ransac", "bench_lm"):
        assert port_lines[line]["flops"] == jax_lines[line]["flops"], line
    # the original counts the padding of the 486 bits to 512
    assert jax_lines["bench_hamming"]["flops"] == 2 * N * N * 512
    assert port_lines["bench_hamming"]["flops"] == port_lines["bench_hamming_top2"]["flops"] == HAMMING_OPS
    assert port_lines["bench_extract"]["flops"] == EXTRACT_OPS
    # the original's banded Toeplitz count is about a hundred times the taps
    assert 95 < jax_lines["bench_extract"]["flops"] / EXTRACT_OPS < 115
    want = dict(bench_extract=EXTRACT_BYTES, bench_hamming=HAMMING_BYTES, bench_hamming_top2=TOP2_BYTES,
                bench_ransac=RANSAC_BYTES, bench_lm=LM_BYTES)
    assert {k: port_lines[k]["bytes"] for k in want} == want
    for line in LINES:
        assert port_lines[line]["label"] == jax_lines[line]["label"]


def test_output_byte_counts_equal_the_outputs():
    """The twin counts output bytes from shapes; at a small size they are
    the bytes of what each function returns."""
    dev = "cpu"
    imgs = TK.extract_inputs(1, 120, 160, device=dev)
    feats = TK.F.extract_features(imgs, max_features=64)
    assert TK._nbytes(feats) == 64 * TK.KEYPOINT_BYTES
    args = TK.ransac_inputs(128, device=dev)
    assert TK._nbytes(TK.R.ransac_homography_with_poses(*args, num_hypotheses=64)) == TK.ransac_output_bytes(128)
    d1, d2 = TK.hamming_inputs(64, device=dev)
    top2 = TK.Hm.hamming_top2_reference(d1[None], d2[None], torch.ones((1, 64), dtype=torch.bool))
    assert TK._nbytes(d1[None], d2[None], torch.ones((1, 64), dtype=torch.bool), top2) == TK.hamming_top2_bytes(1, 64, 64)


def _to64(x):
    return x.to(torch.float64) if torch.is_floating_point(x) else x


def _jax64(x):
    return x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x


def _cast_problem(j, t):
    """Both packages' problems with every float leaf in float64."""
    (jp, jb, jl, jf), (tp, tb, tl, tf) = j, t
    jp = dataclasses.replace(jp, **{f: _jax64(getattr(jp, f)) for f in FIELDS})
    tp = dataclasses.replace(tp, **{f: _to64(getattr(tp, f)) for f in FIELDS})
    jb = tuple(dataclasses.replace(b, weight=_jax64(b.weight), data={k: _jax64(v) for k, v in b.data.items()})
               for b in jb)
    tb = tuple(dataclasses.replace(b, weight=_to64(b.weight), data={k: _to64(v) for k, v in b.data.items()})
               for b in tb)
    return (jp, jb, jl, jf), (tp, tb, tl, tf)


@pytest.fixture(scope="module")
def mesh_problem():
    j = JLS.make_big_mesh_problem(*SMALL_PROBLEM)
    t = TLS.make_big_mesh_problem(*SMALL_PROBLEM, device="cpu")
    return j, t


def test_make_big_mesh_problem_equals_the_original(mesh_problem):
    (jp, jb, jl, jf), (tp, tb, tl, tf) = mesh_problem
    assert tl.dim == jl.dim == 3 * 12 + 64 + 8
    _assert_params_equal(tp, jp)
    assert [b.name for b in tb] == [b.name for b in jb] == ["plane_ray", "mesh_anchor", "downwards_prior"]
    for t_blk, j_blk in zip(tb, jb):
        _assert_block_equal(t_blk, j_blk)
    _same_bits(tf.numpy(), np.asarray(jf))


def _assert_solves_match(t_out, j_out, rel):
    (t_sol, t_info), (j_sol, j_info) = t_out, j_out
    assert int(t_info.iterations) == int(j_info.iterations)
    for f in ("quats", "mesh_z", "focal"):
        want = np.asarray(getattr(j_sol, f))
        diff = np.max(np.abs(getattr(t_sol, f).numpy() - want))
        assert diff <= rel * max(np.max(np.abs(want)), 1.0), (f, diff)
    want = float(j_info.final_cost)
    assert abs(float(t_info.final_cost) - want) <= rel * abs(want)


@pytest.mark.parametrize("dtype, solver, iterations", [
    ("float32", "cholesky", 1), ("float32", "cg", 1), ("float32", "cg", 2),
    ("float64", "cholesky", 1), ("float64", "cholesky", 2), ("float64", "cg", 1), ("float64", "cg", 2),
])
def test_lm_iterations_match_the_original(mesh_problem, dtype, solver, iterations):
    j, t = mesh_problem
    rel = FLOAT32_REL
    if dtype == "float64":
        j, t = _cast_problem(j, t)
        rel = FLOAT64_REL
    kw = dict(max_iterations=iterations, linear_solver=solver)
    _assert_solves_match(TLM.solve(*t, **kw), JLM.solve(*j, **kw), rel)


def test_reproject_matches_the_original():
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, [TFA.IMG_W, TFA.IMG_H], (200, 2))
    yaw = rng.uniform(-0.15, 0.15, 2)
    quats = [np.array([0.0, np.cos(y / 2), np.sin(y / 2), 0.0]) for y in yaw]  # nadir turned about z
    pos_a, pos_b = np.array([30.0, 30.0, 60.0]), np.array([42.0, 30.0, 85.0])
    got = TFA._reproject(xy, pos_a, quats[0], pos_b, quats[1])
    want = np.asarray(JFA._reproject(xy, pos_a, quats[0], pos_b, quats[1]))
    assert got.dtype == np.float64 and got.shape == (200, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=REPROJECT_PX)


def _fractions(rec):
    return [rec[k] for k in ("compute_fraction", "hbm_fraction", "roofline_share")]


def test_kernel_and_lm_twins_print_their_lines_on_the_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        TK.bench_extract(device="cpu", shape=(1, 120, 160), max_features=64)
        TK.bench_hamming(device="cpu", N=128)
        TK.bench_ransac(device="cpu", N=128, Hyp=64)
        TK.bench_lm(device="cpu", C=6, V=16, NB=32, n_iter=2)
        TK.bench_hamming_top2(device="cpu", N=128)
        solved = TLS.bench(6, 16, 32, iters=2, device="cpu")
    lines = out.getvalue().splitlines()
    recs = [json.loads(line) for line in lines[:5]]
    assert [r["peak"] for r in recs] == ["fp32"] * 4 + ["int8"]
    for r in recs:
        assert all(0 < x <= 1 for x in _fractions(r)), r
        assert r["bound_by"] in ("operations", "bytes") and r["time_ms"] > 0
    assert recs[4]["launches"] == 0 and recs[4]["function"] == "hamming.hamming_top2_reference"
    assert lines[5] == "C=6 V=16 NB=32 T=42"
    assert [line.split(":")[0].strip() for line in lines[6:]] == ["cholesky", "cg"]
    assert all(isinstance(solved[s], dict) and solved[s]["iterations"] == 2 for s in ("cholesky", "cg"))


def test_extract_profile_prints_its_table_on_the_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        rows = TEP.profile(1, device="cpu", height=96, width=128)
        TEP.table(rows, 1, device="cpu", height=96, width=128)
    table = out.getvalue().splitlines()[-7:]
    assert table[0] == "batch=1 96x128 on cpu"
    assert [line[:42].strip() for line in table[1:]] == [name for name, _ in rows]
    assert all(t > 0 for _, t in rows)


def test_twins_import_and_refuse_a_missing_card_without_jax_cv2_or_pil():
    """In a process where ``import jax``, ``import opencalibration_tpu``,
    ``import cv2`` and ``import PIL`` fail, the five twins import, and each
    twin's ``main`` without ``--device cpu`` raises where there is no card."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "opencalibration_tpu", "cv2", "PIL"):
            sys.modules[name] = None  # any import of it raises
        import torch
        from opencalibration_tpu_torch.bench import (bench_extract_profile, bench_fed_ab, bench_kernels,
                                                     bench_lm_solvers, bench_overlap_ab)
        refused = []
        for m in (bench_kernels, bench_lm_solvers, bench_extract_profile, bench_overlap_ab, bench_fed_ab):
            try:
                m.main([])
            except RuntimeError as e:
                refused.append("CUDA" in str(e))
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "opencalibration_tpu", "cv2", "PIL", "tests")
                        and sys.modules[m])
        print(torch.cuda.is_available(), refused, loaded)
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.split("\n")[-2] == "False [True, True, True, True, True] []"
