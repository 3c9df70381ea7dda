"""The port's sharded bundle adjustment (opencalibration_tpu_torch/parallel/
sharded_ba.py over parallel/mesh.py) against the JAX package's, on the CPU.

The port's shards are ``"cpu"`` listed D times; the JAX side runs on D
devices of the 8-device virtual CPU mesh of tests/conftest.py.

Tolerances: the synthetic groups' parameters equal and their pixels within
1e-4 px (both project in float32, each package with its own kernels). One
sharded LM step from the same carried-across inputs at ``lam=1e-3`` within
``atol=2e-4, rtol=1e-5`` in float32, the bound of the JAX package's
tests/test_sharded_ba.py between its device counts (reduction-order noise on
O(100) coordinates); ``lm_step_single`` the same, and in float64 within 1e-9. ``run_sharded_ba`` on 8
shards: the cost falls 100x, the focal within 1 px of the truth and its
replicas bit-equal, the JAX test's bounds.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from opencalibration_tpu.parallel import sharded_ba as JS
from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.parallel import sharded_ba as TS
from opencalibration_tpu_torch.parallel.mesh import GroupMesh
from opencalibration_tpu_torch.relax.tangent import FIELDS, RelaxParams, TangentLayout
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEP_TOL = dict(atol=2e-4, rtol=1e-5)
PIXEL_TOL = 1e-4
LAM = 1e-3
G = 4


@functools.lru_cache(maxsize=None)
def _reference_groups(G):
    """The JAX package's synthetic groups (read only)."""
    return JS.make_synthetic_groups(G)


def _carried(G):
    """The JAX package's synthetic groups and the same inputs carried into
    the port: (JAX tuple, port params, template, pixels, free, layout)."""
    params, blk, pixels, free, layout = _reference_groups(G)
    t_layout = TangentLayout(layout.C, layout.V, layout.P, layout.M)
    return ((params, blk, pixels, free, layout), interop.relax_params_from(params, "cpu"),
            interop.block_from(blk, "cpu"), interop.to_torch(pixels, "cpu"),
            interop.to_torch(free, "cpu", torch.bool), t_layout)


def _jax_step(D, params, blk, pixels, free, layout):
    mesh = Mesh(np.asarray(jax.devices()[:D]), ("groups",))
    step = JS.make_sharded_lm_step(mesh, blk, free, layout, lam=LAM)
    sh = NamedSharding(mesh, P("groups"))
    out, _ = step(jax.tree.map(lambda x: jax.device_put(x, sh), params), jax.device_put(pixels, sh))
    return {f: np.asarray(getattr(out, f)) for f in FIELDS}


def _port_step(D, params, blk, pixels, free, layout):
    mesh = GroupMesh(["cpu"] * D)
    step = TS.make_sharded_lm_step(mesh, blk, free, layout, lam=LAM)
    parts, deltas = step(mesh.split(params), mesh.split(pixels))
    assert len(parts) == D and all(p.quats.shape[0] == G // D for p in parts)
    return {f: getattr(mesh.gather(parts), f).numpy() for f in FIELDS}, torch.cat(deltas)


def test_synthetic_groups_match_reference():
    j_params, j_blk, j_pixels, j_free, j_layout = _reference_groups(G)
    params, blk, pixels, free, layout = TS.make_synthetic_groups(G, device="cpu")
    assert (layout.C, layout.V, layout.P, layout.M) == (j_layout.C, j_layout.V, j_layout.P, j_layout.M)
    for f in FIELDS:
        got, want = getattr(params, f), np.asarray(getattr(j_params, f))
        assert got.dtype == torch.float32 and got.shape == want.shape, f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    np.testing.assert_allclose(pixels.numpy(), np.asarray(j_pixels), rtol=0, atol=PIXEL_TOL)
    np.testing.assert_array_equal(free.numpy(), np.asarray(j_free))
    np.testing.assert_array_equal(blk.slots.numpy(), np.asarray(j_blk.slots))
    assert blk.name == j_blk.name and blk.huber_delta == j_blk.huber_delta
    np.testing.assert_array_equal(TS._shared_slot_mask(layout, device="cpu").numpy(),
                                  np.asarray(JS._shared_slot_mask(j_layout)))


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_step_matches_reference(D):
    j, params, blk, pixels, free, layout = _carried(G)
    want = _jax_step(D, *j)
    got, delta = _port_step(D, params, blk, pixels, free, layout)
    for f in FIELDS:
        np.testing.assert_allclose(got[f], want[f], err_msg=f, **STEP_TOL)
    assert float(delta.abs().max()) > 1e-3  # the step moved the groups
    # the shared focal moved by one replicated step
    assert np.all(got["focal"] == got["focal"][0]) and got["focal"][0, 0] != np.asarray(j[0].focal)[0, 0]


def test_two_shards_match_one_shard():
    _, params, blk, pixels, free, layout = _carried(G)
    one, _ = _port_step(1, params, blk, pixels, free, layout)
    two, _ = _port_step(2, params, blk, pixels, free, layout)
    for f in FIELDS:
        np.testing.assert_allclose(two[f], one[f], err_msg=f, **STEP_TOL)


def _to64(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x, tree)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lm_step_single_matches_reference(dtype):
    """In float32 at ``lam=1e-3`` the params within the step's bound; in
    float64 at the reference entry's ``lam=1e-4`` params and step within 1e-9
    relative. (At 1e-4 the
    undamped float32 system is ill-conditioned: the two packages' focal steps
    part by 9e-5 relative, while in float64 they agree to 1e-10.)"""
    j_params, j_blk, j_pixels, j_free, j_layout = _reference_groups(G)
    lam, tol = (LAM, STEP_TOL) if dtype == "float32" else (1e-4, dict(rtol=1e-9, atol=1e-9))
    if dtype == "float64":
        j_params, j_pixels = _to64(j_params), _to64(j_pixels)
        j_blk = dataclasses.replace(j_blk, weight=_to64(j_blk.weight), data=_to64(j_blk.data))
    jp = jax.tree.map(lambda x: x[1], j_params)
    want, want_delta = jax.jit(lambda p, px, lam: JS.lm_step_single(p, j_blk, px, j_free, j_layout, lam))(
        jp, j_pixels[1], lam)
    params = interop.relax_params_from(j_params, "cpu")
    layout = TangentLayout(j_layout.C, j_layout.V, j_layout.P, j_layout.M)
    got, delta = TS.lm_step_single(RelaxParams(**{f: getattr(params, f)[1] for f in FIELDS}),
                                   interop.block_from(j_blk, "cpu"), interop.to_torch(j_pixels, "cpu")[1],
                                   interop.to_torch(j_free, "cpu", torch.bool), layout, lam)
    assert got.focal.dtype == getattr(torch, dtype)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f, **tol)
    if dtype == "float64":  # in float32 the params are held, as the reference's test holds them
        np.testing.assert_allclose(delta.numpy(), np.asarray(want_delta), **tol)


def test_sharded_ba_converges_and_recovers_shared_focal():
    mesh, p0, pf, cost = TS.run_sharded_ba(8, groups_per_device=1, iterations=8, devices=["cpu"] * 8)
    assert len(mesh) == 8 and pf.quats.shape[0] == 8
    c0, cf = float(cost(p0)), float(cost(pf))
    assert cf < c0 * 1e-2, (c0, cf)
    focal = pf.focal.numpy()
    np.testing.assert_allclose(focal, 600.0, atol=1.0)  # from 612
    assert np.all(focal == focal[0])  # replicas agree bitwise (psum-reduced shared system)


_STANDALONE = """
import sys
for name in ("jax", "jaxlib", "opencalibration_tpu"):
    sys.modules[name] = None  # any import of it raises
import torch
torch.set_num_threads(1)
from opencalibration_tpu_torch.parallel import dryrun, sharded_ba
dryrun.dryrun_multidevice(["cpu", "cpu"])
fn, args = dryrun.entry("cpu")
assert all(bool(torch.isfinite(x).all()) for x in fn(*args))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "opencalibration_tpu") and sys.modules[m])
print(loaded)
sys.exit(1 if loaded else 0)
"""


def test_multi_device_modules_need_no_jax():
    """``sharded_ba`` and ``dryrun`` import and run with jax and the JAX
    package made unimportable."""
    r = subprocess.run([sys.executable, "-c", _STANDALONE], capture_output=True, text=True, timeout=300,
                       cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
