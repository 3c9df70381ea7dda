"""Entry points of the multi-device paths (twin of the functions of the
repository's ``__graft_entry__.py``).

``entry(device)`` returns (fn, args): one Gauss-Newton step of one synthetic
bundle-adjustment group (normal equations, dense solve, manifold
retraction). ``dryrun_multidevice(devices)`` runs the production group
solvers, the ones ``RelaxStage`` calls, over the given shards on tiny
problems and checks their results. The caller names the devices; a device
may repeat, and nothing falls back to another device.
"""

from __future__ import annotations

import numpy as np
import torch

from opencalibration_tpu_torch.parallel.group_solver import (
    build_group_batch,
    fetch_solved,
    solve_group_batch,
    solve_group_batch_shared,
)
from opencalibration_tpu_torch.parallel.mesh import map_tree
from opencalibration_tpu_torch.parallel.sharded_ba import lm_step_single, make_synthetic_groups
from opencalibration_tpu_torch.relax.blocks import downwards_prior_block, mesh_anchor_block, plane_ray_block
from opencalibration_tpu_torch.relax.problem_builder import BuiltProblem
from opencalibration_tpu_torch.relax.tangent import RelaxParams, TangentLayout
from opencalibration_tpu_torch.utils.device import resolve_device


def entry(device="cuda"):
    """(fn, args): ``fn(*args)`` takes one ``lm_step_single`` of one
    synthetic group on ``device`` and returns (quats, points, focal, delta)."""
    params, block_template, pixels, free, layout = make_synthetic_groups(G=1, device=device)
    params_g = map_tree(lambda x: x[0], params)
    lam = torch.tensor(1e-4, dtype=torch.float32, device=pixels.device)

    def fn(params_g, pixels_g, lam):
        new_params, delta = lm_step_single(params_g, block_template, pixels_g, free, layout, lam)
        return new_params.quats, new_params.points, new_params.focal, delta

    return fn, (params_g, pixels[0], lam)


def make_tiny_built_problem(g: int, dtype=torch.float32, device="cuda") -> BuiltProblem:
    """One tiny ground-mesh problem of the structure ``RelaxStage`` hands to
    the group solvers: 3 cameras, a 4-vertex / 2-triangle mesh and one
    camera model (id 42) that are the same in every group, plane-ray track
    costs, mesh anchors and downwards priors. The pixels are group g's
    seeded draw."""
    dev = resolve_device(device)
    C, V, M = 3, 4, 1
    layout = TangentLayout(C=C, V=V, P=0, M=M)
    rng = np.random.default_rng(1234 + g)

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device=dev).to(dt)

    positions = np.stack([np.array([5.0 * i + 20.0 * g, 3.0 * i, 30.0]) for i in range(C)])
    params = RelaxParams(
        quats=t(np.tile([0.0, 1.0, 0.0, 0.0], (C, 1))), positions=t(positions), mesh_z=t(np.zeros(V)),
        points=t(np.zeros((0, 3))), focal=t(np.full(M, 600.0)), principal=t(np.tile([[400.0, 300.0]], (M, 1))),
        radial=t(np.zeros((M, 3))), tangential=t(np.zeros((M, 2))),
    )
    # two triangles over the grid every group shares, so the joint solver
    # shares [mesh heights | intrinsics] across the shards
    tri_verts = np.array([[0, 1, 2], [1, 3, 2]])
    grid_xy = np.array([[0.0, 0.0], [40.0, 0.0], [0.0, 40.0], [40.0, 40.0]])
    nb = 4
    vert_idx = np.tile(tri_verts, (2, 1))[:nb]
    cam_idx = np.zeros((nb, 5), np.int64)
    cam_idx[:, 0] = np.arange(nb) % C
    cam_idx[:, 1] = (np.arange(nb) + 1) % C
    ray_valid = np.zeros((nb, 5), bool)
    ray_valid[:, :2] = True
    pixel = np.array([400.0, 300.0]) + rng.normal(0, 40.0, size=(nb, 5, 2))
    i64 = torch.int64
    blocks = [
        plane_ray_block(layout, t(vert_idx, i64), t(grid_xy[vert_idx]), t(cam_idx, i64), t(ray_valid, torch.bool),
                        t(np.ones(nb)), model_i=t(np.zeros(nb), i64), pixel=t(pixel)),
        mesh_anchor_block(layout, t(np.arange(V), i64), t(np.zeros(V)), t(np.ones(V))),
        downwards_prior_block(layout, t(np.arange(C), i64), t(np.ones(C))),
    ]
    free = layout.build_free_mask(mesh_free=True, focal_free=True, radial_tiers=1, device=dev)
    surface_free = layout.build_free_mask(rot_free=np.zeros(C, bool), mesh_free=True, device=dev)
    return BuiltProblem(
        params=params, layout=layout, blocks=blocks, free_mask=free, surface_free_mask=surface_free,
        cam_index={100 + i: i for i in range(C)},
        model_index={42: 0},  # the SAME model id in every group: one shared slot
        mesh=None, inverse_models=True, track_points=np.zeros((0, 3)), track_errors=np.zeros(0),
        kind="mesh", num_opt=C, v_real=V,
    )


def dryrun_multidevice(devices) -> None:
    """Run the production group solvers over the shards ``devices``, one tiny
    group a shard, and check them. First the joint solver
    (``solve_group_batch_shared``: the shared [mesh heights | intrinsics]
    tail coupled across the shards by the distributed Schur complement),
    with the surface pre-solve: poses finite, focal and mesh equal across
    the shards' groups, at least one iteration. Then the independent lanes
    (``solve_group_batch``, as INITIAL_PROCESSING and FINAL_GLOBAL_RELAX
    use it): poses finite. Raises on a failed check."""
    devices = list(devices)
    G = len(devices)
    dev = devices[0]
    batch = build_group_batch([make_tiny_built_problem(g, device=dev) for g in range(G)], shared_intrinsics=True)
    solved, info = solve_group_batch_shared(batch, pre_solve=True, max_iterations=8, devices=devices)
    solved = fetch_solved(solved)
    if not np.isfinite(solved.quats).all():
        raise AssertionError("non-finite poses")
    focal = np.asarray(solved.focal)  # [G, M], shared across the groups
    if not np.allclose(focal, focal[0:1]):
        raise AssertionError("the shared intrinsics diverged across the shards")
    if not np.allclose(solved.mesh_z, solved.mesh_z[0:1], atol=1e-5):
        raise AssertionError("the shared mesh diverged across the shards")
    if int(info.iterations) < 1:
        raise AssertionError("the joint solver did not iterate")

    batch2 = build_group_batch([make_tiny_built_problem(g, device=dev) for g in range(G)])
    solved2, _ = solve_group_batch(batch2, pre_solve=False, max_iterations=4, devices=devices)
    if not np.isfinite(fetch_solved(solved2).quats).all():
        raise AssertionError("non-finite poses in the independent-lane solve")
