"""Sharded bundle adjustment over several devices (twin of
opencalibration_tpu/parallel/sharded_ba.py).

The survey's camera graph is split into bounded groups; each group's bundle
adjustment is an independent dense problem, except for the camera
intrinsics, which every group of one physical camera shares.

Mapping to the shards of a ``GroupMesh`` (``parallel/mesh.py``):

* the groups are data-parallel over the shards (a leading G axis cut into
  contiguous ranges, one a device), as the reference lays them over its
  ``"groups"`` mesh axis;
* the shared intrinsics are solved exactly by a distributed Schur
  complement: each shard reduces its groups' (H_ss - H_sl H_ll^-1 H_ls,
  g_s - H_sl H_ll^-1 g_l) contributions, one ``psum`` over the shards forms
  the reduced intrinsics system, every shard solves that small replicated
  system and back-substitutes its own groups' camera and point updates.

``parallel/dryrun.py`` drives it, and the tests run it on shards that share
the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opencalibration_tpu_torch.ops.distort import image_from_3d_world
from opencalibration_tpu_torch.ops.quaternion import quat_from_axis_angle, quat_multiply
from opencalibration_tpu_torch.parallel.mesh import GroupMesh, canonical_device, map_tree
from opencalibration_tpu_torch.relax import blocks as B
from opencalibration_tpu_torch.relax import lm
from opencalibration_tpu_torch.relax.tangent import FIELDS, RelaxParams, TangentLayout
from opencalibration_tpu_torch.types.camera import CameraModel
from opencalibration_tpu_torch.utils.device import full_fp32

F32 = torch.float32


def make_group_layout(C: int, P_pts: int) -> TangentLayout:
    """Per-group tangent: C rotations + P points + 1 shared camera model."""
    return TangentLayout(C, 0, P_pts, 1)


def _f64(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def make_synthetic_groups(G: int, C: int = 4, P_pts: int = 16, focal: float = 600.0, seed: int = 0, *,
                          device="cuda"):
    """G small synthetic BA groups sharing one camera model: per group, C
    nadir cameras over a point grid, pixels from the forward model,
    orientations perturbed. The reference's numpy draws in its order; the
    quaternions in float64 on the host, the pixels projected in float32 on
    ``device``. Returns (params [G-batched], pixel block template, pixels
    [G, C * P_pts, 2], free mask, layout), float32 on ``device``."""
    dev = canonical_device(device)
    rng = np.random.default_rng(seed)
    layout = make_group_layout(C, P_pts)
    down = _f64([0.0, 1.0, 0.0, 0.0])
    z_axis = _f64([0.0, 0.0, 1.0])
    model = CameraModel.create(focal, (400.0, 300.0), pixels_cols=800, pixels_rows=600, dtype=F32, device=dev)

    quats_all, pos_all, pts_all, pix_all = [], [], [], []
    for g in range(G):
        offs = np.array([g * 100.0, 0.0, 0.0])
        # varied altitudes make the shared focal strongly observable
        positions = np.array([[9, 9, 9], [11, 9, 14], [11, 11, 20], [9, 11, 27]], np.float64)[:C] + offs
        quats = [quat_multiply(quat_from_axis_angle(z_axis, rng.uniform(-0.2, 0.2)), down) for _ in range(C)]
        side = int(np.ceil(np.sqrt(P_pts)))
        gx, gy = np.meshgrid(np.arange(side), np.arange(side))
        pts = np.stack(
            [5 + gx.ravel()[:P_pts], 5 + gy.ravel()[:P_pts], ((gx + gy) % 2).ravel()[:P_pts] * 1.0 - 10],
            axis=1,
        ).astype(np.float64) + offs
        pts_dev = torch.as_tensor(pts, dtype=F32, device=dev)
        pix = torch.stack([
            image_from_3d_world(pts_dev, model, torch.as_tensor(positions[i], dtype=F32, device=dev),
                                quats[i].to(device=dev, dtype=F32))
            for i in range(C)
        ])
        # perturbed initial state
        noisy = [quat_multiply(q, quat_from_axis_angle(_f64(rng.normal(size=3)), 0.02)) for q in quats]
        quats_all.append(torch.stack(noisy))
        pos_all.append(positions)
        pts_all.append(pts + rng.normal(0, 0.05, pts.shape))
        pix_all.append(pix.reshape(C * P_pts, 2))

    def f32(x):
        return torch.as_tensor(x, device=dev).to(F32)

    params = RelaxParams(
        quats=torch.stack([f32(q) for q in quats_all]),
        positions=torch.stack([f32(p) for p in pos_all]),
        mesh_z=torch.zeros((G, 0), dtype=F32, device=dev),
        points=torch.stack([f32(p) for p in pts_all]),
        focal=torch.full((G, 1), focal * 1.02, dtype=F32, device=dev),  # shared, 2 % off
        principal=f32([[400.0, 300.0]]).expand(G, 1, 2).clone(),
        radial=torch.zeros((G, 1, 3), dtype=F32, device=dev),
        tangential=torch.zeros((G, 1, 2), dtype=F32, device=dev),
    )
    cam_i = torch.repeat_interleave(torch.arange(C, device=dev), P_pts)
    point_i = torch.arange(P_pts, device=dev).repeat(C)
    model_i = torch.zeros(C * P_pts, dtype=torch.int64, device=dev)
    pixels = torch.stack(pix_all)
    free = layout.build_free_mask(points_free=True, focal_free=True, device=dev)
    block_template = B.pixel_error_block(layout, cam_i, point_i, model_i, pixels[0],
                                         torch.ones(C * P_pts, dtype=F32, device=dev))
    return params, block_template, pixels, free, layout


def _shared_slot_mask(layout: TangentLayout, *, device) -> torch.Tensor:
    """Tangent entries shared across groups (the intrinsics tail)."""
    m = torch.zeros(layout.dim, dtype=torch.bool, device=device)
    m[layout.focal_off:] = True
    return m


def _with_pixels(block_template: B.BlockSpec, pixels_g) -> B.BlockSpec:
    return dataclasses.replace(block_template, data=dict(block_template.data, pixel=pixels_g))


def lm_step_single(params_g, block_template, pixels_g, free, layout, lam):
    """One damped Gauss-Newton step of one group (no sharing), the reference
    the sharded step is tested against. Returns (params, delta)."""
    with full_fp32():
        H, g = lm.normal_equations(params_g, [_with_pixels(block_template, pixels_g)], layout, free)
        A = H + lam * torch.diag(torch.clamp(torch.diagonal(H), 1e-8, 1e30)) + torch.diag((~free).to(H.dtype))
        delta = torch.where(free, -torch.linalg.solve(A, g), 0.0)
        return layout.retract(params_g, delta), delta


def _group_params(params, g: int) -> RelaxParams:
    return map_tree(lambda x: x[g], params)


def make_sharded_lm_step(mesh: GroupMesh, block_template, free, layout, lam=1e-7):
    """The one-iteration LM step over the shards of ``mesh``.

    Exact distributed Schur complement over the shared intrinsics slots:
      per group:  [H_ll  H_ls] [d_l]   [g_l]
                  [H_sl  H_ss] [d_s] = [g_s]
      S   = psum_g (H_ss - H_sl H_ll^-1 H_ls)
      rhs = psum_g (g_s  - H_sl H_ll^-1 g_l)
      d_s = -S^-1 rhs   (replicated), then per group
      d_l = -H_ll^-1 (g_l + H_ls d_s)

    Returns ``step(params_parts, pixels_parts) -> (params_parts,
    delta_parts)``: one part a shard, as ``mesh.split`` cuts the [G, ...]
    params and pixels."""
    shared = _shared_slot_mask(layout, device="cpu")
    local_idx = torch.nonzero(~shared).reshape(-1)
    shared_idx = torch.nonzero(shared).reshape(-1)
    n_shared = shared_idx.shape[0]
    # the template, mask and slot lists on every shard's device
    on = [dict(tpl=map_tree(lambda x, d=d: x.to(d), block_template), free=free.to(d),
               local=local_idx.to(d), shared=shared_idx.to(d)) for d in mesh.devices]

    def reduce(k, params, pixels):
        """Shard k's groups' damped systems, their local solves and the
        shard's share of the reduced shared system."""
        c = on[k]
        loc, sh, fr = c["local"], c["shared"], c["free"]
        Hg = [lm.normal_equations(_group_params(params, g), [_with_pixels(c["tpl"], pixels[g])], layout, fr)
              for g in range(pixels.shape[0])]
        H = torch.stack([h for h, _ in Hg])
        g_ = torch.stack([v for _, v in Hg])
        damp = lam * torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), 1e-8, 1e30)
        Hd = H + torch.diag_embed(damp)
        H_ll = Hd[:, loc[:, None], loc[None, :]] + torch.diag((~fr[loc]).to(H.dtype))
        H_ls = Hd[:, loc[:, None], sh[None, :]]
        H_ss = Hd[:, sh[:, None], sh[None, :]]
        g_l, g_s = g_[:, loc], g_[:, sh]
        # one factorisation of the local blocks for both right-hand sides
        X = torch.linalg.solve(H_ll, torch.cat([H_ls, g_l[..., None]], dim=-1))
        S_local = torch.sum(H_ss - torch.einsum("gls,glt->gst", H_ls, X[..., :n_shared]), dim=0)
        rhs_local = torch.sum(g_s - torch.einsum("gls,gl->gs", H_ls, X[..., n_shared]), dim=0)
        return (H_ll, H_ls, g_l), S_local, rhs_local

    def finish(k, params, local, S, rhs):
        """Shard k: the replicated shared solve, then its groups' steps."""
        c = on[k]
        loc, sh, fr = c["local"], c["shared"], c["free"]
        H_ll, H_ls, g_l = local
        S = S + torch.diag((~fr[sh]).to(S.dtype))
        d_s = torch.where(fr[sh], -torch.linalg.solve(S, rhs), 0.0)
        d_l = -torch.einsum("gab,gb->ga", torch.linalg.inv(H_ll), g_l + torch.einsum("gls,s->gl", H_ls, d_s))
        d_l = torch.where(fr[loc][None], d_l, 0.0)
        Gk = H_ll.shape[0]
        delta = torch.zeros((Gk, layout.dim), dtype=S.dtype, device=S.device)
        delta[:, loc] = d_l
        delta[:, sh] = d_s.expand(Gk, n_shared)
        new = [layout.retract(_group_params(params, g), delta[g]) for g in range(Gk)]
        return RelaxParams(**{f: torch.stack([getattr(p, f) for p in new]) for f in FIELDS}), delta

    def step(params_parts, pixels_parts):
        with full_fp32():
            reduced = [reduce(k, p, px) for k, (p, px) in enumerate(zip(params_parts, pixels_parts))]
            S = mesh.psum([r[1] for r in reduced])
            rhs = mesh.psum([r[2] for r in reduced])
            out = [finish(k, p, r[0], S[k], rhs[k]) for k, (p, r) in enumerate(zip(params_parts, reduced))]
        return [o[0] for o in out], [o[1] for o in out]

    return step


def run_sharded_ba(n_devices: int, groups_per_device: int = 1, iterations: int = 5, devices=None):
    """Synthetic groups on ``n_devices`` shards (``devices``, by default the
    first ``n_devices`` cards; a device may repeat), ``iterations`` sharded
    LM steps. Returns (mesh, initial params, final params, cost function),
    the params [G]-stacked on shard 0's device."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(n_devices)]
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices for {n_devices} shards")
    mesh = GroupMesh(devices)
    G = n_devices * groups_per_device
    params, block_template, pixels, free, layout = make_synthetic_groups(G, device=mesh.devices[0])
    step = make_sharded_lm_step(mesh, block_template, free, layout)

    def cost(params_all):
        """The summed pixel cost of every group ([G]-stacked params)."""
        return sum(lm.block_cost(_group_params(params_all, g), _with_pixels(block_template, pixels[g]))
                   for g in range(G))

    parts, pixel_parts = mesh.split(params), mesh.split(pixels)
    for _ in range(iterations):
        parts, _ = step(parts, pixel_parts)
    return mesh, params, mesh.gather(parts), cost
