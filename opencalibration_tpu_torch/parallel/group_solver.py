"""Solve the relax groups of one stage (twin of
opencalibration_tpu/parallel/group_solver.py on one device).

Two paths:

* ``solve_groups``: groups that share nothing are solved one after another on
  the device, each in its own layout. The reference pads them to one layout
  and solves them in one vmapped dispatch; its padded slots are frozen and
  carry no residuals, so each group's answer does not depend on the padding.
  The choice between the dense and the matrix-free solver does depend on it:
  the reference routes by the padded batch layout, and so does the port
  (``batch_layout``).
* ``build_group_batch(shared_intrinsics=True)`` + ``solve_group_batch_shared``:
  groups that optimise the SAME camera models are padded to one layout,
  stacked along a leading group axis with their intrinsics aligned on one
  global model list, and solved as one joint problem. Each LM iteration
  assembles every group's normal equations, eliminates the group-local slots
  (rotations) by a Schur complement, sums the reduced systems over the
  groups, solves the shared tail (mesh heights and intrinsics) once, and
  back-substitutes. The reference spreads the groups over a device mesh and
  sums with ``psum``; on one device that sum is a plain sum over the leading
  axis.

Padding contract of a batch: camera, mesh-vertex, point and model slots
beyond a group's own count are frozen; block instances beyond a group's own
count carry weight 0 and slot 0; a group without a block family gets an
all-zero block of it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.relax import lm
from opencalibration_tpu_torch.relax.blocks import BlockSpec
from opencalibration_tpu_torch.relax.problem_builder import BuiltProblem, _bucket
from opencalibration_tpu_torch.relax.tangent import FIELDS, RelaxParams, TangentLayout
from opencalibration_tpu_torch.utils.device import full_fp32

DOWN_QUAT = (0.0, 1.0, 0.0, 0.0)

# a warm-started damping is clipped into this range: a converged solve
# leaves lambda at its floor, from which a moved problem would climb long
WARM_LAMBDA_RANGE = (1e-6, 1e2)

# tangent segments in layout order: (offset attribute, length)
_SEGMENTS = (
    ("rot_off", lambda l: 3 * l.C),
    ("mesh_off", lambda l: l.V),
    ("point_off", lambda l: 3 * l.P),
    ("focal_off", lambda l: l.M),
    ("principal_off", lambda l: 2 * l.M),
    ("radial_off", lambda l: 3 * l.M),
    ("tangential_off", lambda l: 2 * l.M),
)

# intrinsics segments: (offset attribute, slots per model)
_MODEL_SEGMENTS = (
    ("focal_off", 1),
    ("principal_off", 2),
    ("radial_off", 3),
    ("tangential_off", 2),
)

_INTRINSICS = ("focal", "principal", "radial", "tangential")


def batch_layout(builts: Sequence[BuiltProblem]) -> TangentLayout:
    """The reference's common padded layout of a stage's live groups:
    cameras bucketed to a power of two (at least 4), mesh heights and points
    bucketed when present, the most camera models of any group."""
    def bucketed(counts):
        return _bucket(max(counts), minimum=1) if any(counts) else 0

    return TangentLayout(
        _bucket(max(b.params.C for b in builts), minimum=4),
        bucketed([b.params.V for b in builts]),
        bucketed([b.params.P for b in builts]),
        max(b.params.M for b in builts),
    )


def solve_groups(
    builts: Sequence[BuiltProblem],
    pre_solve: bool,
    max_iterations: int = lm.DEFAULT_MAX_ITERATIONS,
    init_lambda: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[List[RelaxParams], List[lm.SolveInfo]]:
    """Solve every built problem: the surface-only pre-solve first when
    ``pre_solve``, then the full solve, both capped at ``max_iterations``.
    The full solve of group k starts from ``init_lambda[k]`` clipped into
    ``WARM_LAMBDA_RANGE`` (a previous pass's final damping), else from 1.
    Both take the linear solver the reference's batch layout routes to.
    Returns the solved parameters (host numpy) and the full solves' infos."""
    linear_solver = lm.route(batch_layout(builts).dim)
    solved, infos = [], []
    for k, b in enumerate(builts):
        params = b.params
        kw = dict(max_iterations=max_iterations, linear_solver=linear_solver)
        if pre_solve:
            params, _ = lm.solve(params, b.blocks, b.layout, b.surface_free_mask, **kw)
        lam0 = 1.0 if init_lambda is None else torch.clamp(init_lambda[k], *WARM_LAMBDA_RANGE)
        params, info = lm.solve(params, b.blocks, b.layout, b.free_mask, init_lambda=lam0, **kw)
        solved.append(RelaxParams(**interop.relax_params_to_numpy(params)))
        infos.append(info)
    return solved, infos


# ---------------------------------------------------------------------------
# The stacked batch of groups
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    return interop.to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _translate_slots(slots, old: TangentLayout, new: TangentLayout, model_perm=None) -> np.ndarray:
    """Map tangent slot indices from a group's own layout into the common
    padded layout: a shift per segment, the order within a segment kept. With
    ``model_perm`` an intrinsics slot of the group's model k moves to the
    global model ``model_perm[k]``."""
    s = _np(slots).astype(np.int64)
    old_offs = np.array([getattr(old, a) for a, _ in _SEGMENTS] + [old.dim])
    new_offs = np.array([getattr(new, a) for a, _ in _SEGMENTS])
    seg = np.clip(np.searchsorted(old_offs[1:], s, side="right"), 0, 6)
    out = new_offs[seg] + (s - old_offs[seg])
    if model_perm is not None and len(model_perm):
        perm = np.asarray(model_perm, np.int64)
        for seg_id, (attr, width) in enumerate(_MODEL_SEGMENTS, start=3):
            rel = s - old_offs[seg_id]
            k = np.clip(rel // width, 0, len(perm) - 1)
            out = np.where(seg == seg_id, getattr(new, attr) + perm[k] * width + rel % width, out)
    return out


def _translate_mask(mask, old: TangentLayout, new: TangentLayout, model_perm=None) -> np.ndarray:
    out = np.zeros(new.dim, bool)
    m = _np(mask)
    for attr, length in _SEGMENTS[:3]:
        ln = length(old)
        o, n = getattr(old, attr), getattr(new, attr)
        out[n : n + ln] = m[o : o + ln]
    for attr, width in _MODEL_SEGMENTS:
        o, n = getattr(old, attr), getattr(new, attr)
        for k in range(old.M):
            kk = k if model_perm is None else int(model_perm[k])
            out[n + kk * width : n + (kk + 1) * width] = m[o + k * width : o + (k + 1) * width]
    return out


def _pad_rows(t: torch.Tensor, target: int, fill=0) -> torch.Tensor:
    if t.shape[0] >= target:
        return t[:target]
    pad = torch.full((target - t.shape[0],) + tuple(t.shape[1:]), fill, dtype=t.dtype, device=t.device)
    return torch.cat([t, pad])


def _pad_params(p: RelaxParams, C: int, V: int, P: int, M: int) -> RelaxParams:
    """Pad every leaf to the common sizes. Padded quaternions are unit
    (nadir), so their retraction and normalisation stay finite."""
    down = torch.tensor(DOWN_QUAT, dtype=p.quats.dtype, device=p.quats.device)
    return RelaxParams(
        quats=torch.cat([p.quats, down.expand(C - p.quats.shape[0], 4)]),
        positions=_pad_rows(p.positions, C),
        mesh_z=_pad_rows(p.mesh_z, V),
        points=_pad_rows(p.points, P),
        focal=_pad_rows(p.focal, M, fill=1.0),
        principal=_pad_rows(p.principal, M),
        radial=_pad_rows(p.radial, M),
        tangential=_pad_rows(p.tangential, M),
    )


def _stack_params(padded: Sequence[RelaxParams]) -> RelaxParams:
    return RelaxParams(**{f: torch.stack([getattr(p, f) for p in padded]) for f in FIELDS})


@dataclasses.dataclass
class GroupBatch:
    """Stacked problems: the leaves of params, blocks and masks carry a
    leading group axis."""

    params: RelaxParams
    blocks: tuple  # of BlockSpec, leaves [G, ...]
    free: torch.Tensor  # [G, T]
    surface_free: torch.Tensor  # [G, T]
    layout: TangentLayout  # the common padded layout
    builts: List[BuiltProblem]
    num_groups: int
    shared_intrinsics: bool = False  # intrinsics aligned on one global model list
    # per group, its local -> global model slot permutation (shared batches),
    # kept so refresh_group_batch can translate the masks again
    model_perms: Optional[List[Optional[np.ndarray]]] = None
    # (lam_l [G], lam_s) left by the last solve; the next solve of the same
    # batch (a repeat pass on refreshed values) starts its trust region there
    warm_lambda: Optional[tuple] = None


def _stack_masks(builts, layout, perms, device):
    def stacked(name):
        return torch.as_tensor(
            np.stack([_translate_mask(getattr(b, name), b.layout, layout, perms[i]) for i, b in enumerate(builts)]),
            device=device,
        )

    return stacked("free_mask"), stacked("surface_free_mask")


def build_group_batch(builts: Sequence[BuiltProblem], shared_intrinsics: bool = False) -> GroupBatch:
    """Pad and stack built problems into one batch.

    With ``shared_intrinsics`` the groups' camera models are aligned on one
    global model list: every group's intrinsics leaves hold the same global
    values, intrinsics slots and ``model_i`` data move to the global
    positions, and each built's ``model_index`` and intrinsics leaves are
    rewritten IN PLACE to the global list, so that ``apply_solution`` and a
    later ``refresh_problem`` of the same built (a reused plan) address the
    global slots too."""
    if not builts:
        raise ValueError("no problems to batch")
    device = builts[0].params.quats.device
    layout0 = batch_layout(builts)
    C, V, P = layout0.C, layout0.V, layout0.P

    model_perms: List[Optional[np.ndarray]] = [None] * len(builts)
    if shared_intrinsics:
        global_mids = sorted({mid for b in builts for mid in b.model_index})
        global_slot = {mid: i for i, mid in enumerate(global_mids)}
        M = max(1, len(global_mids))
        # each model's values from the first group that carries it (they are
        # equal across groups: all come from the same model store)
        leaves = {"focal": np.ones(M), "principal": np.zeros((M, 2)),
                  "radial": np.zeros((M, 3)), "tangential": np.zeros((M, 2))}
        for mid in global_mids:
            b = next(b for b in builts if mid in b.model_index)
            for name in _INTRINSICS:
                leaves[name][global_slot[mid]] = _np(getattr(b.params, name))[b.model_index[mid]]
        padded = []
        for i, b in enumerate(builts):
            perm = np.zeros(max(1, b.params.M), np.int64)
            for mid, k in b.model_index.items():
                perm[k] = global_slot[mid]
            model_perms[i] = perm
            b.model_index = {mid: global_slot[mid] for mid in b.model_index}
            dt, dev = b.params.focal.dtype, b.params.focal.device
            b.params = dataclasses.replace(
                b.params, **{name: torch.as_tensor(leaves[name], device=dev).to(dt) for name in _INTRINSICS}
            )
            padded.append(_pad_params(b.params, C, V, P, M))
    else:
        M = layout0.M
        padded = [_pad_params(b.params, C, V, P, M) for b in builts]
    layout = TangentLayout(C, V, P, M)
    free, surface_free = _stack_masks(builts, layout, model_perms, device)

    # block families: the union over the groups, in first-seen order
    donors = {}
    for b in builts:
        for blk in b.blocks:
            donors.setdefault(blk.name, blk)

    stacked_blocks = []
    for name, donor in donors.items():
        group_blks = [next((blk for blk in b.blocks if blk.name == name), None) for b in builts]
        B_target = _bucket(max(blk.slots.shape[0] for blk in group_blks if blk is not None), minimum=16)
        L = donor.slots.shape[1]
        slots_g, weight_g, data_g = [], [], []
        for i, (b, blk) in enumerate(zip(builts, group_blks)):
            if blk is None:
                slots_g.append(torch.zeros((B_target, L), dtype=torch.int64, device=device))
                weight_g.append(torch.zeros(B_target, dtype=donor.weight.dtype, device=device))
                data_g.append({k: torch.zeros((B_target,) + tuple(v.shape[1:]), dtype=v.dtype, device=device)
                               for k, v in donor.data.items()})
                continue
            if set(blk.data) != set(donor.data):
                raise ValueError(f"mixed {name} block variants in one batch")
            slots = torch.as_tensor(_translate_slots(blk.slots, b.layout, layout, model_perms[i]), device=device)
            slots_g.append(_pad_rows(slots, B_target))
            weight_g.append(_pad_rows(blk.weight, B_target))
            d = {k: _pad_rows(v, B_target) for k, v in blk.data.items()}
            if model_perms[i] is not None and "model_i" in d:
                perm = torch.as_tensor(model_perms[i], device=device)
                d["model_i"] = perm[torch.clamp(d["model_i"], 0, len(perm) - 1)]
            data_g.append(d)
        stacked_blocks.append(dataclasses.replace(
            donor, slots=torch.stack(slots_g), weight=torch.stack(weight_g),
            data={k: torch.stack([d[k] for d in data_g]) for k in donor.data},
        ))

    return GroupBatch(
        params=_stack_params(padded), blocks=tuple(stacked_blocks), free=free, surface_free=surface_free,
        layout=layout, builts=list(builts), num_groups=len(builts),
        shared_intrinsics=shared_intrinsics, model_perms=model_perms,
    )


def _restack(blk: BlockSpec, builts, field, rows: int):
    """Group-stacked ``field`` ("weight" or a data key) of the family
    ``blk.name``, read again from the builts' own blocks and padded to
    ``rows``; zeros for a group without the family."""
    like = blk.weight if field == "weight" else blk.data[field]
    out = []
    for b in builts:
        own = next((x for x in b.blocks if x.name == blk.name), None)
        if own is None:
            out.append(torch.zeros((rows,) + tuple(like.shape[2:]), dtype=like.dtype, device=like.device))
        else:
            out.append(_pad_rows(own.weight if field == "weight" else own.data[field], rows))
    return torch.stack(out)


def refresh_group_batch(batch: GroupBatch) -> GroupBatch:
    """Stack again only what changes when the batch's builts had their values
    refreshed (``problem_builder.refresh_problem``): params, the free masks
    (the intrinsics tiers live there), the mesh-anchor targets, and the
    monotonicity prior's weight and ``r_max`` (its radial-tier switch). The
    stacked measurement blocks are structure and carry over."""
    layout, builts = batch.layout, batch.builts
    perms = batch.model_perms or [None] * len(builts)
    params = _stack_params([_pad_params(b.params, layout.C, layout.V, layout.P, layout.M) for b in builts])
    free, surface_free = _stack_masks(builts, layout, perms, batch.free.device)
    blocks = []
    for blk in batch.blocks:
        rows = blk.slots.shape[1]
        if blk.name == "mesh_anchor":
            blk = dataclasses.replace(blk, data=dict(blk.data, target=_restack(blk, builts, "target", rows)))
        elif blk.name == "monotonicity":
            blk = dataclasses.replace(blk, weight=_restack(blk, builts, "weight", rows),
                                      data=dict(blk.data, r_max=_restack(blk, builts, "r_max", rows)))
        blocks.append(blk)
    return dataclasses.replace(batch, params=params, free=free, surface_free=surface_free, blocks=tuple(blocks))


# ---------------------------------------------------------------------------
# The joint solve with a shared tangent tail
# ---------------------------------------------------------------------------


def _group(tree, g: int):
    """Group g's slice of a stacked RelaxParams or BlockSpec (views)."""
    if isinstance(tree, RelaxParams):
        return RelaxParams(**{f: getattr(tree, f)[g] for f in FIELDS})
    return dataclasses.replace(
        tree, slots=tree.slots[g], weight=tree.weight[g], data={k: v[g] for k, v in tree.data.items()}
    )


def _solve_shared(params, blocks, free, layout, max_iterations, n_local=None, init_lam_l=None,
                  init_lam_s=1.0, parameter_tolerance=1e-8, function_tolerance=1e-6):
    """Joint LM over all groups with the trailing tangent block SHARED.

    Slots below ``n_local`` are group-local (rotations, and points where
    present); slots from ``n_local`` on are one copy shared by every group.
    For mesh problems the caller shares [mesh heights, intrinsics]
    (``n_local = mesh_off``), which makes the joint solve the global
    calibration problem (one surface, one set of intrinsics, all cameras);
    with points in the layout only the intrinsics are shared.

    Every iteration each group assembles its damped normal equations and
    eliminates its local slots; the reduced systems are summed over the
    groups and solved once; the local steps back-substitute; the summed cost
    drives the accept test. Damping is split: each group's local block has
    its own lambda, adapted from that group's own cost change, and the
    shared system has one lambda on Nielsen's schedule, so one
    ill-conditioned group raises only its own damping.

    The groups' normal equations are assembled one group after another and
    stacked to [G, T, T]: ``lm.normal_equations`` is a Python loop over
    families and instance chunks around ``vmap(jacfwd)``, the group count is
    small, and the loop keeps each group's sums bit-identical to a solve of
    that group alone. The host reads one ``done`` flag per iteration.

    Returns (params [G-stacked], SolveInfo, lam_l [G])."""
    dtype, dev = params.quats.dtype, params.quats.device
    T = layout.dim
    if n_local is None:
        n_local = layout.focal_off
    n_shared = T - n_local
    G = free.shape[0]

    def scalar(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    lam_s = scalar(init_lam_s)
    lam_l = lam_s.expand(G).clone() if init_lam_l is None else torch.as_tensor(init_lam_l, device=dev).to(dtype)

    free_l = free[:, :n_local]  # [G, nl]
    # the shared tail is one set of unknowns: free where any group frees it
    free_s = free[:, n_local:].any(dim=0)  # [ns]
    free_join = torch.cat([free_l, free_s.expand(G, n_shared)], dim=1)
    frozen_l = (~free_l).to(dtype)
    frozen_s = (~free_s).to(dtype)
    group_blocks = [[_group(b, g) for b in blocks] for g in range(G)]

    def cost_per(p):
        return torch.stack([lm.total_cost(_group(p, g), group_blocks[g]) for g in range(G)])

    per = cost_per(params)
    cost0 = cost = torch.sum(per)
    p, nu_s = params, scalar(2.0)
    done = ~torch.isfinite(cost0)
    it = 0
    while it < max_iterations and not bool(done):  # one host sync per iteration
        Hg = [lm.normal_equations(_group(p, g), group_blocks[g], layout, free_join[g]) for g in range(G)]
        H = torch.stack([h for h, _ in Hg])  # [G, T, T]
        g_ = torch.stack([v for _, v in Hg])  # [G, T]
        diag = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), 1e-10, 1e32)

        H_ll = H[:, :n_local, :n_local] + torch.diag_embed(lam_l[:, None] * diag[:, :n_local] + frozen_l)
        H_ls = H[:, :n_local, n_local:]
        H_ss = H[:, n_local:, n_local:]
        g_l, g_s = g_[:, :n_local], g_[:, n_local:]

        # Jacobi-scaled block solves (see lm._jacobi_solve): the local blocks
        # mix units too, and float32 needs the scaling
        s_l = torch.rsqrt(torch.clamp(torch.diagonal(H_ll, dim1=-2, dim2=-1), 1e-24, 1e32))
        H_ll_s = H_ll * s_l[:, :, None] * s_l[:, None, :]
        rhs_l = torch.cat([H_ls, g_l[..., None]], dim=-1)
        X = s_l[:, :, None] * torch.linalg.solve_ex(H_ll_s, s_l[:, :, None] * rhs_l)[0]
        Hinv_Hls, Hinv_gl = X[..., :n_shared], X[..., n_shared]

        S = torch.sum(H_ss - torch.einsum("gls,glt->gst", H_ls, Hinv_Hls), dim=0)
        rhs = torch.sum(g_s - torch.einsum("gls,gl->gs", H_ls, Hinv_gl), dim=0)
        dss = torch.clamp(torch.sum(torch.diagonal(H_ss, dim1=-2, dim2=-1), dim=0), 1e-10, 1e32)
        S = S + torch.diag(lam_s * dss) + torch.diag(frozen_s)
        d_s = torch.where(free_s, -lm._jacobi_solve(S, rhs), 0.0)

        d_l = -(Hinv_gl + torch.einsum("gls,s->gl", Hinv_Hls, d_s))
        d_l = torch.where(free_l, d_l, 0.0)
        delta = torch.cat([d_l, d_s.expand(G, n_shared)], dim=1)
        p_new = _stack_params([layout.retract(_group(p, g), delta[g]) for g in range(G)])
        per_new = cost_per(p_new)
        new_cost = torch.sum(per_new)

        # gain ratio of the JOINT step: the predicted decrease of the
        # undamped Gauss-Newton model, summed over the groups
        pred_g = -(torch.einsum("gs,gs->g", g_, delta) + 0.5 * torch.einsum("gst,gs,gt->g", H, delta, delta))
        pred = torch.sum(pred_g)
        rho = (cost - new_cost) / torch.clamp_min(pred, 1e-30)
        accept = torch.isfinite(new_cost) & (new_cost < cost) & (pred > 0)

        p = p.where(accept, p_new)
        # each group's local damping follows its OWN gain ratio: a group that
        # got worse raises its lambda even when the joint step is accepted;
        # on a joint reject the groups that improved keep theirs
        rho_g = (per - per_new) / torch.clamp_min(pred_g, 1e-30)
        shrink_g = torch.clamp_min(1.0 - (2.0 * rho_g - 1.0) ** 3, 1.0 / 3.0)
        improved = torch.isfinite(per_new) & (per_new <= per) & (pred_g > 0)
        lam_l = torch.where(improved & accept, lam_l * shrink_g, torch.where(improved, lam_l, lam_l * 4.0))
        lam_l = torch.clamp(lam_l, 1e-12, 1e12)
        shrink_s = torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
        lam_s = torch.where(accept, torch.clamp(lam_s * shrink_s, 1e-12, 1e12), torch.clamp_max(lam_s * nu_s, 1e12))
        nu_s = torch.where(accept, scalar(2.0), torch.clamp_max(nu_s * 2.0, 1e6))

        step_small = torch.max(torch.abs(delta)) < parameter_tolerance
        cost_flat = accept & ((cost - new_cost) < function_tolerance * torch.clamp_min(cost, 1e-30))
        done = step_small | cost_flat | (lam_s > 1e10)
        per = torch.where(accept, per_new, per)
        cost = torch.where(accept, new_cost, cost)
        it += 1

    info = lm.SolveInfo(
        initial_cost=cost0, final_cost=cost, iterations=torch.tensor(it, dtype=torch.int32), final_lambda=lam_s
    )
    return p, info, lam_l


def solve_group_batch_shared(
    batch: GroupBatch, pre_solve: bool, max_iterations: int = lm.DEFAULT_MAX_ITERATIONS
) -> Tuple[RelaxParams, lm.SolveInfo]:
    """Joint solve of a batch built with ``shared_intrinsics=True``.

    For mesh problems the shared tail is [mesh heights, intrinsics]: every
    group carries a copy of the SAME surface, so sharing it gives the global
    calibration problem, where private meshes would let the focal drift
    along the focal / height valley. With points in the layout, or mesh
    copies that differ, only the intrinsics are shared. Returns the solved
    parameters ([G]-stacked tensors) and the joint solve's info; the exit
    dampings are kept on the batch for the next solve."""
    if not batch.shared_intrinsics:
        raise ValueError("solve_group_batch_shared needs a batch built with shared_intrinsics=True")
    layout, params, free = batch.layout, batch.params, batch.free
    G = batch.num_groups

    share_mesh = layout.V > 0 and layout.P == 0
    if share_mesh:
        mz = _np(params.mesh_z)
        share_mesh = bool(np.allclose(mz, mz[0:1], atol=1e-9, equal_nan=True))
    n_local = layout.mesh_off if share_mesh else layout.focal_off

    # instances that live wholly in the shared tail (mesh priors, radial
    # monotonicity) exist once per group copy: weighted 1/G, the joint
    # objective counts them once
    def downweight(b):
        all_shared = torch.all(b.slots >= n_local, dim=-1)
        return dataclasses.replace(b, weight=torch.where(all_shared, b.weight / G, b.weight))

    blocks = tuple(downweight(b) for b in batch.blocks)

    with full_fp32():
        if pre_solve and share_mesh:
            # the pre-solve moves the shared surface: solved jointly, so every
            # group's copy stays identical
            params, _, _ = _solve_shared(params, blocks, batch.surface_free, layout, max_iterations, n_local=n_local)
        elif pre_solve:
            # the surface slots are group-local: independent solves
            linear_solver = lm.route(layout.dim)
            params = _stack_params([
                lm.solve(_group(params, g), [_group(b, g) for b in blocks], layout, batch.surface_free[g],
                         max_iterations=max_iterations, linear_solver=linear_solver)[0]
                for g in range(G)
            ])
        lam_l0, lam_s0 = None, 1.0
        if batch.warm_lambda is not None and batch.warm_lambda[1] is not None:
            wl, ws = batch.warm_lambda
            lam_s0 = torch.clamp(ws, *WARM_LAMBDA_RANGE)
            if wl is not None:
                lam_l0 = torch.clamp(wl, *WARM_LAMBDA_RANGE)
        solved, info, lam_l = _solve_shared(
            params, blocks, free, layout, max_iterations, n_local=n_local, init_lam_l=lam_l0, init_lam_s=lam_s0
        )
    batch.warm_lambda = (lam_l, info.final_lambda)
    return solved, info


def fetch_solved(solved: RelaxParams) -> RelaxParams:
    """The whole solved batch on the host (numpy leaves)."""
    return RelaxParams(**interop.relax_params_to_numpy(solved))


def extract_group_params(batch: GroupBatch, solved: RelaxParams, g: int) -> RelaxParams:
    """Group g's solved parameters at its own (unpadded) sizes. In a
    shared-intrinsics batch the model slots are global, so the intrinsics
    leaves stay whole (the built's ``model_index`` addresses them). Pass
    ``solved`` through ``fetch_solved`` first: every leaf is then sliced on
    the host."""
    b = batch.builts[g]
    M = batch.layout.M if batch.shared_intrinsics else b.params.M
    sizes = dict(quats=b.params.C, positions=b.params.C, mesh_z=b.params.V, points=b.params.P,
                 focal=M, principal=M, radial=M, tangential=M)
    return RelaxParams(**{f: getattr(solved, f)[g][: sizes[f]] for f in FIELDS})
