"""Solve the relax groups of one stage (twin of
opencalibration_tpu/parallel/group_solver.py).

Three paths:

* ``build_group_batch`` + ``solve_group_batch``: groups that share nothing are
  padded to one layout, stacked along a leading group axis and solved in one
  LM over that axis (``lm.solve_batch``, one lane a group), as the reference
  solves them in one vmapped dispatch. On one device the group count is
  bucketed to a power of two with fully frozen copies of group 0, which stop
  after one iteration. The padded slots are frozen and carry no residuals, so
  each group's answer does not depend on the padding; the choice between the
  dense and the matrix-free solver does: it follows the padded batch layout
  (``batch_layout``).
* ``solve_groups``: the same groups solved one after another, each in its own
  layout, routed by the batch layout too (the stage's
  ``use_batched_solver=False``).
* ``build_group_batch(shared_intrinsics=True)`` + ``solve_group_batch_shared``:
  groups that optimise the SAME camera models are padded to one layout,
  stacked along a leading group axis with their intrinsics aligned on one
  global model list, and solved as one joint problem. Each LM iteration
  assembles every group's normal equations, eliminates the group-local slots
  (rotations) by a Schur complement, sums the reduced systems over the
  groups, solves the shared tail (mesh heights and intrinsics) once, and
  back-substitutes.

Both batched solvers take ``devices``: the groups are cut into contiguous
shards, one a device (``parallel/mesh.py``; a device may repeat), as the
reference lays them over its ``"groups"`` mesh axis. Independent lanes run
shard by shard in lockstep; the joint solve sums its reduced systems, costs
and predicted decreases across the shards (the reference's ``psum``).

Padding contract of a batch: camera, mesh-vertex, point and model slots
beyond a group's own count are frozen; block instances beyond a group's own
count carry weight 0 and slot 0; a group without a block family gets an
all-zero block of it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.parallel.mesh import GroupMesh, map_tree
from opencalibration_tpu_torch.relax import lm
from opencalibration_tpu_torch.relax.blocks import BlockSpec
from opencalibration_tpu_torch.relax.problem_builder import BuiltProblem, _bucket
from opencalibration_tpu_torch.relax.tangent import FIELDS, RelaxParams, TangentLayout
from opencalibration_tpu_torch.utils.device import full_fp32
from opencalibration_tpu_torch.utils.performance import PerformanceMeasure, add_event_count

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


def _restack(blk: BlockSpec, builts, key, rows: int):
    """Group-stacked data ``key`` of the family ``blk.name``, read again from
    the builts' own blocks and padded to ``rows``; zeros for a group without
    the family."""
    like = blk.data[key]
    out = []
    for b in builts:
        own = next((x for x in b.blocks if x.name == blk.name), None)
        if own is None:
            out.append(torch.zeros((rows,) + tuple(like.shape[2:]), dtype=like.dtype, device=like.device))
        else:
            out.append(_pad_rows(own.data[key], rows))
    return torch.stack(out)


def refresh_group_batch(batch: GroupBatch) -> GroupBatch:
    """Stack again only what changes when the batch's builts had their values
    refreshed (``problem_builder.refresh_problem``): params, the free masks
    (the intrinsics tiers live there) and the mesh-anchor targets. Every
    other block carries over, as in the reference: the monotonicity prior
    keeps the weight and ``r_max`` of the batch's first build."""
    layout, builts = batch.layout, batch.builts
    perms = batch.model_perms or [None] * len(builts)
    params = _stack_params([_pad_params(b.params, layout.C, layout.V, layout.P, layout.M) for b in builts])
    free, surface_free = _stack_masks(builts, layout, perms, batch.free.device)
    blocks = []
    for blk in batch.blocks:
        rows = blk.slots.shape[1]
        if blk.name == "mesh_anchor":
            blk = dataclasses.replace(blk, data=dict(blk.data, target=_restack(blk, builts, "target", rows)))
        blocks.append(blk)
    return dataclasses.replace(batch, params=params, free=free, surface_free=surface_free, blocks=tuple(blocks))


# ---------------------------------------------------------------------------
# All groups in one solve
# ---------------------------------------------------------------------------

# groups per solve at most (a power of two is taken below it); unset or 0: all
# groups in one. Each lane holds its own normal equations, so this bounds the
# device memory of a survey with many groups; the reference reads the same
# variable
MAX_GROUPS_ENV = "OC_TPU_MAX_GROUPS_PER_DISPATCH"


def num_lanes(num_groups: int, num_devices: int = 1, shared: bool = False) -> int:
    """The lanes ``solve_group_batch`` solves ``num_groups`` groups in: on one
    device the count bucketed to a power of two, on D > 1 devices padded to a
    multiple of D. With ``shared``, those of ``solve_group_batch_shared``:
    never bucketed, padded to a multiple of the ``min(D, G)`` shards it
    spreads the groups over."""
    if shared:
        num_devices = min(num_devices, num_groups)
    elif num_devices == 1:
        return _bucket(num_groups, minimum=1)
    return num_groups + (-num_groups) % num_devices


def pad_lanes(batch: GroupBatch, lanes: int) -> GroupBatch:
    """The batch with ``lanes - num_groups`` copies of group 0 appended, every
    slot of a copy frozen: a frozen lane's step is exactly 0, so it stops
    after one iteration and never holds the loop open."""
    pad = lanes - batch.num_groups
    if pad <= 0:
        return batch

    def dup(x):
        return torch.cat([x] + [x[:1]] * pad)

    frozen = torch.zeros((pad, batch.layout.dim), dtype=torch.bool, device=batch.free.device)
    return dataclasses.replace(
        batch, params=map_tree(dup, batch.params), blocks=map_tree(dup, batch.blocks),
        free=torch.cat([batch.free, frozen]), surface_free=torch.cat([batch.surface_free, frozen]),
    )


def _lanes(tree, lo: int, hi: int):
    """Lanes [lo, hi) of a stacked RelaxParams or BlockSpec (views)."""
    return map_tree(lambda x: x[lo:hi], tree)


def _solve_batch(params, blocks, free, surface_free, layout, pre_solve, max_iterations, init_lambda):
    """The surface-only pre-solve of every lane when ``pre_solve``, then the
    full solve of every lane from ``init_lambda`` [G]. A single lane runs
    ``lm.solve``, the same LM without the lane axis: 2,076 launches an
    iteration on the card against 2,151 for one lane of ``lm.solve_batch``
    (``tools/torch_lm_profile.py``, PERF.md)."""
    if free.shape[0] == 1:
        p, blks = _group(params, 0), [_group(b, 0) for b in blocks]
        if pre_solve:
            p, _ = lm.solve(p, blks, layout, surface_free[0], max_iterations=max_iterations)
        p, info = lm.solve(p, blks, layout, free[0], max_iterations=max_iterations, init_lambda=init_lambda[0])
        lane = {k.name: torch.as_tensor(getattr(info, k.name), device=free.device)[None]
                for k in dataclasses.fields(lm.SolveInfo)}
        return RelaxParams(**{f: getattr(p, f)[None] for f in FIELDS}), lm.SolveInfo(**lane)
    if pre_solve:
        params, _ = lm.solve_batch(params, blocks, layout, surface_free, max_iterations=max_iterations)
    return lm.solve_batch(params, blocks, layout, free, max_iterations=max_iterations, init_lambda=init_lambda)


def _lane_shards(mesh: GroupMesh, padded: GroupBatch, lam0: torch.Tensor) -> list:
    """Per shard (params, blocks, free, surface_free, lam0), the lanes cut
    into the mesh's contiguous ranges; one shard on the batch's own device
    takes the batch's tensors as they are."""
    args = (padded.params, padded.blocks, padded.free, padded.surface_free, lam0)
    if len(mesh) == 1 and mesh.devices[0] == padded.free.device:
        return [args]
    return list(zip(*[mesh.split(a) for a in args]))


def solve_group_batch(
    batch: GroupBatch,
    pre_solve: bool,
    max_iterations: int = lm.DEFAULT_MAX_ITERATIONS,
    devices=None,
    init_lambda=None,
) -> Tuple[RelaxParams, lm.SolveInfo]:
    """Solve every group of a batch built with ``shared_intrinsics=False`` in
    one LM over the group axis. Each group's full solve starts from
    ``init_lambda`` [G], else from the batch's ``warm_lambda`` (the last
    solve's final damping), clipped into ``WARM_LAMBDA_RANGE``, else from 1.
    Returns (solved params [G-stacked] on the batch's device, SolveInfo with
    [G] leaves); the final dampings are kept on the batch.

    ``devices`` lists the shards the lanes are spread over (a device may
    repeat); by default the batch's own device. On one device the group
    count is bucketed to a power of two by frozen copies of group 0, and with
    ``OC_TPU_MAX_GROUPS_PER_DISPATCH`` set the lanes are solved in chunks of
    the largest power of two not above it. On D > 1 devices the groups are
    padded to a multiple of D by frozen copies of group 0 and cut into D
    contiguous shards, each solved by ``lm.solve_batch`` on its device, all
    shards in lockstep (``lm.solve_batch_shards``). A finished lane holds its
    state, so a lane's result does not depend on D: bit for bit on the CPU,
    to the last bits on the card (see ``lm.solve_batch_shards``)."""
    mesh = GroupMesh([batch.free.device] if devices is None else list(devices))
    D = len(mesh)
    G = batch.num_groups
    lanes = num_lanes(G, D)
    dtype, dev = batch.params.quats.dtype, batch.free.device
    if init_lambda is None and batch.warm_lambda is not None:
        init_lambda = batch.warm_lambda[0]
    lam0 = torch.ones(lanes, dtype=dtype, device=dev)
    if init_lambda is not None:
        lam0[:G] = torch.clamp(torch.as_tensor(init_lambda, device=dev).to(dtype), *WARM_LAMBDA_RANGE)
    layout = batch.layout
    shards = _lane_shards(mesh, pad_lanes(batch, lanes), lam0)
    if D == 1:
        params, blocks, free, surface_free, lam0 = shards[0]
        chunk = int(os.environ.get(MAX_GROUPS_ENV) or 0)
        chunk = 1 << (chunk.bit_length() - 1) if 0 < chunk < lanes else lanes
        parts = []
        for lo in range(0, lanes, chunk):
            hi = lo + chunk
            parts.append(_solve_batch(
                _lanes(params, lo, hi), tuple(_lanes(b, lo, hi) for b in blocks), free[lo:hi],
                surface_free[lo:hi], layout, pre_solve, max_iterations, lam0[lo:hi],
            ))
    else:
        if pre_solve:
            outs = lm.solve_batch_shards([(p, b, sf, 1.0) for p, b, _, sf, _ in shards], layout,
                                         max_iterations=max_iterations)
            shards = [(o[0],) + tuple(s[1:]) for o, s in zip(outs, shards)]
        parts = lm.solve_batch_shards([(p, b, f, lam) for p, b, f, _, lam in shards], layout,
                                      max_iterations=max_iterations)
    solved = _lanes(mesh.gather([s for s, _ in parts], device=dev), 0, G)
    info = _lanes(mesh.gather([i for _, i in parts], device=dev), 0, G)
    batch.warm_lambda = (info.final_lambda, None)
    return solved, info


# ---------------------------------------------------------------------------
# The joint solve with a shared tangent tail
# ---------------------------------------------------------------------------


def _group(tree, g: int):
    """Group g's slice of a stacked RelaxParams or BlockSpec (views)."""
    return map_tree(lambda x: x[g], tree)


class _SharedShard:
    """One shard's groups of the joint solve on its device: their parameters,
    blocks, masks and local dampings, and the shard's copy of the replicated
    state (the shared damping and its growth factor, the joint cost, the
    stop flag). Every replicated value is computed on each shard from
    reduced inputs by the same operations, so the copies stay equal."""

    def __init__(self, params, blocks, free, lam_l, lam_s, free_s, layout, n_local, tolerances):
        self.dtype, self.dev = params.quats.dtype, params.quats.device
        self.G = free.shape[0]
        self.layout, self.n_local, self.n_shared = layout, n_local, layout.dim - n_local
        self.parameter_tolerance, self.function_tolerance = tolerances
        self.free_l = free[:, :n_local]  # [Gk, nl]
        self.free_s = free_s  # [ns], replicated
        self.free_join = torch.cat([self.free_l, free_s.expand(self.G, self.n_shared)], dim=1)
        self.frozen_l = (~self.free_l).to(self.dtype)
        self.frozen_s = (~free_s).to(self.dtype)
        self.group_blocks = [[_group(b, g) for b in blocks] for g in range(self.G)]
        self.p, self.lam_l = params, lam_l
        self.lam_s = lam_s.to(self.dev, copy=True)
        self.nu_s = torch.as_tensor(2.0, dtype=self.dtype, device=self.dev)
        self.per = self.cost_per(params)

    def cost_per(self, p):
        return torch.stack([lm.total_cost(_group(p, g), self.group_blocks[g]) for g in range(self.G)])

    def start(self, cost0):
        self.cost = cost0
        self.done = ~torch.isfinite(cost0)

    def linearize(self):
        """Assemble the groups' normal equations."""
        Hg = [lm.normal_equations(_group(self.p, g), self.group_blocks[g], self.layout, self.free_join[g])
              for g in range(self.G)]
        self.H = torch.stack([h for h, _ in Hg])  # [Gk, T, T]
        self.g = torch.stack([v for _, v in Hg])  # [Gk, T]

    def reduce(self):
        """Damp the groups' normal equations, eliminate the local slots and
        return the shard's share of the shared system, packed as
        [S | rhs | diag(H_ss)]: [ns, ns + 2]."""
        nl, ns = self.n_local, self.n_shared
        H, g_ = self.H, self.g
        diag = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), 1e-10, 1e32)

        H_ll = H[:, :nl, :nl] + torch.diag_embed(self.lam_l[:, None] * diag[:, :nl] + self.frozen_l)
        H_ls = H[:, :nl, nl:]
        H_ss = H[:, nl:, nl:]
        g_l, g_s = g_[:, :nl], g_[:, nl:]

        # Jacobi-scaled block solves (see lm._jacobi_solve): the local blocks
        # mix units too, and float32 needs the scaling
        s_l = torch.rsqrt(torch.clamp(torch.diagonal(H_ll, dim1=-2, dim2=-1), 1e-24, 1e32))
        H_ll_s = H_ll * s_l[:, :, None] * s_l[:, None, :]
        rhs_l = torch.cat([H_ls, g_l[..., None]], dim=-1)
        X = s_l[:, :, None] * torch.linalg.solve_ex(H_ll_s, s_l[:, :, None] * rhs_l)[0]
        self.Hinv_Hls, self.Hinv_gl = X[..., :ns], X[..., ns]

        S = torch.sum(H_ss - torch.einsum("gls,glt->gst", H_ls, self.Hinv_Hls), dim=0)
        rhs = torch.sum(g_s - torch.einsum("gls,gl->gs", H_ls, self.Hinv_gl), dim=0)
        dss = torch.sum(torch.diagonal(H_ss, dim1=-2, dim2=-1), dim=0)
        return torch.cat([S, rhs[:, None], dss[:, None]], dim=1)

    def step(self, packed):
        """Solve the reduced shared system and back-substitute the local
        steps: the joint step [Gk, T]."""
        ns = self.n_shared
        S, rhs = packed[:, :ns], packed[:, ns]
        dss = torch.clamp(packed[:, ns + 1], 1e-10, 1e32)
        S = S + torch.diag(self.lam_s * dss) + torch.diag(self.frozen_s)
        d_s = torch.where(self.free_s, -lm._jacobi_solve(S, rhs), 0.0)

        d_l = -(self.Hinv_gl + torch.einsum("gls,s->gl", self.Hinv_Hls, d_s))
        d_l = torch.where(self.free_l, d_l, 0.0)
        return torch.cat([d_l, d_s.expand(self.G, ns)], dim=1)

    def trial(self, delta):
        """Take the trial step. Returns the shard's [cost, predicted
        decrease] partials and its largest step entry."""
        self.p_new = _stack_params([self.layout.retract(_group(self.p, g), delta[g]) for g in range(self.G)])
        self.per_new = self.cost_per(self.p_new)
        # gain ratio of the JOINT step: the predicted decrease of the
        # undamped Gauss-Newton model, summed over the groups
        self.pred_g = -(torch.einsum("gs,gs->g", self.g, delta)
                        + 0.5 * torch.einsum("gst,gs,gt->g", self.H, delta, delta))
        return torch.stack([torch.sum(self.per_new), torch.sum(self.pred_g)]), torch.max(torch.abs(delta))

    def update(self, new_cost, pred, step_max):
        """The accept test and the damping schedules from the reduced cost,
        predicted decrease and step maximum."""
        cost = self.cost
        rho = (cost - new_cost) / torch.clamp_min(pred, 1e-30)
        accept = torch.isfinite(new_cost) & (new_cost < cost) & (pred > 0)

        self.p = self.p.where(accept, self.p_new)
        # each group's local damping follows its OWN gain ratio: a group that
        # got worse raises its lambda even when the joint step is accepted;
        # on a joint reject the groups that improved keep theirs
        per, per_new, pred_g, lam_l = self.per, self.per_new, self.pred_g, self.lam_l
        rho_g = (per - per_new) / torch.clamp_min(pred_g, 1e-30)
        shrink_g = torch.clamp_min(1.0 - (2.0 * rho_g - 1.0) ** 3, 1.0 / 3.0)
        improved = torch.isfinite(per_new) & (per_new <= per) & (pred_g > 0)
        lam_l = torch.where(improved & accept, lam_l * shrink_g, torch.where(improved, lam_l, lam_l * 4.0))
        self.lam_l = torch.clamp(lam_l, 1e-12, 1e12)
        shrink_s = torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
        lam_s, nu_s = self.lam_s, self.nu_s
        self.lam_s = torch.where(accept, torch.clamp(lam_s * shrink_s, 1e-12, 1e12),
                                 torch.clamp_max(lam_s * nu_s, 1e12))
        self.nu_s = torch.where(accept, torch.as_tensor(2.0, dtype=self.dtype, device=self.dev),
                                torch.clamp_max(nu_s * 2.0, 1e6))

        step_small = step_max < self.parameter_tolerance
        cost_flat = accept & ((cost - new_cost) < self.function_tolerance * torch.clamp_min(cost, 1e-30))
        self.done = step_small | cost_flat | (self.lam_s > 1e10)
        self.per = torch.where(accept, per_new, per)
        self.cost = torch.where(accept, new_cost, cost)


def _solve_shared(params, blocks, free, layout, max_iterations, n_local=None, init_lam_l=None,
                  init_lam_s=1.0, parameter_tolerance=1e-8, function_tolerance=1e-6, mesh=None):
    """Joint LM over all groups with the trailing tangent block SHARED.

    Slots below ``n_local`` are group-local (rotations, and points where
    present); slots from ``n_local`` on are one copy shared by every group.
    For mesh problems the caller shares [mesh heights, intrinsics]
    (``n_local = mesh_off``), which makes the joint solve the global
    calibration problem (one surface, one set of intrinsics, all cameras);
    with points in the layout only the intrinsics are shared.

    The groups are cut into the shards of ``mesh`` (by default one shard on
    the params' device), as the reference lays them over its ``"groups"``
    mesh axis. Every iteration each shard assembles its groups' damped
    normal equations and eliminates their local slots; one ``psum`` of the
    packed [S | rhs | diag(H_ss)] forms the shared system, which every shard
    solves; each shard back-substitutes its own groups; the joint cost and
    the predicted decrease are psummed and the step's largest entry is
    pmaxed, and every shard takes the same accept decision. Damping is
    split: each group's local block has its own lambda, adapted from that
    group's own cost change and kept on its shard, and the shared system has
    one replicated lambda on Nielsen's schedule, so one ill-conditioned
    group raises only its own damping.

    The groups' normal equations are assembled one group after another and
    stacked to [Gk, T, T]: ``lm.normal_equations`` is a Python loop over
    families and instance chunks around ``vmap(jacfwd)``, the group count is
    small, and the loop keeps each group's sums bit-identical to a solve of
    that group alone. The host reads shard 0's ``done`` flag once per
    iteration; with one shard the result is the single-device solve's.

    Returns (params [G-stacked], SolveInfo, lam_l [G]) on the params'
    device."""
    dtype, dev = params.quats.dtype, params.quats.device
    mesh = GroupMesh([dev]) if mesh is None else mesh
    if n_local is None:
        n_local = layout.focal_off
    G = free.shape[0]
    lam_s = torch.as_tensor(init_lam_s, dtype=dtype, device=dev)
    lam_l = lam_s.expand(G).clone() if init_lam_l is None else torch.as_tensor(init_lam_l, device=dev).to(dtype)

    frees = mesh.split(free)
    # the shared tail is one set of unknowns: free where any group frees it
    free_s = mesh.any([f[:, n_local:].any(dim=0) for f in frees])
    tolerances = (parameter_tolerance, function_tolerance)
    with PerformanceMeasure("lm: solve"):  # the LM's spans and counts: see relax/lm.py
        shards = [_SharedShard(p, b, f, lam, lam_s, fs, layout, n_local, tolerances)
                  for p, b, f, lam, fs in zip(mesh.split(params), mesh.split(blocks), frees, mesh.split(lam_l),
                                              free_s)]
        for s, c in zip(shards, mesh.psum([torch.sum(s.per) for s in shards])):
            s.start(c)
        cost0 = shards[0].cost
        it = 0
        while it < max_iterations and not lm._stop_read(shards[0].done):  # one host sync per iteration
            add_event_count("lm steps", 1.0)
            with PerformanceMeasure("lm: linearize"):
                for s in shards:
                    s.linearize()
            with PerformanceMeasure("lm: linear solve"):
                packed = mesh.psum([s.reduce() for s in shards])
                deltas = [s.step(pk) for s, pk in zip(shards, packed)]
            with PerformanceMeasure("lm: evaluate"):
                partials = [s.trial(d) for s, d in zip(shards, deltas)]
                sums = mesh.psum([c for c, _ in partials])
                steps = mesh.pmax([m for _, m in partials])
                for s, sm, st in zip(shards, sums, steps):
                    s.update(sm[0], sm[1], st)
            it += 1

    s0 = shards[0]
    info = lm.SolveInfo(initial_cost=cost0.to(dev), final_cost=s0.cost.to(dev),
                        iterations=torch.tensor(it, dtype=torch.int32), final_lambda=s0.lam_s.to(dev))
    return mesh.gather([s.p for s in shards], device=dev), info, mesh.gather([s.lam_l for s in shards], device=dev)


def solve_group_batch_shared(
    batch: GroupBatch, pre_solve: bool, max_iterations: int = lm.DEFAULT_MAX_ITERATIONS, devices=None,
) -> Tuple[RelaxParams, lm.SolveInfo]:
    """Joint solve of a batch built with ``shared_intrinsics=True``.

    For mesh problems the shared tail is [mesh heights, intrinsics]: every
    group carries a copy of the SAME surface, so sharing it gives the global
    calibration problem, where private meshes would let the focal drift
    along the focal / height valley. With points in the layout, or mesh
    copies that differ, only the intrinsics are shared.

    ``devices`` lists the shards (a device may repeat; by default the
    batch's own device): the groups are spread over ``min(len(devices), G)``
    of them, padded to a multiple of that count by copies of group 0 that
    are frozen and carry block weight 0, so the joint problem counts each
    real group once. Returns the solved parameters ([G]-stacked tensors on
    the batch's device) and the joint solve's info; the exit dampings of the
    real groups are kept on the batch for the next solve."""
    if not batch.shared_intrinsics:
        raise ValueError("solve_group_batch_shared needs a batch built with shared_intrinsics=True")
    layout, params = batch.layout, batch.params
    G = batch.num_groups
    devices = [batch.free.device] if devices is None else list(devices)
    D = min(len(devices), G)
    mesh = GroupMesh(devices[:D])
    pad = num_lanes(G, D, shared=True) - G

    share_mesh = layout.V > 0 and layout.P == 0
    if share_mesh:
        mz = _np(params.mesh_z)
        share_mesh = bool(np.allclose(mz, mz[0:1], atol=1e-9, equal_nan=True))
    n_local = layout.mesh_off if share_mesh else layout.focal_off

    # instances that live wholly in the shared tail (mesh priors, radial
    # monotonicity) exist once per group copy: weighted 1/G (the real G), the
    # joint objective counts them once
    def downweight(b):
        all_shared = torch.all(b.slots >= n_local, dim=-1)
        return dataclasses.replace(b, weight=torch.where(all_shared, b.weight / G, b.weight))

    work = pad_lanes(dataclasses.replace(batch, blocks=tuple(downweight(b) for b in batch.blocks)), G + pad)
    params, blocks, free, surface_free = work.params, work.blocks, work.free, work.surface_free
    if pad:
        # the copies are frozen, and weightless: the joint cost and normal
        # equations sum over the groups, so a live copy would count group 0
        # twice
        real = (torch.arange(G + pad, device=free.device) < G)[:, None]
        blocks = tuple(dataclasses.replace(b, weight=torch.where(real, b.weight, 0.0)) for b in blocks)

    with full_fp32():
        if pre_solve and share_mesh:
            # the pre-solve moves the shared surface: solved jointly, so every
            # group's copy stays identical
            params, _, _ = _solve_shared(params, blocks, surface_free, layout, max_iterations, n_local=n_local,
                                         mesh=mesh)
        elif pre_solve:
            # the surface slots are group-local: independent lanes, each
            # shard's in one lane-batched LM
            outs = lm.solve_batch_shards(
                [(p, b, sf, 1.0) for p, b, sf in zip(mesh.split(params), mesh.split(blocks), mesh.split(surface_free))],
                layout, max_iterations=max_iterations)
            params = mesh.gather([p for p, _ in outs], device=free.device)
        lam_l0, lam_s0 = None, 1.0
        if batch.warm_lambda is not None and batch.warm_lambda[1] is not None:
            wl, ws = batch.warm_lambda
            lam_s0 = torch.clamp(ws, *WARM_LAMBDA_RANGE)
            if wl is not None:
                lam_l0 = torch.clamp(wl, *WARM_LAMBDA_RANGE)
                lam_l0 = torch.cat([lam_l0, torch.ones(pad, dtype=lam_l0.dtype, device=lam_l0.device)])
        solved, info, lam_l = _solve_shared(
            params, blocks, free, layout, max_iterations, n_local=n_local, init_lam_l=lam_l0, init_lam_s=lam_s0,
            mesh=mesh,
        )
    if pad:
        solved = _lanes(solved, 0, G)
        lam_l = lam_l[:G]
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
