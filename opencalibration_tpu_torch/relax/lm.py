"""Masked Levenberg-Marquardt (twin of opencalibration_tpu/relax/lm.py).

Each residual family is mapped over its instances with ``torch.func.vmap``;
``torch.func.jacfwd`` gives every instance's local Jacobian at delta = 0.
Robust losses use the IRLS form: residual and Jacobian scaled by
sqrt(rho'(s)), cost summed with the true rho. Two linear solvers answer the
damped Gauss-Newton system of each iteration:

* ``cholesky``: the L x L pieces are summed into a dense [T, T] system by a
  one-hot product, which one dense solve answers;
* ``cg``: the pieces stay in per-instance form and a Jacobi- (or
  block-Jacobi-) preconditioned conjugate gradient applies H matrix-free:
  gather, [L, L] product, sorted segment sum.

Every sum into the tangent vector is a fixed-order reduction: the slots are
sorted once per solve and reduced segment by segment, because
``index_add_`` on the card uses atomics and would change the sum from run to
run. The LM loop is a Python loop that reads one ``done`` flag from the
device per iteration; the CG loop evaluates its stop test on the device,
freezes its state once the test says stop, and reads the flag only every
``_CG_CHECK_EVERY`` iterations, so its result is the reference's
while-loop's.

Every LM loop (``solve``, ``solve_batch_shards``, and the shared-intrinsics
loop of ``parallel/group_solver.py``) records the same performance spans:
``lm: solve`` around the call, and in each step ``lm: linearize`` (the
quadratics or normal equations, gradient and diagonal), ``lm: linear solve``
(PCG or the dense solve, with the preconditioner) and ``lm: evaluate``
(retract, new cost, the step's decision); ``lm: stop read`` around each host
read of ``done``. It counts ``lm steps`` (one per loop turn, however many
lanes or shards run in it) and ``lm host reads`` (each deliberate read of a
device flag by the host, the CG checks included; implicit syncs are not
counted).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch.func import jacfwd, vmap

from opencalibration_tpu_torch.relax.blocks import BlockSpec
from opencalibration_tpu_torch.relax.tangent import FIELDS, RelaxParams, TangentLayout
from opencalibration_tpu_torch.utils.device import full_fp32, lane_invariant_linalg
from opencalibration_tpu_torch.utils.performance import PerformanceMeasure, add_event_count

DEFAULT_MAX_ITERATIONS = 100
# ``linear_solver="auto"`` takes the matrix-free CG path from this tangent
# dimension on (the reference's threshold, kept for parity)
CG_DIM_THRESHOLD = 1024
CG_RTOL = 1e-2  # forcing tolerance of the inexact CG step
CG_MAX_ITERS = 100
_ASSEMBLE_CHUNK = 2048  # instances per one-hot assembly chunk
_CG_CHECK_EVERY = 8  # CG iterations per host read of the stop flag


def _huber_rho_and_weight(s, delta):
    """Huber: rho(s) = s for s <= d^2 else 2 d sqrt(s) - d^2; weight
    rho'(s) = min(1, d / sqrt(s))."""
    if delta is None:
        return s, torch.ones_like(s)
    d2 = delta * delta
    sqrt_s = torch.sqrt(torch.clamp_min(s, 1e-30))
    rho = torch.where(s <= d2, s, 2.0 * delta * sqrt_s - d2)
    w = torch.where(s <= d2, 1.0, delta / sqrt_s)
    return rho, w


def _block_values(params: RelaxParams, blk: BlockSpec):
    """Residuals at delta = 0 for every instance: [B, R]."""
    z = torch.zeros(blk.slots.shape[1], dtype=params.quats.dtype, device=params.quats.device)
    return vmap(lambda d: blk.resid_one(z, d, params))(blk.data)


def block_cost(params: RelaxParams, blk: BlockSpec):
    r = _block_values(params, blk)
    rho, _ = _huber_rho_and_weight(torch.sum(r * r, dim=-1), blk.huber_delta)
    w = blk.weight
    # a NaN residual on an active instance poisons the cost
    rho = torch.where(w > 0, rho, 0.0)
    return 0.5 * torch.sum(rho * w)


def total_cost(params: RelaxParams, blocks: Sequence[BlockSpec]):
    return sum(block_cost(params, b) for b in blocks)


def _accumulate_hg(H, g, JtJ, Jtr, slots):
    """H += O^T JtJ O and g += O^T Jtr with O the [B, L, T] slot one-hot,
    chunked over instances to bound the one-hot buffer."""
    T = H.shape[0]
    for c0 in range(0, slots.shape[0], _ASSEMBLE_CHUNK):
        sl = slots[c0 : c0 + _ASSEMBLE_CHUNK]
        # the one-hot as a comparison: F.one_hot has no batching rule
        O = (sl[..., None] == torch.arange(T, device=sl.device)).to(JtJ.dtype)
        H = H + torch.einsum("blm,blt,bms->ts", JtJ[c0 : c0 + _ASSEMBLE_CHUNK], O, O)
        g = g + torch.einsum("bl,blt->t", Jtr[c0 : c0 + _ASSEMBLE_CHUNK], O)
    return H, g


def _block_quadratics(params: RelaxParams, blk: BlockSpec, free_mask):
    """Per-instance Gauss-Newton pieces (JtJ_w [B, L, L], Jtr_w [B, L]):
    robust-weighted, frozen columns masked, non-finite instances zeroed."""
    L = blk.slots.shape[1]
    z = torch.zeros(L, dtype=params.quats.dtype, device=params.quats.device)

    def one(d):
        def f(dl):
            r = blk.resid_one(dl, d, params)
            return r, r

        return jacfwd(f, has_aux=True)(z)

    J, r = vmap(one)(blk.data)  # [B, R, L], [B, R]
    _, w_rob = _huber_rho_and_weight(torch.sum(r * r, dim=-1), blk.huber_delta)
    w = blk.weight * w_rob
    finite = torch.isfinite(r).all(dim=-1) & torch.isfinite(J).all(dim=-1).all(dim=-1)
    w = torch.where(finite, w, 0.0)
    r = torch.where(finite[:, None], r, 0.0)
    J = torch.where(finite[:, None, None], J, 0.0)

    Jm = J * free_mask[blk.slots].to(J.dtype)[:, None, :]
    JtJ = torch.einsum("brl,brm->blm", Jm, Jm) * w[:, None, None]
    Jtr = torch.einsum("brl,br->bl", Jm, r) * w[:, None]
    return JtJ, Jtr


def normal_equations(params: RelaxParams, blocks: Sequence[BlockSpec], layout: TangentLayout, free_mask):
    """Dense Gauss-Newton system (H [T, T], g [T])."""
    dtype, dev = params.quats.dtype, params.quats.device
    H = torch.zeros((layout.dim, layout.dim), dtype=dtype, device=dev)
    g = torch.zeros((layout.dim,), dtype=dtype, device=dev)
    for blk in blocks:
        JtJ, Jtr = _block_quadratics(params, blk, free_mask)
        H, g = _accumulate_hg(H, g, JtJ, Jtr, blk.slots)
    return H, g


# ---------------------------------------------------------------------------
# Matrix-free normal-equation operator: the pieces stay per instance, and
# every product into the tangent vector is a sorted segment sum, O(B L^2) per
# CG iteration whatever T is.
# ---------------------------------------------------------------------------


def _quads_all(params, blocks, free):
    """Every family's (JtJ_w, Jtr_w)."""
    return [_block_quadratics(params, b, free) for b in blocks]


@dataclasses.dataclass(frozen=True)
class SegmentOrder:
    """A fixed reduction order of flat values into ``num_segments`` sums:
    ``perm`` sorts the values by segment id (stably) and ``lengths`` counts
    each segment's values, empty segments included."""

    perm: torch.Tensor
    lengths: torch.Tensor


def _segment_order(ids, num_segments: int) -> SegmentOrder:
    perm = torch.argsort(ids, stable=True)
    return SegmentOrder(perm, torch.bincount(ids, minlength=num_segments))


def _segment_sum(values, order: SegmentOrder):
    """Segment sums of flat ``values`` in the order's fixed order."""
    return torch.segment_reduce(values[order.perm], "sum", lengths=order.lengths)


def _flat_slot_order(blocks, T) -> SegmentOrder:
    """Order of the concatenated flattened slot lists of every family (slots
    are constant during a solve, so this is computed once per solve)."""
    flat = torch.cat([b.slots.reshape(-1) for b in blocks])
    return _segment_order(flat, T)


def _scatter_sorted(parts, order: SegmentOrder):
    """Sum per-family [B, L] contributions into a [T] vector."""
    return _segment_sum(torch.cat([p.reshape(-1) for p in parts]), order)


def _gn_matvec(v, quads, blocks, order):
    """H @ v with H = sum_b O_b^T JtJ_b O_b, never materialising H."""
    parts = [torch.einsum("blm,bm->bl", JtJ, v[blk.slots]) for (JtJ, _), blk in zip(quads, blocks)]
    return _scatter_sorted(parts, order)


def _gn_diag(quads, blocks, order):
    """Exact diag(H): duplicate slots within one instance fold their cross
    terms into the diagonal, as the one-hot assembly does."""
    parts = []
    for (JtJ, _), blk in zip(quads, blocks):
        eq = (blk.slots[:, :, None] == blk.slots[:, None, :]).to(JtJ.dtype)
        parts.append(torch.sum(JtJ * eq, dim=-1))
    return _scatter_sorted(parts, order)


def _gn_grad(quads, blocks, order):
    return _scatter_sorted([Jtr for (_, Jtr) in quads], order)


# ---------------------------------------------------------------------------
# Block-Jacobi preconditioner: one 3x3 block per camera rotation and per 3-d
# point, one dense block over the intrinsics tail, scalar mesh heights, each
# exactly as assembled in H (duplicate slots folded as in ``_gn_diag``).
# ---------------------------------------------------------------------------


def _bj_pair_segments(s, layout, TT):
    """Segment id [B, L, L] of each slot pair (l, m) in the block-diagonal
    accumulator; pairs off the blocks map to segment S (dropped).
    Segment space: [C*9 rotations | P*9 points | TT*TT intrinsics tail]."""
    C, P = layout.C, layout.P
    S_rot, S_pt = 9 * C, 9 * P
    S = S_rot + S_pt + TT * TT
    rot = s < 3 * C
    pt = (s >= layout.point_off) & (s < layout.focal_off)
    tail = s >= layout.focal_off
    bid = torch.div(s, 3, rounding_mode="floor")
    pid = torch.div(s - layout.point_off, 3, rounding_mode="floor")
    sub_r = torch.remainder(s, 3)
    sub_p = torch.remainder(s - layout.point_off, 3)
    t = s - layout.focal_off

    def p2(a):  # pair-broadcast over the trailing slot axis
        return a[..., :, None], a[..., None, :]

    rot_l, rot_m = p2(rot)
    pt_l, pt_m = p2(pt)
    tail_l, tail_m = p2(tail)
    bid_l, bid_m = p2(bid)
    pid_l, pid_m = p2(pid)
    sr_l, sr_m = p2(sub_r)
    sp_l, sp_m = p2(sub_p)
    t_l, t_m = p2(t)

    seg = torch.full(s.shape + (s.shape[-1],), S, dtype=torch.int64, device=s.device)
    seg = torch.where(rot_l & rot_m & (bid_l == bid_m), bid_l * 9 + sr_l * 3 + sr_m, seg)
    seg = torch.where(pt_l & pt_m & (pid_l == pid_m), S_rot + pid_l * 9 + sp_l * 3 + sp_m, seg)
    seg = torch.where(tail_l & tail_m, S_rot + S_pt + t_l * TT + t_m, seg)
    return seg


def _bj_segment_order(blocks, layout) -> SegmentOrder:
    """Fixed reduction order of every family's slot pairs into the
    block-diagonal accumulator (S + 1 segments, the last one dropped)."""
    TT = layout.dim - layout.focal_off
    S = 9 * layout.C + 9 * layout.P + TT * TT
    ids = torch.cat([_bj_pair_segments(b.slots, layout, TT).reshape(-1) for b in blocks])
    return _segment_order(ids, S + 1)


def _bj_block_sums(quads, order: SegmentOrder):
    """The block-diagonal entries of H as a flat [S] vector."""
    return _segment_sum(torch.cat([JtJ.reshape(-1) for JtJ, _ in quads]), order)[:-1]


def _bj_build(quads, layout, damp, diag, order: SegmentOrder):
    """The factorised block-Jacobi preconditioner as an apply function
    z = M^-1 r. ``damp`` and ``diag`` are the [T] damping and exact diag(H)
    of the CG outer loop."""
    C, P = layout.C, layout.P
    TT = layout.dim - layout.focal_off  # the whole intrinsics tail (8M slots)
    sums = _bj_block_sums(quads, order)
    dtype, dev = sums.dtype, sums.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    def inv_blocks3(flat, d):  # [n*9] + damping [n, 3] -> [n, 3, 3] inverses
        n = d.shape[0]
        return torch.linalg.inv(flat.reshape(n, 3, 3) + torch.diag_embed(d) + 1e-10 * eye3)

    inv_rot = inv_blocks3(sums[: 9 * C], damp[: 3 * C].reshape(C, 3))
    pre_mesh = torch.clamp((diag + damp)[layout.mesh_off : layout.point_off], 1e-20, 1e32)
    if P:
        inv_pt = inv_blocks3(sums[9 * C : 9 * C + 9 * P], damp[layout.point_off : layout.focal_off].reshape(P, 3))
    tail = sums[9 * C + 9 * P :].reshape(TT, TT)
    tail = tail + torch.diag(damp[layout.focal_off :]) + 1e-10 * torch.eye(TT, dtype=dtype, device=dev)
    # symmetric Jacobi scaling before the inversion: the tail mixes focal
    # (~1e2..1e3 px) and distortion (~1e-1) units
    s_tail = torch.rsqrt(torch.clamp(torch.diagonal(tail), 1e-24, 1e32))
    inv_tail = s_tail[:, None] * torch.linalg.inv(tail * s_tail[:, None] * s_tail[None, :]) * s_tail[None, :]

    def apply(r):
        parts = [
            torch.einsum("cij,cj->ci", inv_rot, r[: 3 * C].reshape(C, 3)).reshape(-1),
            r[layout.mesh_off : layout.point_off] / pre_mesh,
        ]
        if P:
            parts.append(
                torch.einsum("cij,cj->ci", inv_pt, r[layout.point_off : layout.focal_off].reshape(P, 3)).reshape(-1)
            )
        parts.append(inv_tail @ r[layout.focal_off :])
        return torch.cat(parts)

    return apply


def _host_read(flags):
    """The host's copy of device flags (a bool, or a list of them), counted
    as one of the LM's host reads."""
    add_event_count("lm host reads", 1.0)
    return flags.tolist()


def _stop_read(done):
    """The host read of an LM loop's ``done`` flag (or flags)."""
    with PerformanceMeasure("lm: stop read"):
        return _host_read(done)


def _pcg(matvec, b, pre_apply, rtol, max_iters, read=bool):
    """Preconditioned CG from x0 = 0 (pre_apply: r -> M^-1 r). Returns
    (x, r_final).

    Every iteration evaluates the reference's loop condition on the device
    and keeps the old state where it is false, so the state is frozen from
    the first stop on; the host reads the condition (``read``) only every
    ``_CG_CHECK_EVERY`` iterations to leave the loop early."""
    tol2 = (rtol * rtol) * torch.clamp_min(torch.sum(b * b), 1e-38)
    z0 = pre_apply(b)
    x, r, p = torch.zeros_like(b), b, z0
    rz = torch.sum(b * z0)
    done = torch.sum(b * b) <= 0.0  # zero right-hand side
    for k in range(max_iters):
        active = (~done) & (torch.sum(r * r) > tol2)
        if k and k % _CG_CHECK_EVERY == 0 and not read(active):
            break
        Ap = matvec(p)
        pAp = torch.sum(p * Ap)
        ok = (pAp > 0) & torch.isfinite(pAp)
        alpha = torch.where(ok, rz / torch.clamp_min(pAp, 1e-38), 0.0)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = pre_apply(r_new)
        rz_new = torch.sum(r_new * z)
        beta = torch.where(rz > 0, rz_new / torch.clamp_min(rz, 1e-38), 0.0)
        p_new = z + beta * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rz = torch.where(active, rz_new, rz)
        done = torch.where(active, done | ~ok, done)
    return x, r


def _jacobi_solve(A, b):
    """Solve A x = b as (S A S)(S^-1 x) = S b with S = diag(A)^-1/2, which
    keeps the float32 factorisation well-conditioned across rotation, mesh
    and focal units. ``solve_ex`` neither raises nor waits for the device
    on a singular system: the non-finite step is rejected by the caller.
    Leading axes of ``A`` [..., T, T] and ``b`` [..., T] are lanes."""
    s = torch.rsqrt(torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), 1e-24, 1e32))
    As = A * s[..., :, None] * s[..., None, :]
    return s * torch.linalg.solve_ex(As, s * b)[0]


@dataclasses.dataclass(frozen=True)
class SolveInfo:
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: torch.Tensor
    final_lambda: torch.Tensor  # damping at exit, to warm-start a repeat solve


def _lm_update(cost, new_cost, pred, lam, nu, step_max, parameter_tolerance, function_tolerance):
    """One LM step's decision, elementwise (a scalar, or [G] lanes): the
    gain-ratio acceptance, the Nielsen damping schedule and the stop tests,
    from the cost before and after the step, the damped model's predicted
    decrease ``pred`` and the step's largest entry. Returns (accept, lam,
    nu, done) after the step."""
    rho = (cost - new_cost) / torch.clamp_min(pred, 1e-30)
    accept = torch.isfinite(new_cost) & (new_cost < cost) & (pred > 0)
    # Nielsen: a good model (rho ~ 1) cuts lambda up to 3x, a poor one
    # barely; consecutive rejects escalate geometrically
    shrink = torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
    lam = torch.where(accept, torch.clamp(lam * shrink, 1e-12, 1e12), torch.clamp_max(lam * nu, 1e12))
    nu = torch.where(accept, 2.0, torch.clamp_max(nu * 2.0, 1e6))
    step_small = step_max < parameter_tolerance
    cost_flat = accept & ((cost - new_cost) < function_tolerance * torch.clamp_min(cost, 1e-30))
    return accept, lam, nu, step_small | cost_flat | (lam > 1e10)


def route(dim: int) -> str:
    """The linear solver ``linear_solver="auto"`` takes at tangent ``dim``."""
    return "cg" if dim >= CG_DIM_THRESHOLD else "cholesky"


def solve(
    params: RelaxParams,
    blocks: Sequence[BlockSpec],
    layout: TangentLayout,
    free_mask,
    max_iterations: int = DEFAULT_MAX_ITERATIONS,
    init_lambda=1.0,
    parameter_tolerance: float = 1e-8,
    function_tolerance: float = 1e-6,
    linear_solver: str = "auto",
    cg_precond: str = "jacobi",
):
    """Run LM to convergence. Returns (params, SolveInfo).

    Same gain-ratio acceptance, Nielsen damping schedule and stop tests as
    the reference. ``linear_solver``: 'cholesky' (dense normal equations),
    'cg' (matrix-free preconditioned CG at rtol ``CG_RTOL``, at most
    ``CG_MAX_ITERS`` iterations) or 'auto' (by ``layout.dim``, see
    ``route``). ``cg_precond``: 'jacobi' (scalar) or 'block'. Products and
    solves run in full float32 (TF32 off): the normal equations mix rotation
    and focal scales."""
    if linear_solver == "auto":
        linear_solver = route(layout.dim)
    if linear_solver not in ("cholesky", "cg") or cg_precond not in ("jacobi", "block"):
        raise ValueError(f"unknown linear solver {linear_solver!r} / preconditioner {cg_precond!r}")
    with full_fp32(), PerformanceMeasure("lm: solve"):
        return _solve_impl(
            params, tuple(blocks), layout, free_mask, max_iterations, init_lambda,
            parameter_tolerance, function_tolerance, linear_solver, cg_precond,
        )


def _solve_impl(params, blocks, layout, free_mask, max_iterations, init_lambda,
                parameter_tolerance, function_tolerance, linear_solver, cg_precond):
    dtype, dev = params.quats.dtype, params.quats.device
    free = torch.as_tensor(free_mask, device=dev)
    frozen = (~free).to(dtype)

    def scalar(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    if linear_solver == "cg":
        order = _flat_slot_order(blocks, layout.dim)
        bj_order = _bj_segment_order(blocks, layout) if cg_precond == "block" else None

    cost0 = total_cost(params, blocks)
    p, lam, nu, cost = params, scalar(init_lambda), scalar(2.0), cost0
    done = ~torch.isfinite(cost0)
    it = 0
    while it < max_iterations and not _stop_read(done):  # one host sync per iteration
        add_event_count("lm steps", 1.0)
        if linear_solver == "cg":
            with PerformanceMeasure("lm: linearize"):
                quads = _quads_all(p, blocks, free)
                g = _gn_grad(quads, blocks, order)
                diag = torch.clamp(_gn_diag(quads, blocks, order), 1e-10, 1e32)
            with PerformanceMeasure("lm: linear solve"):
                # A = H + lam diag(H) + I_frozen, applied matrix-free
                damp = lam * diag + frozen

                def matvec(v):
                    return _gn_matvec(v, quads, blocks, order) + damp * v

                if cg_precond == "block":
                    pre_apply = _bj_build(quads, layout, damp, diag, bj_order)
                else:
                    pre_diag = diag + damp
                    pre_apply = lambda r: r / pre_diag  # noqa: E731
                delta, r_cg = _pcg(matvec, -g, pre_apply, CG_RTOL, CG_MAX_ITERS, read=_host_read)
                delta = torch.where(free, delta, 0.0)
                # inexact step: A delta = -g - r  =>  pred = 0.5 (delta.r - delta.g)
                pred = 0.5 * (torch.sum(delta * r_cg) - torch.sum(delta * g))
        else:
            with PerformanceMeasure("lm: linearize"):
                H, g = normal_equations(p, blocks, layout, free)
                diag = torch.clamp(torch.diagonal(H), 1e-10, 1e32)
            with PerformanceMeasure("lm: linear solve"):
                # frozen slots: unit diagonal keeps the system SPD, zero gradient
                A = H + lam * torch.diag(diag) + torch.diag(frozen)
                delta = torch.where(free, -_jacobi_solve(A, g), 0.0)
                # gain ratio: actual decrease over the damped model's prediction,
                # (H + lam D) delta = -g  =>  pred = 0.5 delta^T (lam D delta - g)
                pred = 0.5 * torch.sum(delta * (lam * diag * delta - g))

        with PerformanceMeasure("lm: evaluate"):
            p_new = layout.retract(p, delta)
            new_cost = total_cost(p_new, blocks)
            accept, lam, nu, done = _lm_update(cost, new_cost, pred, lam, nu, torch.max(torch.abs(delta)),
                                               parameter_tolerance, function_tolerance)
            p = p.where(accept, p_new)
            cost = torch.where(accept, new_cost, cost)
        it += 1

    return p, SolveInfo(
        initial_cost=cost0, final_cost=cost, iterations=torch.tensor(it, dtype=torch.int32),
        final_lambda=lam,
    )


# ---------------------------------------------------------------------------
# The LM over a leading lane axis (the reference's ``vmap`` of ``solve``):
# params, block leaves and masks carry [G, ...]; every lane keeps its own
# damping, cost, stop flag and iteration count, and a finished lane holds its
# state while the others run on.
# ---------------------------------------------------------------------------


def _lane_call(fn, params: RelaxParams, blocks, *args):
    """``fn(params, blocks, *args)`` of one lane, mapped over the leading lane
    axis of the params, the block leaves (slots, weight, data) and ``args``."""

    def lane(fields, leaves, *a):
        blks = [dataclasses.replace(b, slots=s, weight=w, data=d) for b, (s, w, d) in zip(blocks, leaves)]
        return fn(RelaxParams(*fields), blks, *a)

    fields = tuple(getattr(params, f) for f in FIELDS)
    return vmap(lane)(fields, [(b.slots, b.weight, b.data) for b in blocks], *args)


def _lane_where(cond, a, b):
    """``a if cond else b`` per lane for a [G] condition and [G, ...] values."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - 1)), a, b)


def _params_where(cond, a: RelaxParams, b: RelaxParams) -> RelaxParams:
    return RelaxParams(**{f: _lane_where(cond, getattr(a, f), getattr(b, f)) for f in FIELDS})


def _lane_offsets(blk, T):
    """Slots of every lane moved to the lane's own range [g T, (g + 1) T)."""
    G = blk.slots.shape[0]
    return blk.slots + T * torch.arange(G, device=blk.slots.device).reshape((G,) + (1,) * (blk.slots.ndim - 1))


def _flat_lanes(parts):
    """Per-family [G, ...] contributions flattened lane-major: lane g's values
    of every family (family order, then instance order, as one lane alone
    lays them out), then lane g + 1's."""
    G = parts[0].shape[0]
    return torch.cat([p.reshape(G, -1) for p in parts], dim=1).reshape(-1)


def _lane_slot_order(blocks, T) -> SegmentOrder:
    """The sorted-segment order of every lane's slots over G T segments: a
    lane's sums run in the order of its own solve's ``_flat_slot_order``."""
    G = blocks[0].slots.shape[0]
    return _segment_order(_flat_lanes([_lane_offsets(b, T) for b in blocks]), G * T)


def _lane_scatter(parts, order: SegmentOrder, G):
    return _segment_sum(_flat_lanes(parts), order).reshape(G, -1)


def _lane_gather(v, slots):
    """v[g, slots[g]] for every lane: [G, T] and [G, B, L] -> [G, B, L]."""
    G = v.shape[0]
    return torch.gather(v, 1, slots.reshape(G, -1)).reshape(slots.shape)


def _lane_matvec(v, quads, blocks, order):
    parts = [torch.einsum("gblm,gbm->gbl", JtJ, _lane_gather(v, blk.slots)) for (JtJ, _), blk in zip(quads, blocks)]
    return _lane_scatter(parts, order, v.shape[0])


def _lane_diag(quads, blocks, order, G):
    parts = []
    for (JtJ, _), blk in zip(quads, blocks):
        eq = (blk.slots[..., :, None] == blk.slots[..., None, :]).to(JtJ.dtype)
        parts.append(torch.sum(JtJ * eq, dim=-1))
    return _lane_scatter(parts, order, G)


def _lane_pcg(matvec, b, pre_apply, rtol, max_iters, live):
    """``_pcg`` of every lane at once ([G, T] vectors, [G] scalars). Each lane
    runs until its own stop test holds and then holds its state; lanes that
    are not ``live`` (their LM is done) start stopped. The host reads whether
    any lane is still active every ``_CG_CHECK_EVERY`` iterations."""
    bb = torch.sum(b * b, dim=-1)
    tol2 = (rtol * rtol) * torch.clamp_min(bb, 1e-38)
    z0 = pre_apply(b)
    x, r, p = torch.zeros_like(b), b, z0
    rz = torch.sum(b * z0, dim=-1)
    done = (bb <= 0.0) | ~live
    for k in range(max_iters):
        active = (~done) & (torch.sum(r * r, dim=-1) > tol2)
        if k and k % _CG_CHECK_EVERY == 0 and not _host_read(active.any()):
            break
        Ap = matvec(p)
        pAp = torch.sum(p * Ap, dim=-1)
        ok = (pAp > 0) & torch.isfinite(pAp)
        alpha = torch.where(ok, rz / torch.clamp_min(pAp, 1e-38), 0.0)
        x_new = x + alpha[:, None] * p
        r_new = r - alpha[:, None] * Ap
        z = pre_apply(r_new)
        rz_new = torch.sum(r_new * z, dim=-1)
        beta = torch.where(rz > 0, rz_new / torch.clamp_min(rz, 1e-38), 0.0)
        p_new = z + beta[:, None] * p
        x = _lane_where(active, x_new, x)
        r = _lane_where(active, r_new, r)
        p = _lane_where(active, p_new, p)
        rz = torch.where(active, rz_new, rz)
        done = torch.where(active, done | ~ok, done)
    return x, r


def solve_batch(
    params: RelaxParams,
    blocks: Sequence[BlockSpec],
    layout: TangentLayout,
    free_mask,
    max_iterations: int = DEFAULT_MAX_ITERATIONS,
    init_lambda=1.0,
    parameter_tolerance: float = 1e-8,
    function_tolerance: float = 1e-6,
    linear_solver: str = "auto",
):
    """``solve`` over a leading lane axis: the leaves of ``params`` and of
    every block, and ``free_mask``, carry [G, ...]; ``init_lambda`` is a
    scalar or [G]. Each lane runs the single solve's LM: its own damping,
    Nielsen schedule, gain-ratio acceptance and stop tests; a lane that is
    done holds its state (the reference's ``vmap`` of its while-loop). The
    loop ends when every lane is done or at ``max_iterations``, with one
    host read per iteration. The route follows ``layout.dim`` as in
    ``solve``; the CG route takes the scalar Jacobi preconditioner, as the
    reference's batched solve does. Returns (params [G, ...], SolveInfo
    with [G] leaves)."""
    ((params, info),) = solve_batch_shards([(params, blocks, free_mask, init_lambda)], layout, max_iterations,
                                           parameter_tolerance, function_tolerance, linear_solver)
    return params, info


def solve_batch_shards(
    shards: Sequence[tuple],
    layout: TangentLayout,
    max_iterations: int = DEFAULT_MAX_ITERATIONS,
    parameter_tolerance: float = 1e-8,
    function_tolerance: float = 1e-6,
    linear_solver: str = "auto",
):
    """``solve_batch`` of several shards of lanes in lockstep: ``shards`` is a
    list of (params, blocks, free_mask, init_lambda), each on its own device
    (a device may repeat). Every iteration launches one LM iteration of each
    shard that is not done, in shard order, then reads every shard's flag
    in one host read, so that shards on distinct cards overlap. On the CPU a
    lane's result does not depend on the other lanes of its call; on the
    card the factorisations are pinned to cuSOLVER
    (``lane_invariant_linalg``), and the batched products can still round a
    lane's last bits by its batch. Returns one (params, SolveInfo) per
    shard."""
    if linear_solver == "auto":
        linear_solver = route(layout.dim)
    if linear_solver not in ("cholesky", "cg"):
        raise ValueError(f"unknown linear solver {linear_solver!r}")
    with full_fp32(), lane_invariant_linalg(), PerformanceMeasure("lm: solve"):
        return run_lockstep([
            _batch_iterations(params, tuple(blocks), layout, free, max_iterations, lam0, parameter_tolerance,
                              function_tolerance, linear_solver)
            for params, blocks, free, lam0 in shards
        ])


def _advance(run, stop):
    """Send ``stop`` to an LM generator: (True, its result) once it returns,
    else (False, its next ``done`` flag)."""
    try:
        return False, run.send(stop)
    except StopIteration as end:
        return True, end.value


def run_lockstep(runs: Sequence) -> list:
    """Drive LM generators (``_batch_iterations``) in lockstep and return
    their results in order. Each generator yields a 0-d ``done`` flag on its
    device before every iteration; all live flags are read in one host read
    (one flag alone: the single solve's one sync), and each generator is
    told whether to stop or to run its next iteration."""
    results = [None] * len(runs)
    live = {}
    for k, run in enumerate(runs):
        finished, value = _advance(run, None)
        if finished:
            results[k] = value
        else:
            live[k] = value
    while live:
        flags = list(live.values())
        if len(flags) == 1:
            stops = [_stop_read(flags[0])]
        else:
            dev0 = flags[0].device
            stops = _stop_read(torch.stack([f.to(dev0) for f in flags]))
        if not all(stops):
            add_event_count("lm steps", 1.0)  # one lockstep turn
        nxt = {}
        for k, stop in zip(list(live), stops):
            finished, value = _advance(runs[k], stop)
            if finished:
                results[k] = value
            else:
                nxt[k] = value
        live = nxt
    return results


def _batch_iterations(params, blocks, layout, free_mask, max_iterations, init_lambda,
                      parameter_tolerance, function_tolerance, linear_solver):
    """The LM of ``solve_batch`` as a generator (see ``run_lockstep``): it
    yields ``done.all()`` before each iteration, runs the iteration when sent
    False, and returns (params, SolveInfo) when sent True or at
    ``max_iterations``."""
    dtype, dev = params.quats.dtype, params.quats.device
    free = torch.as_tensor(free_mask, device=dev)
    G, T = free.shape
    frozen = (~free).to(dtype)

    def lane_cost(p):
        return _lane_call(total_cost, p, blocks)

    def retract(p, delta):
        def one(fields, d):
            q = layout.retract(RelaxParams(*fields), d)
            return tuple(getattr(q, f) for f in FIELDS)

        return RelaxParams(*vmap(one)(tuple(getattr(p, f) for f in FIELDS), delta))

    if linear_solver == "cg":
        order = _lane_slot_order(blocks, T)

    cost0 = lane_cost(params)
    p, cost = params, cost0
    lam = torch.as_tensor(init_lambda, dtype=dtype, device=dev).expand(G).clone()
    nu = torch.full((G,), 2.0, dtype=dtype, device=dev)
    done = ~torch.isfinite(cost0)
    iterations = torch.zeros(G, dtype=torch.int32, device=dev)
    it = 0
    while it < max_iterations:
        if (yield done.all()):  # one host sync per iteration
            break
        live = ~done
        if linear_solver == "cg":
            with PerformanceMeasure("lm: linearize"):
                quads = _lane_call(lambda q, b, fr: _quads_all(q, b, fr), p, blocks, free)
                g = _lane_scatter([Jtr for _, Jtr in quads], order, G)
                diag = torch.clamp(_lane_diag(quads, blocks, order, G), 1e-10, 1e32)
            with PerformanceMeasure("lm: linear solve"):
                damp = lam[:, None] * diag + frozen

                def matvec(v):
                    return _lane_matvec(v, quads, blocks, order) + damp * v

                pre_diag = diag + damp
                delta, r_cg = _lane_pcg(matvec, -g, lambda r: r / pre_diag, CG_RTOL, CG_MAX_ITERS, live)
                delta = torch.where(free, delta, 0.0)
                pred = 0.5 * (torch.sum(delta * r_cg, dim=-1) - torch.sum(delta * g, dim=-1))
        else:
            with PerformanceMeasure("lm: linearize"):
                H, g = _lane_call(lambda q, b, fr: normal_equations(q, b, layout, fr), p, blocks, free)
                diag = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), 1e-10, 1e32)
            with PerformanceMeasure("lm: linear solve"):
                A = H + torch.diag_embed(lam[:, None] * diag) + torch.diag_embed(frozen)
                delta = torch.where(free, -_jacobi_solve(A, g), 0.0)
                pred = 0.5 * torch.sum(delta * (lam[:, None] * diag * delta - g), dim=-1)

        with PerformanceMeasure("lm: evaluate"):
            p_new = retract(p, delta)
            new_cost = lane_cost(p_new)
            accept, lam_next, nu_next, done_next = _lm_update(
                cost, new_cost, pred, lam, nu, torch.amax(torch.abs(delta), dim=-1), parameter_tolerance,
                function_tolerance)

            # a lane that was done before this iteration holds its state
            step = live & accept
            p = _params_where(step, p_new, p)
            cost = torch.where(step, new_cost, cost)
            lam = torch.where(live, lam_next, lam)
            nu = torch.where(live, nu_next, nu)
            done = torch.where(live, done_next, done)
            iterations = iterations + live.to(torch.int32)
        it += 1

    return p, SolveInfo(initial_cost=cost0, final_cost=cost, iterations=iterations, final_lambda=lam)
