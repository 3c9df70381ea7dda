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
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.func import jacfwd, vmap

from opencalibration_tpu_torch.relax.blocks import BlockSpec
from opencalibration_tpu_torch.relax.tangent import RelaxParams, TangentLayout
from opencalibration_tpu_torch.utils.device import full_fp32

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
        O = F.one_hot(sl, T).to(JtJ.dtype)
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


def _pcg(matvec, b, pre_apply, rtol, max_iters):
    """Preconditioned CG from x0 = 0 (pre_apply: r -> M^-1 r). Returns
    (x, r_final).

    Every iteration evaluates the reference's loop condition on the device
    and keeps the old state where it is false, so the state is frozen from
    the first stop on; the host reads the condition only every
    ``_CG_CHECK_EVERY`` iterations to leave the loop early."""
    tol2 = (rtol * rtol) * torch.clamp_min(torch.sum(b * b), 1e-38)
    z0 = pre_apply(b)
    x, r, p = torch.zeros_like(b), b, z0
    rz = torch.sum(b * z0)
    done = torch.sum(b * b) <= 0.0  # zero right-hand side
    for k in range(max_iters):
        active = (~done) & (torch.sum(r * r) > tol2)
        if k and k % _CG_CHECK_EVERY == 0 and not bool(active):
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
    on a singular system: the non-finite step is rejected by the caller."""
    s = torch.rsqrt(torch.clamp(torch.diagonal(A), 1e-24, 1e32))
    As = A * s[:, None] * s[None, :]
    return s * torch.linalg.solve_ex(As, s * b)[0]


@dataclasses.dataclass(frozen=True)
class SolveInfo:
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: torch.Tensor
    final_lambda: torch.Tensor  # damping at exit, to warm-start a repeat solve


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
    with full_fp32():
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
    while it < max_iterations and not bool(done):  # one host sync per iteration
        if linear_solver == "cg":
            quads = _quads_all(p, blocks, free)
            g = _gn_grad(quads, blocks, order)
            diag = torch.clamp(_gn_diag(quads, blocks, order), 1e-10, 1e32)
            # A = H + lam diag(H) + I_frozen, applied matrix-free
            damp = lam * diag + frozen

            def matvec(v):
                return _gn_matvec(v, quads, blocks, order) + damp * v

            if cg_precond == "block":
                pre_apply = _bj_build(quads, layout, damp, diag, bj_order)
            else:
                pre_diag = diag + damp
                pre_apply = lambda r: r / pre_diag  # noqa: E731
            delta, r_cg = _pcg(matvec, -g, pre_apply, CG_RTOL, CG_MAX_ITERS)
            delta = torch.where(free, delta, 0.0)
            # inexact step: A delta = -g - r  =>  pred = 0.5 (delta.r - delta.g)
            pred = 0.5 * (torch.sum(delta * r_cg) - torch.sum(delta * g))
        else:
            H, g = normal_equations(p, blocks, layout, free)
            diag = torch.clamp(torch.diagonal(H), 1e-10, 1e32)
            # frozen slots: unit diagonal keeps the system SPD, zero gradient
            A = H + lam * torch.diag(diag) + torch.diag(frozen)
            delta = torch.where(free, -_jacobi_solve(A, g), 0.0)
            # gain ratio: actual decrease over the damped model's prediction,
            # (H + lam D) delta = -g  =>  pred = 0.5 delta^T (lam D delta - g)
            pred = 0.5 * torch.sum(delta * (lam * diag * delta - g))

        p_new = layout.retract(p, delta)
        new_cost = total_cost(p_new, blocks)
        rho = (cost - new_cost) / torch.clamp_min(pred, 1e-30)
        accept = torch.isfinite(new_cost) & (new_cost < cost) & (pred > 0)

        p = p.where(accept, p_new)
        cost_next = torch.where(accept, new_cost, cost)
        # Nielsen: a good model (rho ~ 1) cuts lambda up to 3x, a poor one
        # barely; consecutive rejects escalate geometrically
        shrink = torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
        lam = torch.where(
            accept,
            torch.clamp(lam * shrink, 1e-12, 1e12),
            torch.clamp_max(lam * nu, 1e12),
        )
        nu = torch.where(accept, scalar(2.0), torch.clamp_max(nu * 2.0, 1e6))

        step_small = torch.max(torch.abs(delta)) < parameter_tolerance
        cost_flat = accept & (
            (cost - new_cost) < function_tolerance * torch.clamp_min(cost, 1e-30)
        )
        done = step_small | cost_flat | (lam > 1e10)
        cost = cost_next
        it += 1

    return p, SolveInfo(
        initial_cost=cost0, final_cost=cost, iterations=torch.tensor(it, dtype=torch.int32),
        final_lambda=lam,
    )
