"""Masked Levenberg-Marquardt over dense normal equations (twin of the
Cholesky path of opencalibration_tpu/relax/lm.py).

Each residual family is mapped over its instances with ``torch.func.vmap``;
``torch.func.jacfwd`` gives every instance's local Jacobian at delta = 0; the
L x L normal-equation pieces are summed into a dense [T, T] system by a
one-hot product (a fixed-order sum: ``index_add_`` on the card uses atomics
and would change the sum from run to run), which one dense solve per
iteration answers. Robust losses use the IRLS form: residual and Jacobian
scaled by sqrt(rho'(s)), cost summed with the true rho.

The loop is a Python loop that reads one ``done`` flag from the device per
iteration. The matrix-free CG path for large tangent spaces is not ported
yet; ``solve`` refuses problems of that size.
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
# the reference switches to its matrix-free CG solver at this tangent dim
CG_DIM_THRESHOLD = 1024
_ASSEMBLE_CHUNK = 2048  # instances per one-hot assembly chunk


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


def solve(
    params: RelaxParams,
    blocks: Sequence[BlockSpec],
    layout: TangentLayout,
    free_mask,
    max_iterations: int = DEFAULT_MAX_ITERATIONS,
    init_lambda=1.0,
    parameter_tolerance: float = 1e-8,
    function_tolerance: float = 1e-6,
):
    """Run LM to convergence on the dense path. Returns (params, SolveInfo).

    Same gain-ratio acceptance, Nielsen damping schedule and stop tests as
    the reference. Products and solves run in full float32 (TF32 off): the
    normal equations mix rotation and focal scales."""
    if layout.dim >= CG_DIM_THRESHOLD:
        raise NotImplementedError(
            f"tangent dim {layout.dim} needs the matrix-free CG solver, not ported yet"
        )
    with full_fp32():
        return _solve_impl(
            params, tuple(blocks), layout, free_mask, max_iterations, init_lambda,
            parameter_tolerance, function_tolerance,
        )


def _solve_impl(params, blocks, layout, free_mask, max_iterations, init_lambda,
                parameter_tolerance, function_tolerance):
    dtype, dev = params.quats.dtype, params.quats.device
    free = torch.as_tensor(free_mask, device=dev)
    frozen = (~free).to(dtype)

    def scalar(x):
        return torch.tensor(x, dtype=dtype, device=dev)

    cost0 = total_cost(params, blocks)
    p, lam, nu, cost = params, scalar(init_lambda), scalar(2.0), cost0
    done = ~torch.isfinite(cost0)
    it = 0
    while it < max_iterations and not bool(done):  # one host sync per iteration
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
