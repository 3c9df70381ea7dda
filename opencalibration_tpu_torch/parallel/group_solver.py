"""Solve the relax groups of one stage (the per-group part of
opencalibration_tpu/parallel/group_solver.py).

The reference pads every group to one tangent layout and solves all of them
in one vmapped dispatch. The port's LM reads a ``done`` flag on the host
every iteration, so here the groups are solved one after another on the
device, each in its own layout. The reference's padded slots are frozen and
carry no residuals, so each group's answer does not depend on the padding.
The choice between the dense and the matrix-free solver does depend on it:
the reference routes by the padded batch layout, and so does the port
(``batch_layout``). Solving the groups as one batch, and the
shared-intrinsics solver, are later work (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.relax import lm
from opencalibration_tpu_torch.relax.problem_builder import BuiltProblem, _bucket
from opencalibration_tpu_torch.relax.tangent import RelaxParams, TangentLayout

# a warm-started damping is clipped into this range: a converged solve
# leaves lambda at its floor, from which a moved problem would climb long
WARM_LAMBDA_RANGE = (1e-6, 1e2)


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
