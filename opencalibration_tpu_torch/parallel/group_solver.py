"""Solve the relax groups of one stage (the per-group part of
opencalibration_tpu/parallel/group_solver.py).

The reference pads every group to one tangent layout and solves all of them
in one vmapped dispatch. The port's LM reads a ``done`` flag on the host
every iteration, so here the groups are solved one after another on the
device, each in its own layout. The reference's padded slots are frozen and
carry no residuals, so each group's answer does not depend on the padding.
Solving the groups as one batch, and the shared-intrinsics solver, are
later work (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from opencalibration_tpu_torch import interop
from opencalibration_tpu_torch.relax import lm
from opencalibration_tpu_torch.relax.problem_builder import BuiltProblem
from opencalibration_tpu_torch.relax.tangent import RelaxParams


def solve_groups(builts: Sequence[BuiltProblem], pre_solve: bool) -> Tuple[List[RelaxParams], List[lm.SolveInfo]]:
    """Solve every built problem: the surface-only pre-solve first when
    ``pre_solve``, then the full solve, both from lambda = 1 with the LM's
    default iteration cap. Returns the
    solved parameters (host numpy) and the full solves' infos."""
    solved, infos = [], []
    for b in builts:
        params = b.params
        if pre_solve:
            params, _ = lm.solve(params, b.blocks, b.layout, b.surface_free_mask)
        params, info = lm.solve(params, b.blocks, b.layout, b.free_mask)
        solved.append(RelaxParams(**interop.relax_params_to_numpy(params)))
        infos.append(info)
    return solved, infos
