"""Parameter store and tangent-space layout for bundle adjustment (twin of
opencalibration_tpu/relax/tangent.py).

One flat tangent vector covers every optimisable quantity: rotations as
3-dof increments retracted with q * exp(delta), everything else additive,
and freezing as a boolean mask over tangent entries.

Layout (offsets in the tangent vector):
  [C*3 rotations][V mesh_z][P*3 points][M focal][M*2 principal]
  [M*3 radial][M*2 tangential]
"""

from __future__ import annotations

import dataclasses

import torch

from opencalibration_tpu_torch.ops.quaternion import quat_boxplus, quat_normalize

FOCAL_LOWER = 100.0
FOCAL_UPPER = 20000.0

FIELDS = ("quats", "positions", "mesh_z", "points", "focal", "principal", "radial", "tangential")


@dataclasses.dataclass(frozen=True)
class RelaxParams:
    """All optimisable state of one relax problem. positions are carried,
    never optimised."""

    quats: torch.Tensor  # [C, 4]
    positions: torch.Tensor  # [C, 3]
    mesh_z: torch.Tensor  # [V]
    points: torch.Tensor  # [P, 3]
    focal: torch.Tensor  # [M]
    principal: torch.Tensor  # [M, 2]
    radial: torch.Tensor  # [M, 3]
    tangential: torch.Tensor  # [M, 2]

    @property
    def C(self):
        return self.quats.shape[0]

    @property
    def V(self):
        return self.mesh_z.shape[0]

    @property
    def P(self):
        return self.points.shape[0]

    @property
    def M(self):
        return self.focal.shape[0]

    @staticmethod
    def create(quats, positions, mesh_z=None, points=None, focal=None,
               principal=None, radial=None, tangential=None, dtype=None):
        """Tensors land on ``quats``' device; missing fields are empty or
        zero (one intrinsics model)."""
        quats = torch.as_tensor(quats)
        dtype = dtype or quats.dtype
        dev = quats.device

        def arr(x, shape):
            if x is None:
                return torch.zeros(shape, dtype=dtype, device=dev)
            return torch.as_tensor(x, dtype=dtype, device=dev)

        M = 1 if focal is None else torch.as_tensor(focal).shape[0]
        return RelaxParams(
            quats=quats.to(dtype),
            positions=arr(positions, (quats.shape[0], 3)),
            mesh_z=arr(mesh_z, (0,)),
            points=arr(points, (0, 3)),
            focal=arr(focal, (M,)),
            principal=arr(principal, (M, 2)),
            radial=arr(radial, (M, 3)),
            tangential=arr(tangential, (M, 2)),
        )

    def where(self, cond, other: "RelaxParams") -> "RelaxParams":
        """Field-wise ``other if cond else self`` for a 0-d bool tensor."""
        return RelaxParams(
            **{f: torch.where(cond, getattr(other, f), getattr(self, f)) for f in FIELDS}
        )


class TangentLayout:
    """Slot arithmetic for the flat tangent vector (plain ints)."""

    def __init__(self, C: int, V: int, P: int, M: int):
        self.C, self.V, self.P, self.M = C, V, P, M
        self.rot_off = 0
        self.mesh_off = self.rot_off + 3 * C
        self.point_off = self.mesh_off + V
        self.focal_off = self.point_off + 3 * P
        self.principal_off = self.focal_off + M
        self.radial_off = self.principal_off + 2 * M
        self.tangential_off = self.radial_off + 3 * M
        self.dim = self.tangential_off + 2 * M

    # --- slot helpers: index tensors on the ids' device ---
    def rot_slots(self, cam_idx):
        return self.rot_off + 3 * cam_idx[..., None] + torch.arange(3, device=cam_idx.device)

    def mesh_slot(self, v_idx):
        return self.mesh_off + v_idx[..., None]

    def point_slots(self, p_idx):
        return self.point_off + 3 * p_idx[..., None] + torch.arange(3, device=p_idx.device)

    def focal_slot(self, m_idx):
        return self.focal_off + m_idx[..., None]

    def principal_slots(self, m_idx):
        return self.principal_off + 2 * m_idx[..., None] + torch.arange(2, device=m_idx.device)

    def radial_slots(self, m_idx):
        return self.radial_off + 3 * m_idx[..., None] + torch.arange(3, device=m_idx.device)

    def tangential_slots(self, m_idx):
        return self.tangential_off + 2 * m_idx[..., None] + torch.arange(2, device=m_idx.device)

    # --- retraction ---
    def retract(self, p: RelaxParams, delta) -> RelaxParams:
        """Full tangent step: boxplus on rotations, additive elsewhere, focal
        projected into its bounds."""
        C, V, P, M = self.C, self.V, self.P, self.M
        d_rot = delta[self.rot_off : self.rot_off + 3 * C].reshape(C, 3)
        return dataclasses.replace(
            p,
            quats=quat_normalize(quat_boxplus(p.quats, d_rot)),
            mesh_z=p.mesh_z + delta[self.mesh_off : self.mesh_off + V],
            points=p.points + delta[self.point_off : self.point_off + 3 * P].reshape(P, 3),
            focal=torch.clamp(
                p.focal + delta[self.focal_off : self.focal_off + M], FOCAL_LOWER, FOCAL_UPPER
            ),
            principal=p.principal
            + delta[self.principal_off : self.principal_off + 2 * M].reshape(M, 2),
            radial=p.radial + delta[self.radial_off : self.radial_off + 3 * M].reshape(M, 3),
            tangential=p.tangential
            + delta[self.tangential_off : self.tangential_off + 2 * M].reshape(M, 2),
        )

    # --- free/frozen masks ---
    def build_free_mask(
        self,
        rot_free=None,  # [C] bool
        mesh_free=False,
        points_free=False,
        focal_free: bool = False,
        principal_free: bool = False,
        radial_tiers=0,  # 0 frozen, 1 k1, 2 k1k2, 3 all
        tangential_free: bool = False,
        *,
        device,
    ):
        """Tangent mask [dim] bool: True = optimised."""
        C, V, P, M = self.C, self.V, self.P, self.M

        def full(shape, value):
            return torch.broadcast_to(torch.as_tensor(value, dtype=torch.bool, device=device), shape)

        rot = full((C, 3), True) if rot_free is None else full((C, 3), torch.as_tensor(rot_free)[:, None])
        rad = full((M, 3), torch.arange(3) < radial_tiers)
        parts = [
            rot, full((V,), mesh_free), full((P, 3), points_free), full((M,), focal_free),
            full((M, 2), principal_free), rad, full((M, 2), tangential_free),
        ]
        return torch.cat([x.reshape(-1) for x in parts])
