"""Quaternion algebra, (w, x, y, z) order (twin of
opencalibration_tpu/ops/quaternion.py).

Every function broadcasts over leading batch dimensions and works under
``torch.func.vmap`` / ``torch.func.jacfwd``. Vector norms are written as
``sqrt(sum(x * x))``, the form the reference's ``jnp.linalg.norm`` takes, so
the two agree to rounding and differentiate alike.
"""

from __future__ import annotations

import torch


def _norm(x, keepdim=False):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def quat_identity(dtype=torch.float32, *, device):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q, eps=1e-30):
    return q / torch.clamp_min(_norm(q, keepdim=True), eps)


def quat_conjugate(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_inverse(q):
    """Inverse of a (not necessarily unit) quaternion."""
    return quat_conjugate(q) / torch.clamp_min(torch.sum(q * q, dim=-1, keepdim=True), 1e-30)


def quat_multiply(a, b):
    """Hamilton product a*b."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def _cross(a, b):
    """a x b over the last dim, written out: ``torch.linalg.cross`` fails
    under ``torch.func.jacfwd`` when only one operand carries a tangent."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def quat_rotate(q, v):
    """Rotate v by unit q: v + 2*w*(u x v) + 2*(u x (u x v)), u = q.xyz."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = _cross(u, v)
    uuv = _cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_rotate_inverse(q, v):
    """Rotate v by the conjugate (inverse for unit q) of q."""
    return quat_rotate(quat_conjugate(q), v)


def quat_from_axis_angle(axis, angle):
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    axis = axis / torch.clamp_min(_norm(axis, keepdim=True), 1e-30)
    half = 0.5 * angle
    s = torch.sin(half)
    w = torch.cos(half)
    return torch.cat([w[..., None], axis * s[..., None]], dim=-1)


def quat_exp(v):
    """Exponential map: tangent 3-vector -> unit quaternion; safe at v = 0."""
    theta2 = torch.sum(v * v, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp_min(theta2, 1e-30))
    half = 0.5 * theta
    # sin(t/2)/t with the series 0.5 - t^2/48 near zero
    small = theta2 < 1e-12
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    # w keeps its trailing dim: under jacfwd, torch.where on 0-d float32
    # operands gives a float64 tangent
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w, v * k], dim=-1)


def quat_log(q):
    """Log map: unit quaternion -> tangent 3-vector (inverse of quat_exp)."""
    q = quat_normalize(q)
    # w >= 0 for the short geodesic
    q = q * torch.sign(torch.where(q[..., :1] == 0, 1.0, q[..., :1]))
    vn = _norm(q[..., 1:], keepdim=True)
    w = q[..., :1]
    angle = 2.0 * torch.atan2(vn, w)
    small = vn[..., 0] < 1e-12
    k = torch.where(
        small[..., None], 2.0 / torch.clamp_min(w, 1e-30), angle / torch.clamp_min(vn, 1e-30)
    )
    return q[..., 1:] * k


def quat_angle(q):
    """Rotation angle in [0, pi] represented by q."""
    # trailing dim kept until the end: under jacfwd, atan2 of 0-d float32
    # operands gives a float64 tangent
    vn = _norm(q[..., 1:], keepdim=True)
    return (2.0 * torch.atan2(vn, torch.abs(q[..., :1])))[..., 0]


def quat_to_matrix(q):
    """Unit quaternion -> 3x3 rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_matrix(m):
    """Rotation matrix -> unit quaternion, branch-free Shepperd: all four
    candidates are formed and the one keyed by the largest diagonal
    combination is kept."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    def cand(parts, t):
        return torch.stack(parts, dim=-1) / (2.0 * torch.sqrt(torch.clamp_min(t, 1e-30)))[..., None]

    qw = cand([tw, m21 - m12, m02 - m20, m10 - m01], tw)
    qx = cand([m21 - m12, tx, m01 + m10, m02 + m20], tx)
    qy = cand([m02 - m20, m01 + m10, ty, m12 + m21], ty)
    qz = cand([m10 - m01, m02 + m20, m12 + m21, tz], tz)

    best = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4 candidates, 4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = quat_normalize(torch.take_along_dim(cands, idx, dim=-2)[..., 0, :])
    # canonical sign: w >= 0
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_boxplus(q, delta):
    """Manifold retraction q (+) delta = q * exp(delta)."""
    return quat_multiply(q, quat_exp(delta))


def angle_between_unit_vectors(n1, n2):
    """Angle between unit vectors as atan2(|n1 x n2|, n1.n2)."""
    d = torch.sum(n1 * n2, dim=-1)
    c = _cross(n1, n2)
    s = torch.sqrt(torch.clamp_min(torch.sum(c * c, dim=-1), 1e-30))
    return torch.atan2(s, d)
