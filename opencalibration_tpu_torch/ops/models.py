"""Two-view models: homography, essential, fundamental (twin of
opencalibration_tpu/ops/models.py).

Functions take homogeneous-normalised 2-d points (x/z, y/z of unit rays) and
broadcast over leading dims, so a batch of pairs and of hypotheses is one
call. The epipolar fits use the reference's self-consistent convention
x2h^T M x1h = 0 for both the fit and the error. An eigenvector's sign is the
solver's choice, so an epipolar model equals the reference's up to sign.
"""

from __future__ import annotations

import itertools

import torch

from opencalibration_tpu_torch.ops.quaternion import quat_from_matrix

HOMOGRAPHY_MIN_POINTS = 4
ESSENTIAL_MIN_POINTS = 5
FUNDAMENTAL_MIN_POINTS = 8
HOMOGRAPHY_INLIER_THRESHOLD = 0.005
ESSENTIAL_INLIER_THRESHOLD = 0.01
FUNDAMENTAL_INLIER_THRESHOLD = 0.01

_BIG = 1e30


def hnormalize(rays):
    """[..., 3] rays -> [..., 2] points (x/z, y/z)."""
    return rays[..., :2] / rays[..., 2:3]


def inv3(A):
    """Closed-form adjugate inverse of [..., 3, 3]; singular input gives
    inf/nan, which scoring maps to _BIG."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c11 = e * i - f * h
    c21 = f * g - d * i
    c31 = d * h - e * g
    det = a * c11 + b * c21 + c * c31
    rows = torch.stack(
        [
            torch.stack([c11, c * h - b * i, b * f - c * e], dim=-1),
            torch.stack([c21, a * i - c * g, c * d - a * f], dim=-1),
            torch.stack([c31, b * g - a * h, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return rows / det[..., None, None]


def _canonical_transform(p):
    """[..., 4, 2] points -> [..., 3, 3] projective map taking the canonical
    basis (e1, e2, e3, [1, 1, 1]) to the 4 points."""
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)  # [..., 4, 3]
    M = ph[..., :3, :].transpose(-1, -2)  # columns p1, p2, p3
    lam = inv3(M) @ ph[..., 3, :, None]  # [..., 3, 1]
    return M * lam[..., 0][..., None, :]


def _homography_rows(p1, p2):
    """DLT rows for x2 ~ H x1 with h33 = 1: [..., 2N, 9], all x-rows then all
    y-rows."""
    x, y = p1[..., 0], p1[..., 1]
    xp, yp = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, x * xp, y * xp, xp], dim=-1)
    r2 = torch.stack([z, z, z, -x, -y, -o, x * yp, y * yp, yp], dim=-1)
    return torch.cat([r1, r2], dim=-2)


def homography_fit(p1, p2):
    """Minimal 4-point homography H = T2 inv(T1) from [..., 4, 2] samples."""
    T1 = _canonical_transform(p1)
    T2 = _canonical_transform(p2)
    H = T2 @ inv3(T1)
    return H / H[..., 2:3, 2:3]


def homography_fit_weighted(p1, p2, w):
    """Weighted least-squares refit over all correspondences [..., N, 2]
    with weights w [..., N] (0 for outliers and padding)."""
    P = _homography_rows(p1, p2)  # [..., 2N, 9]
    ww = torch.cat([w, w], dim=-1)  # rows are [x-rows; y-rows]
    A = (P * ww[..., None]).transpose(-1, -2) @ P  # [..., 9, 9]
    e8 = torch.zeros(9, dtype=P.dtype, device=P.device)
    e8[8] = 1.0
    A = A + torch.outer(e8, e8)
    eye = torch.eye(9, dtype=P.dtype, device=P.device)
    # solve_ex: a singular system gives a non-finite H, which the caller
    # rejects, instead of an exception (and no wait for the device)
    h = torch.linalg.solve_ex(A + 1e-12 * eye, e8.expand(A.shape[:-1]))[0]
    H = h.reshape(h.shape[:-1] + (3, 3))
    return H / H[..., 2:3, 2:3]


def homography_error(H, p1, p2):
    """Symmetric transfer error sqrt((fwd + bwd) / 2); H [..., 3, 3] against
    points [..., N, 2] -> [..., N]."""
    Hinv = inv3(H)
    o = torch.ones_like(p1[..., :1])
    h1 = torch.cat([p1, o], dim=-1)
    h2 = torch.cat([p2, o], dim=-1)
    f = h1 @ H.transpose(-1, -2)
    b = h2 @ Hinv.transpose(-1, -2)
    fwd = torch.sum((f[..., :2] / f[..., 2:3] - p2) ** 2, dim=-1)
    bwd = torch.sum((b[..., :2] / b[..., 2:3] - p1) ** 2, dim=-1)
    e = torch.sqrt(torch.clamp_min(0.5 * (fwd + bwd), 0.0))
    return torch.where(torch.isfinite(e), e, _BIG)


_TRIPLES = list(itertools.combinations(range(4), 3))


def homography_sample_degenerate(p1):
    """True where any 3 of the 4 sample points [..., 4, 2] are collinear."""
    combos = torch.tensor(_TRIPLES, device=p1.device)
    a = p1[..., combos[:, 0], :]
    v1 = p1[..., combos[:, 1], :] - a
    v2 = p1[..., combos[:, 2], :] - a
    cross = v1[..., 0] * v2[..., 1] - v1[..., 1] * v2[..., 0]
    return torch.any(torch.abs(cross) < 1e-10, dim=-1)


_SIGNS = ((1.0, 1.0), (-1.0, -1.0), (1.0, -1.0), (-1.0, 1.0))


def homography_decompose(H):
    """Faugeras-Lustman SVD decomposition of calibrated homographies
    [..., 3, 3] into 4 candidate (R, t, n) each.

    Returns (R [..., 4, 3, 3], t [..., 4, 3], n [..., 4, 3], valid [..., 4]).
    A non-finite H yields NaN candidates; it is swapped for the identity
    before the SVD, because the CPU SVD refuses non-finite input."""
    dtype, dev = H.dtype, H.device
    finite = torch.isfinite(H).all(dim=-1).all(dim=-1)  # [...]
    eye = torch.eye(3, dtype=dtype, device=dev)
    Hs = torch.where(finite[..., None, None], H, eye)
    U, d, Vt = torch.linalg.svd(Hs)
    V = Vt.transpose(-1, -2)
    d1, d2, d3 = d[..., 0, None], d[..., 1, None], d[..., 2, None]  # [..., 1]
    s = (torch.linalg.det(U) * torch.linalg.det(V))[..., None, None, None]

    denom = torch.clamp_min(d1 * d1 - d3 * d3, 1e-30)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, 0.0, 1.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, 0.0, 1.0))
    degenerate = (d1 - d3) < 1e-9 * d1  # conjugate rotation: H / d2 is R, t = 0

    signs = torch.tensor(_SIGNS, dtype=dtype, device=dev)
    e1, e3 = signs[:, 0], signs[:, 1]  # [4]
    sin_t = e1 * e3 * x1 * x3 * (d1 - d3) / d2  # [..., 4]
    cos_t = (d1 * x3 * x3 + d3 * x1 * x1) / d2
    norm = torch.clamp_min(torch.sqrt(sin_t * sin_t + cos_t * cos_t), 1e-30)
    sin_t, cos_t = sin_t / norm, cos_t / norm
    zero = torch.zeros_like(sin_t)
    one = torch.ones_like(sin_t)
    Rp = torch.stack(
        [
            torch.stack([cos_t, zero, -sin_t], dim=-1),
            torch.stack([zero, one, zero], dim=-1),
            torch.stack([sin_t, zero, cos_t], dim=-1),
        ],
        dim=-2,
    )  # [..., 4, 3, 3]
    x1b, x3b = x1.expand_as(sin_t), x3.expand_as(sin_t)
    np_ = torch.stack([e1 * x1b, zero, e3 * x3b], dim=-1)  # [..., 4, 3]
    tp = (d1 - d3)[..., None] * torch.stack([e1 * x1b, zero, -e3 * x3b], dim=-1)
    U4, V4, Vt4 = U[..., None, :, :], V[..., None, :, :], Vt[..., None, :, :]
    R = s * U4 @ Rp @ Vt4
    n = (V4 @ np_[..., None])[..., 0]
    t = (U4 @ tp[..., None])[..., 0]
    # degenerate fallback: pure rotation
    deg = degenerate  # [..., 1] against [..., 4]
    R = torch.where(deg[..., None, None], s * Hs[..., None, :, :] / d2[..., None, None], R)
    t = torch.where(deg[..., None], torch.zeros_like(t), t)
    n = torch.where(deg[..., None], torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev), n)
    # t as a direction when nonzero
    tn = torch.sqrt(torch.sum(t * t, dim=-1, keepdim=True))
    t = torch.where(tn > 1e-12, t / torch.clamp_min(tn, 1e-30), t)

    nan = torch.tensor(torch.nan, dtype=dtype, device=dev)
    ok = finite[..., None]  # [..., 1]
    R = torch.where(ok[..., None, None], R, nan)
    t = torch.where(ok[..., None], t, nan)
    n = torch.where(ok[..., None], n, nan)
    return R, t, n, ok.expand(sin_t.shape)


def score_homography_poses(R, t, n, rays1, rays2, inlier_w):
    """Visibility scores of decomposed poses: inliers with n . m1 >= 0 and
    (R n) . m2 >= 0. R [..., 4, 3, 3], t / n [..., 4, 3], rays [..., N, 3],
    inlier_w [..., N] -> [..., 4]."""
    dot1 = n @ rays1.transpose(-1, -2)  # [..., 4, N]
    Rn = (R @ n[..., None])[..., 0]
    dot2 = Rn @ rays2.transpose(-1, -2)
    ok = (dot1 >= 0) & (dot2 >= 0)
    return torch.sum(ok * inlier_w[..., None, :], dim=-1)


def poses_to_quaternions(R):
    """[..., 3, 3] -> [..., 4] (w, x, y, z) quaternions."""
    return quat_from_matrix(R)


# ---------------------------------------------------------------------------
# Epipolar models (essential / fundamental)
# ---------------------------------------------------------------------------


def _epipolar_rows(p1, p2):
    """Rows a with a . vec(M) = x2h^T M x1h, vec row-major: [..., N, 9]."""
    x, y = p1[..., 0], p1[..., 1]
    xp, yp = p2[..., 0], p2[..., 1]
    return torch.stack([xp * x, xp * y, xp, yp * x, yp * y, yp, x, y, torch.ones_like(x)], dim=-1)


def _finite_or_eye(A):
    """(A with non-finite matrices replaced by the identity, finite mask):
    the CPU eigen and singular value solvers refuse non-finite input."""
    finite = torch.isfinite(A).all(dim=-1).all(dim=-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.where(finite[..., None, None], A, eye), finite


def _smallest_eigvec_9(AtA):
    """Eigenvector of the smallest eigenvalue of symmetric [..., 9, 9]; NaN
    where the input is not finite."""
    A, finite = _finite_or_eye(AtA)
    v = torch.linalg.eigh(A)[1][..., :, 0]
    return torch.where(finite[..., None], v, torch.nan)


def _svd3(m):
    """SVD of [..., 3, 3]; NaN factors where the input is not finite."""
    A, finite = _finite_or_eye(m)
    U, d, Vt = torch.linalg.svd(A)
    ok = finite[..., None]
    return (torch.where(ok[..., None], U, torch.nan), torch.where(ok, d, torch.nan),
            torch.where(ok[..., None], Vt, torch.nan))


def _fit_epipolar(p1, p2, w, rank2_average: bool):
    """Weighted algebraic fit [..., N, 2] / w [..., N], projected onto the
    model's manifold: the two leading singular values averaged (essential)
    or only the last zeroed (fundamental)."""
    A = _epipolar_rows(p1, p2)
    AtA = (A * w[..., None]).transpose(-1, -2) @ A
    m = _smallest_eigvec_9(AtA).reshape(AtA.shape[:-2] + (3, 3))
    Um, dm, Vmt = _svd3(m)
    if rank2_average:
        avg = 0.5 * (dm[..., 0] + dm[..., 1])
        dnew = torch.stack([avg, avg, torch.zeros_like(avg)], dim=-1)
    else:
        dnew = torch.cat([dm[..., :2], torch.zeros_like(dm[..., 2:])], dim=-1)
    return (Um * dnew[..., None, :]) @ Vmt


def essential_fit(p1, p2):
    return _fit_epipolar(p1, p2, torch.ones_like(p1[..., 0]), rank2_average=True)


def essential_fit_weighted(p1, p2, w):
    return _fit_epipolar(p1, p2, w, rank2_average=True)


def fundamental_fit(p1, p2):
    return _fit_epipolar(p1, p2, torch.ones_like(p1[..., 0]), rank2_average=False)


def fundamental_fit_weighted(p1, p2, w):
    return _fit_epipolar(p1, p2, w, rank2_average=False)


def epipolar_error(M, p1, p2):
    """Sampson-style epipolar distance of points [..., N, 2] under M
    [..., 3, 3] -> [..., N]."""
    o = torch.ones_like(p1[..., :1])
    x1 = torch.cat([p1, o], dim=-1)
    x2 = torch.cat([p2, o], dim=-1)
    Mx1 = x1 @ M.transpose(-1, -2)
    Mtx2 = x2 @ M
    num = torch.sum(x2 * Mx1, dim=-1)
    denom = Mx1[..., 0] ** 2 + Mx1[..., 1] ** 2 + Mtx2[..., 0] ** 2 + Mtx2[..., 1] ** 2
    e = torch.sqrt(num * num / torch.clamp_min(denom, 1e-20))
    e = torch.where(denom < 1e-20, _BIG, e)
    return torch.where(torch.isfinite(e), e, _BIG)


def essential_decompose(E):
    """SVD decomposition of [..., 3, 3] into 4 (R, t) candidates:
    (R [..., 4, 3, 3], t [..., 4, 3])."""
    U, _, Vt = _svd3(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.transpose(-1, -2) @ Vt
    R1 = torch.where((torch.linalg.det(R1) < 0)[..., None, None], -R1, R1)
    R2 = torch.where((torch.linalg.det(R2) < 0)[..., None, None], -R2, R2)
    t = U[..., :, 2]
    return torch.stack([R1, R1, R2, R2], dim=-3), torch.stack([t, -t, t, -t], dim=-2)
