"""Rotations and footprints in plain numpy, float64."""

from __future__ import annotations

import numpy as np


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton products of [..., 4] (w, x, y, z)."""
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw], -1)


def quat_conj(q: np.ndarray) -> np.ndarray:
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def angle_deg(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Angle in degrees between the rotations of quaternions p and q [..., 4]."""
    p = p / np.linalg.norm(p, axis=-1, keepdims=True)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    c = np.clip(np.abs(np.sum(p * q, axis=-1)), 0.0, 1.0)
    return np.degrees(2.0 * np.arccos(c))


def relative(q_source: np.ndarray, q_dest: np.ndarray) -> np.ndarray:
    """The relative rotation an edge from source to dest holds: dest's
    inverse times source's orientation."""
    return quat_mul(quat_conj(q_dest), q_source)


def mesh_height(vertices: np.ndarray, triangles: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Height of a triangle mesh [V, 3] / [T, 3] at points xy [P, 2] by
    barycentric interpolation in the triangle that holds each point; NaN
    where none does."""
    a, b, c = (vertices[triangles[:, k]] for k in range(3))
    v0, v1 = b[:, :2] - a[:, :2], c[:, :2] - a[:, :2]
    v2 = xy[:, None, :] - a[None, :, :2]
    den = v0[:, 0] * v1[:, 1] - v1[:, 0] * v0[:, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = (v2[..., 0] * v1[:, 1] - v1[:, 0] * v2[..., 1]) / den
        v = (v0[:, 0] * v2[..., 1] - v2[..., 0] * v0[:, 1]) / den
    inside = (u >= -1e-9) & (v >= -1e-9) & (u + v <= 1 + 1e-9)
    z = a[None, :, 2] + u * (b[None, :, 2] - a[None, :, 2]) + v * (c[None, :, 2] - a[None, :, 2])
    first = np.argmax(inside, axis=1)
    rows = np.arange(len(xy))
    return np.where(inside[rows, first], z[rows, first], np.nan)


def relief_height(xy: np.ndarray, amplitude: float, wavelength: float) -> np.ndarray:
    k = 2.0 * np.pi / wavelength
    return amplitude * np.sin(k * xy[..., 0]) * np.cos(k * xy[..., 1])
