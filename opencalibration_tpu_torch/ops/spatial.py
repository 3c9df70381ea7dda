"""Spatial feature selection (twin of opencalibration_tpu/ops/spatial.py).

* ``spatial_subsample`` keeps the strongest valid feature of each
  ``spacing`` x ``spacing`` grid cell (the link stage's 40 px subset);
* ``nms_radius`` keeps a feature iff no stronger one lies within ``radius``,
  checked against the best feature of each of the 3 x 3 neighbouring cells
  (the load stage's radius-8 sparse split);
* ``top_k_by_strength`` takes the k strongest valid features.

Every function takes optional leading batch dims. The selection key is
``strength * (n + 1) - index`` in float64, as in the reference: exact and
unique per valid feature, so equal strengths go to the lower index. It stays
float64 on every device; ``n`` is the padded feature count the caller passes,
which takes part in the key.
"""

from __future__ import annotations

import torch


def _cell_ids(xy, spacing, n_cells_x: int, n_cells_y: int):
    cx = torch.clamp((xy[..., 0] / spacing).to(torch.int32), 0, n_cells_x - 1)
    cy = torch.clamp((xy[..., 1] / spacing).to(torch.int32), 0, n_cells_y - 1)
    return (cy * n_cells_x + cx).to(torch.int64)


def _key(strength, valid):
    """float64 strength * (n + 1) - index; -inf for invalid features."""
    n = strength.shape[-1]
    idx = torch.arange(n, dtype=torch.float64, device=strength.device)
    s = torch.where(valid, strength.to(torch.float64), -torch.inf)
    return s * float(n + 1) - idx


def _segment_max(values, segments, num_segments: int):
    """Max of ``values`` per segment id over the last dim; -inf where empty."""
    out = torch.full(
        values.shape[:-1] + (num_segments,), -torch.inf, dtype=values.dtype, device=values.device
    )
    return out.scatter_reduce(-1, segments, values, "amax", include_self=False)


def spatial_subsample(xy, strength, valid, spacing: float, n_cells_x: int, n_cells_y: int):
    """Keep the strongest valid feature per grid cell.

    xy [..., N, 2], strength [..., N], valid [..., N] bool; ``spacing`` is
    the cell size in pixels. Returns keep [..., N] bool."""
    cells = _cell_ids(xy, spacing, n_cells_x, n_cells_y)
    key = _key(strength, valid)
    cell_max = _segment_max(key, cells, n_cells_x * n_cells_y)
    return valid & (key == torch.gather(cell_max, -1, cells))


def nms_radius(xy, strength, valid, radius: float, n_cells_x: int, n_cells_y: int):
    """Radius non-maximum suppression on a grid of ``radius``-sized cells.

    A feature survives iff no strictly better feature lies within ``radius``
    pixels; every candidate within the radius lives in the 3 x 3 cell
    neighbourhood, whose per-cell best features are checked by exact
    distance. Shapes as ``spatial_subsample``."""
    num_cells = n_cells_x * n_cells_y
    cells = _cell_ids(xy, radius, n_cells_x, n_cells_y)
    key = _key(strength, valid)
    cell_best = _segment_max(key, cells, num_cells)
    is_cell_best = key == torch.gather(cell_best, -1, cells)
    # coordinates of each cell's best feature
    bx = _segment_max(torch.where(is_cell_best, xy[..., 0], -torch.inf), cells, num_cells)
    by = _segment_max(torch.where(is_cell_best, xy[..., 1], -torch.inf), cells, num_cells)

    cx = cells % n_cells_x
    cy = cells // n_cells_x
    survives = valid
    r2 = radius * radius
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nx = torch.clamp(cx + dx, 0, n_cells_x - 1)
            ny = torch.clamp(cy + dy, 0, n_cells_y - 1)
            ncell = ny * n_cells_x + nx
            nkey = torch.gather(cell_best, -1, ncell)
            best_xy = torch.stack([torch.gather(bx, -1, ncell), torch.gather(by, -1, ncell)], dim=-1)
            dxy = xy - best_xy
            within = torch.sum(dxy * dxy, dim=-1) <= r2
            better = nkey > key
            survives = survives & ~(within & better & torch.isfinite(nkey))
    return survives


def top_k_by_strength(strength, valid, k: int):
    """Indices of the k strongest valid features, equal strengths by lower
    index. Returns (indices [..., k] int32, mask [..., k]); the mask is
    False where fewer than k features are valid."""
    s = torch.where(valid, strength, -torch.inf)
    order = torch.argsort(-s, dim=-1, stable=True)[..., :k]
    return order.to(torch.int32), torch.isfinite(torch.gather(s, -1, order))
