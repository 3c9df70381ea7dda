"""Cache-aware tile ordering for orthomosaic generation.

Re-implements reference src/tile_ordering/tile_ordering.cpp:47-267 and the
Hilbert curve of types/hilbert.hpp: given the set of cameras each tile
samples, pick a processing order minimizing full-resolution image cache
misses — a greedy LRU-simulated search with continuity tie-breaks,
compared against the Hilbert-curve order; whichever simulates fewer
misses wins.

Host-side: this is pure scheduling for the IO pipeline that feeds the
device (the reference's async prefetch maps to our host prefetch threads).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Set, Tuple


def hilbert_xy2d(order: int, x: int, y: int) -> int:
    """Hilbert curve index (reference types/hilbert.hpp:8-27)."""
    d = 0
    s = order // 2
    while s > 0:
        rx = 1 if (x & s) > 0 else 0
        ry = 1 if (y & s) > 0 else 0
        d += s * s * ((3 * rx) ^ ry)
        if ry == 0:
            if rx == 1:
                x = s - 1 - x
                y = s - 1 - y
            x, y = y, x
        s //= 2
    return d


def hilbert_tile_order(num_tiles_x: int, num_tiles_y: int) -> List[Tuple[int, int]]:
    order = 1
    while order < max(num_tiles_x, num_tiles_y):
        order *= 2
    tiles = [
        (hilbert_xy2d(order, tx, ty), (tx, ty))
        for ty in range(num_tiles_y)
        for tx in range(num_tiles_x)
    ]
    tiles.sort()
    return [t[1] for t in tiles]


class _LRU:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.entries: OrderedDict = OrderedDict()

    def contains(self, key) -> bool:
        return key in self.entries

    def touch(self, key):
        if key in self.entries:
            self.entries.move_to_end(key)
        else:
            self.entries[key] = True
            if len(self.entries) > self.capacity:
                self.entries.popitem(last=False)


def simulate_cache_misses(
    tile_order: Sequence[Tuple[int, int]],
    tile_cameras: Dict[int, Set[int]],
    num_tiles_x: int,
    cache_size: int,
) -> int:
    cache = _LRU(cache_size)
    misses = 0
    for tx, ty in tile_order:
        cams = tile_cameras.get(ty * num_tiles_x + tx)
        if not cams:
            continue
        for cam in sorted(cams):
            if not cache.contains(cam):
                misses += 1
            cache.touch(cam)
    return misses


def _cache_aware_search(
    tile_cameras: Dict[int, Set[int]],
    num_tiles_x: int,
    num_tiles_y: int,
    cache_size: int,
):
    total = num_tiles_x * num_tiles_y
    covered = [
        i for i in range(total) if tile_cameras.get(i)
    ]
    uncovered = [i for i in range(total) if not tile_cameras.get(i)]
    if not covered:
        return [(i % num_tiles_x, i // num_tiles_x) for i in uncovered], 0

    camera_to_tiles: Dict[int, List[int]] = {}
    for i in covered:
        for cam in tile_cameras[i]:
            camera_to_tiles.setdefault(cam, []).append(i)

    start = max(covered, key=lambda i: (len(tile_cameras[i]), -i))
    cache = _LRU(cache_size)
    visited = [False] * total
    order: List[int] = []
    misses = 0
    last_cams: Set[int] = set()

    def visit(i):
        nonlocal misses, last_cams
        visited[i] = True
        order.append(i)
        cams = tile_cameras.get(i, set())
        last_cams = set(cams)
        for cam in sorted(cams):
            if not cache.contains(cam):
                misses += 1
            cache.touch(cam)

    visit(start)
    n_covered = len(covered)
    while len(order) < n_covered:
        neighborhood = set()
        for cam in cache.entries:
            for i in camera_to_tiles.get(cam, ()):
                if not visited[i]:
                    neighborhood.add(i)
        best = None
        if neighborhood:
            best_misses, best_cont = None, -1
            for i in sorted(neighborhood):
                cams = tile_cameras[i]
                m = sum(1 for c in cams if not cache.contains(c))
                cont = len(cams & last_cams)
                if best_misses is None or m < best_misses or (
                    m == best_misses and cont > best_cont
                ):
                    best_misses, best_cont, best = m, cont, i
        if best is None:
            remaining = [i for i in covered if not visited[i]]
            best = max(remaining, key=lambda i: (len(tile_cameras[i]), -i))
        visit(best)

    result = [(i % num_tiles_x, i // num_tiles_x) for i in order]
    result += [(i % num_tiles_x, i // num_tiles_x) for i in uncovered]
    return result, misses


def compute_cache_aware_tile_order(
    tile_cameras: Dict[int, Set[int]],
    num_tiles_x: int,
    num_tiles_y: int,
    cache_size: int = 16,
) -> List[Tuple[int, int]]:
    if num_tiles_x * num_tiles_y == 0:
        return []
    greedy, greedy_misses = _cache_aware_search(
        tile_cameras, num_tiles_x, num_tiles_y, cache_size
    )
    hilbert = hilbert_tile_order(num_tiles_x, num_tiles_y)
    hilbert_misses = simulate_cache_misses(
        hilbert, tile_cameras, num_tiles_x, cache_size
    )
    return greedy if greedy_misses <= hilbert_misses else hilbert
