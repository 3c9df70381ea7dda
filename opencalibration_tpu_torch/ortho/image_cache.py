"""Thread-safe LRU cache of full-resolution decoded images (copy of
opencalibration_tpu/ortho/image_cache.py; the default loader is the port's
``decode_color``, which reads PPM / PGM without OpenCV).

Re-implements reference src/ortho/image_cache.cpp:12-98: bounded LRU with
condition-variable deduplication of concurrent loads of the same image
(one thread decodes, others wait) — feeding the tiled orthomosaic passes.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np


def default_loader(path: str) -> Optional[np.ndarray]:
    """[H, W, 3] uint8 BGR, or None for an unreadable file."""
    from opencalibration_tpu_torch.extract.image_loader import decode_color

    return decode_color(path)


class FullResolutionImageCache:
    def __init__(self, max_images: int = 16, loader: Callable = default_loader):
        self._max = max_images
        self._loader = loader
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._cache: OrderedDict = OrderedDict()
        self._loading: set = set()
        self.misses = 0
        self.hits = 0

    def get(self, path: str) -> Optional[np.ndarray]:
        with self._cond:
            while True:
                if path in self._cache:
                    self._cache.move_to_end(path)
                    self.hits += 1
                    return self._cache[path]
                if path not in self._loading:
                    self._loading.add(path)
                    self.misses += 1
                    break
                # someone else is decoding this image: wait (dedup)
                self._cond.wait()
        try:
            img = self._loader(path)
        finally:
            with self._cond:
                self._loading.discard(path)
                if img is not None:
                    self._cache[path] = img
                    while len(self._cache) > self._max:
                        self._cache.popitem(last=False)
                self._cond.notify_all()
        return img

    def prefetch(self, paths, pool=None):
        """Asynchronously warm the cache (the reference's std::async
        prefetch of the next tile's images, ortho.cpp:1521-1545)."""
        import concurrent.futures

        own_pool = pool is None
        if own_pool:
            pool = concurrent.futures.ThreadPoolExecutor(max_workers=4)
        futures = [pool.submit(self.get, p) for p in paths]
        if own_pool:
            pool.shutdown(wait=False)
        return futures

    def clear(self):
        with self._lock:
            self._cache.clear()
