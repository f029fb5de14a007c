"""Threaded image prefetch: `LazyImageList`.

Port of dogs_tpu/data/reader.py's `LazyImageList` (its `ImageReader` has no
caller in either package and is not ported). A pool of loader threads
decodes images ahead of the training loop (the JPEG decoder and the PNG
reader's zlib and row filters run in C and release the interpreter lock, so
the threads decode in parallel). `LazyImageList` is the trainer's
`images` sequence on real datasets: images stay on disk and stream through
the threads, `hint(order)` starts the next epoch's decodes, and the numpy
images it hands out go to the trainer's device cache.
"""

from __future__ import annotations

import threading

import numpy as np

from dogs_tpu_torch.data.dataset import CameraRecord


class LazyImageList:
    """Sequence of lazily-decoded images with lookahead prefetch.

    Loading a rubble-scale scene eagerly (1500+ images) would need tens of
    GB of host memory. `hint(order)` starts decoding the next epoch's images
    ahead of the training loop. A decode that fails raises its exception
    from `__getitem__`. `close()` stops the threads.
    """

    def __init__(self, records: list[CameraRecord], num_threads: int = 8, lookahead: int = 16):
        self.records = list(records)
        self.lookahead = lookahead
        self._cache: dict[int, np.ndarray] = {}
        self._errors: dict[int, Exception] = {}  # a failed decode, raised by __getitem__
        self._pending: set[int] = set()
        self._cv = threading.Condition()
        self._queue: list[int] = []
        self._upcoming: list[int] = []
        self._stop = False
        self._threads = [threading.Thread(target=self._worker, daemon=True) for _ in range(num_threads)]
        for t in self._threads:
            t.start()

    def __len__(self) -> int:
        return len(self.records)

    def _worker(self):
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(timeout=0.5)
                if self._stop:
                    return
                idx = self._queue.pop(0)
                if idx in self._cache or idx in self._pending:
                    continue
                self._pending.add(idx)
            try:
                img, err = self.records[idx].load(), None
            except Exception as e:  # handed to the reader of this index
                img, err = None, e
            with self._cv:
                self._pending.discard(idx)
                if err is None:
                    self._cache[idx] = img
                else:
                    self._errors[idx] = err
                self._cv.notify_all()

    def hint(self, order: list[int]) -> None:
        """Schedule the upcoming access order for prefetch."""
        with self._cv:
            self._upcoming = list(order)
            self._queue = [i for i in order[: self.lookahead] if i not in self._cache]
            self._cv.notify_all()

    def __getitem__(self, idx: int) -> np.ndarray:
        with self._cv:
            if idx not in self._cache and idx not in self._pending:
                self._queue.insert(0, idx)
                self._cv.notify_all()
            while idx not in self._cache:
                if idx in self._errors:
                    raise self._errors.pop(idx)
                self._cv.wait(timeout=5.0)
            img = self._cache.pop(idx)
            # Slide the prefetch window along the hinted epoch order.
            up = self._upcoming
            if up and up[0] == idx:
                up.pop(0)
                if len(up) >= self.lookahead:
                    nxt = up[self.lookahead - 1]
                    if nxt not in self._cache and nxt not in self._pending:
                        self._queue.append(nxt)
                        self._cv.notify_all()
            # Bound memory: drop anything far beyond the lookahead window.
            if len(self._cache) > 2 * self.lookahead:
                for k in list(self._cache)[: len(self._cache) - self.lookahead]:
                    self._cache.pop(k, None)
        return img

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)
