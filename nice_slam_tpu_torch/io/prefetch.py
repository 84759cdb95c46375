"""Host-side frame prefetching (L5 ingest); port of
`nice_slam_tpu/io/prefetch.py`.

A pool of daemon threads reads up to `ahead` frames in advance, so frame
decoding or synthesis overlaps the device work (numpy's array kernels,
zlib and the codecs' ctypes calls release the interpreter lock).  The
synthetic scene's analytic renderer is the heavy case at room0's
680x1200: it advertises `prefetch_workers`.
Frames are delivered in order; random access falls through to the
underlying reader; a reader's error is raised when that frame is
consumed; `close()` joins the threads.  `read_s` sums the seconds the
reader took for the frames the pool read (on the workers' threads),
`wait_s` the seconds the consumer waited for an in-order frame.
"""

from __future__ import annotations

import threading
import time
from typing import Any


class Prefetcher:
    """Wraps a frame reader with an `ahead`-deep, `workers`-wide
    background decode pool delivering frames in order."""

    def __init__(self, reader: Any, start: int = 0, ahead: int = 2,
                 workers: int = 1):
        self.reader = reader
        self.workers = max(1, int(workers))
        # depth must cover the pool, and Queue-like 0 would mean unbounded:
        # clamp so prefetch is always finite
        self.ahead = max(self.workers, max(1, int(ahead)))
        self._results: dict[int, tuple] = {}   # idx -> ('ok'|'err', value)
        self._cv = threading.Condition()
        self._next_issue = start
        self._next_consume = start
        self._stop = False
        self.read_s = 0.0
        self.wait_s = 0.0
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(self.workers)]
        for t in self._threads:
            t.start()

    def __len__(self) -> int:
        return len(self.reader)

    def _worker(self) -> None:
        n = len(self.reader)
        while True:
            with self._cv:
                while (not self._stop and
                       (self._next_issue >= n
                        or self._next_issue - self._next_consume
                        >= self.ahead)):
                    self._cv.wait(timeout=0.5)
                if self._stop or self._next_issue >= n:
                    return
                idx = self._next_issue
                self._next_issue += 1
            t0 = time.perf_counter()
            try:
                item = ('ok', self.reader[idx])
            except Exception as e:          # surfaced on consume
                item = ('err', e)
            seconds = time.perf_counter() - t0
            with self._cv:
                self.read_s += seconds
                self._results[idx] = item
                self._cv.notify_all()

    def __getitem__(self, idx: int):
        if idx != self._next_consume:
            # random access: bypass the pool (keyframe re-reads etc.)
            return self.reader[idx]
        with self._cv:
            t0 = time.perf_counter()
            while idx not in self._results and not self._stop:
                self._cv.wait(timeout=0.5)
            self.wait_s += time.perf_counter() - t0
            if idx not in self._results:    # closed while waiting
                return self.reader[idx]
            status, value = self._results.pop(idx)
            self._next_consume = idx + 1
            self._cv.notify_all()
        if status == 'err':
            raise value
        return value

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)
