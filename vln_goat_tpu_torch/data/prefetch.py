"""Host-side batch prefetching (the port's copy of
vln_goat_tpu/data/prefetch.py).

Reference: PrefetchLoader (pretrain_src/data/loader.py:90) overlaps H2D
copies with compute.  Here a background thread builds the next batches
(numpy packing on the host, and their copies to the card from pinned
memory, which the batch factory makes) while the card runs the previous
step.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class PrefetchIterator:
    """Wraps a zero-arg batch factory in a daemon thread + bounded queue."""

    def __init__(self, next_batch: Callable[[], object], depth: int = 2):
        self._next = next_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            while not self._stop.is_set():
                item = self._next()
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # surfaces on the consumer side
            self._exc = e

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            # drain queued batches BEFORE surfacing a producer exception —
            # otherwise the last `depth` prefetched batches of an epoch are
            # silently dropped when the factory raises StopIteration
            try:
                return self._q.get_nowait()
            except queue.Empty:
                pass
            if self._exc is not None:
                # one more drain: a put may have landed between the check
                # above and the exception being set
                try:
                    return self._q.get_nowait()
                except queue.Empty:
                    raise self._exc
            try:
                return self._q.get(timeout=0.5)
            except queue.Empty:
                if not self._thread.is_alive():
                    raise StopIteration

    def close(self):
        self._stop.set()
