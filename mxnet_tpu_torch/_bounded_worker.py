"""Shared bounded-queue producer thread with deterministic shutdown.

One implementation of the pipeline-stage contract used by the gluon
``DataLoader`` prefetcher and ``io.DeviceFeed``: a daemon thread fills
a bounded queue; ``_put`` gives up promptly once the consumer stops
caring; ``stop()`` releases the worker even if it is blocked on a full
queue (flag, drain, join with a deadline — setting the flag alone is
racy: the worker may re-fill the queue between a drain and its next
put, leaking the thread plus its buffered items per abandoned epoch).
"""
from __future__ import annotations

import queue
import threading
import time


class BoundedQueueWorker(threading.Thread):
    """Subclasses implement ``run()`` using ``_put``/``_DONE`` and
    call ``self.start()`` when ready."""

    _DONE = object()

    def __init__(self, depth: int, name: str):
        super().__init__(daemon=True, name=name)
        self._queue = queue.Queue(maxsize=max(1, depth))
        self._stopped = False

    def _put(self, item) -> bool:
        """put() that gives up when the consumer abandoned iteration."""
        while not self._stopped:
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _get(self):
        """get() that returns the DONE sentinel instead of blocking
        forever when the worker was stopped (or died) without managing
        to enqueue its sentinel — e.g. a second iter() of the owning
        stage stopped this one."""
        while True:
            try:
                return self._queue.get(timeout=0.2)
            except queue.Empty:
                if self._stopped or not self.is_alive():
                    return self._DONE

    def _drained(self, item):
        """Hook for every item discarded by ``stop()``'s drain.
        Default: drop it. A stage whose queued items carry completion
        obligations (the serving engine's request futures) overrides
        this to reject them instead of leaving waiters hung."""

    def stop(self, timeout: float = 5.0):
        """Release the worker deterministically: drain-and-join in a
        loop, with a deadline so a worker wedged inside its source
        (e.g. a stuck dataset) can't hang the caller. Drained items
        pass through ``_drained``."""
        self._stopped = True
        deadline = time.monotonic() + timeout
        while self.is_alive():
            # drain so a blocked put() can observe the flag promptly
            try:
                while True:
                    self._drained(self._queue.get_nowait())
            except queue.Empty:
                pass
            self.join(timeout=0.05)
            if time.monotonic() >= deadline:
                break
