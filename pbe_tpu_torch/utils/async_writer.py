"""Bounded background writer for host-side result IO (the port's own copy
of ``pbe_tpu/utils/async_writer.py``).

PNG encode run synchronously on the host leaves the device idle between
batches. This writer moves encode/save onto worker threads behind a
BOUNDED queue — PIL's encoder releases the GIL, so the
host pipeline (decode next batch / drive the device) overlaps with saves,
and the bound applies backpressure instead of buffering unboundedly when
the device outruns the disk.

Errors raised by submitted jobs are re-raised on the submitting thread at
the next submit() or at close(), so a failing save can't silently drop
results (the reference's save loop, scripts/inference_test_bench.py:345-397,
was synchronous and aborted the run instead).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable


class AsyncWriter:
    def __init__(self, workers: int = 2, max_queue: int = 8):
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._error: BaseException | None = None
        self._error_lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._run, daemon=True)
            for _ in range(max(1, workers))
        ]
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            fn, args, kwargs = item
            try:
                fn(*args, **kwargs)
            except BaseException as e:  # surfaced on the submitting thread
                with self._error_lock:
                    if self._error is None:
                        self._error = e
            finally:
                self._q.task_done()

    def _check_error(self) -> None:
        with self._error_lock:
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def submit(self, fn: Callable, *args: Any, **kwargs: Any) -> None:
        """Enqueue fn(*args, **kwargs); blocks when max_queue jobs pending."""
        self._check_error()
        self._q.put((fn, args, kwargs))

    def close(self) -> None:
        """Drain the queue, stop the workers, re-raise any pending error."""
        self._q.join()
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join()
        self._check_error()

    def __enter__(self) -> "AsyncWriter":
        return self

    def __exit__(self, *exc) -> None:
        if not any(exc):
            self.close()
