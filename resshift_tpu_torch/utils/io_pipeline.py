"""Host I/O beside the device work of the inference entry points (the port's
own copy of the JAX package's `utils/io_pipeline.py`).

- `prefetch`: a background thread runs the (image-reading) batch iterator
  ahead of the loop that launches the sampler, `depth` items ahead.
- `AsyncWriter`: a background thread runs each submitted job, which copies
  a result to the host (waiting for the device to finish that batch) and
  encodes its images on a small thread pool, while the main thread already
  launches the next batch.

No exception is dropped: a reader error re-raises from the consuming
iterator; a writer error re-raises from the next `submit` or from `close`.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

__all__ = ["prefetch", "AsyncWriter"]

_SENTINEL = object()


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """Iterate `it` on a background thread, `depth` items ahead.  A
    producer exception re-raises at the consumer's next pull; a consumer
    that stops early unblocks the producer and asks it to stop."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put_stoppable(item) -> bool:
        # every put stays abortable: an unconditional put on a full queue
        # would deadlock against the consumer's join below
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for item in it:
                if not put_stoppable(item):
                    return
            put_stoppable(_SENTINEL)
        except BaseException as e:  # re-raised on the consumer side
            put_stoppable(e)

    t = threading.Thread(target=run, name="io-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


class AsyncWriter:
    """Bounded background writer: `submit(fn)` queues `fn(pool)`, run on one
    writer thread in submission order; `pool` is a shared thread pool for
    the encodes.  At most `depth` jobs wait, so results cannot pile up in
    host memory.  The first job error re-raises from the next `submit` or
    from `close`."""

    def __init__(self, depth: int = 2, encode_threads: int = 8):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: BaseException | None = None
        self._err_lock = threading.Lock()
        self._failed = False  # sticky: once set, later jobs drain without running
        self._pool = ThreadPoolExecutor(max_workers=encode_threads,
                                        thread_name_prefix="png-encode")
        self._thread = threading.Thread(target=self._run, name="io-writer", daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            fn = self._q.get()
            if fn is _SENTINEL:
                return
            with self._err_lock:
                failed = self._failed
            if failed:
                continue  # drain the queue after a failure
            try:
                fn(self._pool)
            except BaseException as e:
                with self._err_lock:
                    self._failed = True
                    self._err = e

    def _check(self):
        with self._err_lock:
            err, self._err = self._err, None
        if err is not None:
            raise err

    def submit(self, fn: Callable) -> None:
        self._check()
        self._q.put(fn)

    def close(self) -> None:
        """Wait for all pending jobs; re-raise the first job error, if any."""
        self._q.put(_SENTINEL)
        self._thread.join()
        self._pool.shutdown(wait=True)
        self._check()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # on an exception in the with-body, still drain but prefer that error
        try:
            self.close()
        except BaseException:
            if exc_type is None:
                raise
        return False
