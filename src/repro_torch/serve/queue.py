"""Closeable iterable queue: the serve engine's submission channel.

A copy of :mod:`repro.serve.queue` (it has no framework code).

A thin, stdlib-only wrapper over :class:`queue.Queue` with the shape the
background-dispatch serving loop wants:

- producers ``put()`` work items from any thread;
- ``close()`` marks end-of-stream — further ``put()`` raises
  :class:`ClosedQueue`, and consumers drain whatever was already queued;
- consumers iterate (``for item in q``) or ``get()``; iteration ends when
  the queue is closed AND empty.  The end-of-stream sentinel is re-signaled
  on receipt, so ANY number of consumer threads terminate cleanly off one
  ``close()``.

``maxsize`` bounds the submission backlog (producers block once consumers
fall behind), which is the queue-side half of admission control — the
cost-oracle half lives in ``serve.batcher``.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

__all__ = ["IterableQueue", "ClosedQueue"]


class ClosedQueue(RuntimeError):
    """put() after close(), or close() twice."""


class _EndOfStream:
    __slots__ = ()

    def __repr__(self) -> str:   # pragma: no cover - debug aid
        return "<end-of-stream>"


_EOS = _EndOfStream()


class IterableQueue:
    """A Queue you can iterate and close.

    >>> q = IterableQueue()
    >>> q.put(1); q.put(2); q.close()
    >>> list(q)
    [1, 2]
    """

    def __init__(self, maxsize: int = 0):
        # +1 slot keeps the sentinel from blocking close() on a full queue
        self._q: queue.Queue = queue.Queue(maxsize + 1 if maxsize else 0)
        self._maxsize = maxsize
        self._lock = threading.Lock()
        self._closed = False
        self._sem = threading.BoundedSemaphore(maxsize) if maxsize else None

    @property
    def closed(self) -> bool:
        return self._closed

    def qsize(self) -> int:
        """Approximate number of queued work items (sentinel excluded)."""
        n = self._q.qsize()
        return max(0, n - 1) if self._closed else n

    def put(self, item: Any, timeout: float | None = None) -> None:
        """Enqueue ``item``; blocks while ``maxsize`` items are pending.
        Raises :class:`ClosedQueue` once the queue is closed."""
        if self._closed:
            raise ClosedQueue("put() on a closed IterableQueue")
        if self._sem is not None and not self._sem.acquire(timeout=timeout):
            raise queue.Full("IterableQueue.put timed out")
        with self._lock:
            if self._closed:
                if self._sem is not None:
                    self._sem.release()
                raise ClosedQueue("put() on a closed IterableQueue")
            self._q.put(item)

    def close(self) -> None:
        """End the stream: reject further puts, let consumers drain."""
        with self._lock:
            if self._closed:
                raise ClosedQueue("close() on a closed IterableQueue")
            self._closed = True
            self._q.put(_EOS)

    def get(self, timeout: float | None = None) -> Any:
        """Dequeue one item; raises StopIteration at end-of-stream and
        re-signals it so sibling consumers also terminate."""
        item = self._q.get(timeout=timeout)
        if item is _EOS:
            self._q.put(_EOS)          # re-signal for other consumers
            raise StopIteration
        if self._sem is not None:
            try:
                self._sem.release()
            except ValueError:         # pragma: no cover - defensive
                pass
        return item

    def __iter__(self) -> Iterator[Any]:
        while True:
            try:
                yield self.get()
            except StopIteration:
                return
