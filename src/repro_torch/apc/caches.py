"""Program-compilation cache registry: bounds + stats in one place.

Every compilation step memoizes — LUT builds
(:mod:`repro_torch.core.nonblocked` / :mod:`repro_torch.core.blocked`),
schedule lowering+packing (:func:`repro_torch.apc.lower._compile_steps`),
named programs (:func:`repro_torch.apc.lower.compile_named`), and the MAC
family (:mod:`repro_torch.apc.mac`).  All of them are ``lru_cache``-bounded
so a long-running process cannot grow without limit, and this module is the
single place that knows the full set: a test walks :func:`registry` and
fails if anyone adds an unbounded cache, and :func:`cache_stats` reports
hits / misses / occupancy.

The registry also tracks the OTHER bounded store of the reference's serving
path: :class:`ResidentStore`, the weight-stationary resident-operand bank
(one per :class:`~repro_torch.apc.pool.ArrayPool`, as ``pool.resident``).  A
:class:`ResidentHandle` names weight digit columns that were written into
the CAM bank once and stay resident across calls; generation bookkeeping
makes stale handles (weights swapped under the same key) and evicted
handles raise instead of silently reusing dead columns.  Stores register
themselves weakly and show up in :func:`cache_stats` with the same
``{hits, misses, maxsize, currsize}`` shape as the compile caches.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any


class ResidentError(RuntimeError):
    """Base for resident-operand store faults."""


class ResidentStale(ResidentError):
    """The key was re-pinned with DIFFERENT content after this handle was
    issued — the bank columns now hold someone else's digits."""


class ResidentEvicted(ResidentError):
    """The entry was evicted from the bounded store after this handle was
    issued."""


@dataclass(frozen=True)
class ResidentHandle:
    """A claim on weight digit columns resident in the bank.

    ``key`` identifies the logical operand (e.g. an ``APLinear`` label),
    ``digest`` its content hash, ``generation`` the pin epoch —
    re-pinning the same key with different content bumps the store's
    generation and invalidates every older handle.  ``plane`` is the
    canonical weight digit plane (rows x K int8, trit + 1) exactly as the
    encode chokepoint would have produced it; consumers tile/slice it
    instead of re-encoding.
    """
    key: str
    digest: str
    generation: int
    plane: Any
    store: "ResidentStore" = field(repr=False)

    def resolve(self) -> Any:
        """Return the resident digit plane, or raise if this handle no
        longer names live bank contents."""
        return self.store._resolve(self)


_STORES: "weakref.WeakSet[ResidentStore]" = weakref.WeakSet()
_STORES_LOCK = threading.Lock()


class ResidentStore:
    """Bounded FIFO store of resident weight-digit planes.

    One per array pool (the bank that physically holds the columns).
    ``pin`` is get-or-put keyed on content digest: a hit returns a handle
    to the already-resident plane (zero encode / upload work), a miss
    stores the plane and may FIFO-evict the oldest entry.  Re-pinning a key
    with different content bumps ``generation`` so handles issued against
    the old contents raise :class:`ResidentStale`.
    """

    def __init__(self, maxsize: int = 256, name: str = "resident"):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self.name = name
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, ResidentHandle]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.stale = 0
        with _STORES_LOCK:
            _STORES.add(self)

    def __len__(self) -> int:
        return len(self._entries)

    def pin(self, key: str, digest: str, plane_fn) -> ResidentHandle:
        """Get-or-put: return the live handle for (key, digest), calling
        ``plane_fn()`` to materialize the digit plane only on a miss."""
        with self._lock:
            cur = self._entries.get(key)
            if cur is not None and cur.digest == digest:
                self.hits += 1
                return cur
            gen = 0 if cur is None else cur.generation + 1
        plane = plane_fn()          # encode outside the lock
        with self._lock:
            cur = self._entries.get(key)
            if cur is not None and cur.digest == digest:
                self.hits += 1      # raced with another pin of same content
                return cur
            if cur is not None:
                gen = cur.generation + 1
            self.misses += 1
            h = ResidentHandle(key, digest, gen, plane, self)
            self._entries[key] = h
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self.evictions += 1
            return h

    def get(self, key: str) -> ResidentHandle | None:
        """The live handle for ``key``, or None."""
        with self._lock:
            return self._entries.get(key)

    def _resolve(self, handle: ResidentHandle) -> Any:
        with self._lock:
            cur = self._entries.get(handle.key)
            if cur is None:
                self.stale += 1
                raise ResidentEvicted(
                    f"resident entry {handle.key!r} was evicted "
                    f"(store {self.name!r}, maxsize {self.maxsize})")
            if cur.generation != handle.generation:
                self.stale += 1
                raise ResidentStale(
                    f"resident entry {handle.key!r} was re-pinned with "
                    f"different content (generation {cur.generation} > "
                    f"{handle.generation}); re-pin before use")
            return cur.plane

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "maxsize": self.maxsize, "currsize": len(self._entries),
                    "evictions": self.evictions, "stale": self.stale}


def registry() -> dict:
    """Name -> lru-cached callable, for every compilation cache."""
    from ..core import blocked, nonblocked
    from . import lower, mac
    return {
        "lut_nonblocked": nonblocked._build_lut_nonblocked_cached,
        "lut_blocked": blocked._build_lut_blocked_cached,
        "compile_steps": lower._compile_steps,
        "compile_named": lower._compile_named_cached,
        "compile_checksum": lower._compile_checksum_cached,
        "compile_mac": mac._compile_mac_cached,
        "compile_mac_reduce": mac._compile_mac_reduce_cached,
        "compile_mac_tiled": mac._compile_mac_tiled_cached,
    }


def cache_stats() -> dict[str, dict[str, int]]:
    """Per-cache ``{hits, misses, maxsize, currsize}`` snapshot (compile
    caches + every live :class:`ResidentStore`, which also report
    ``evictions`` / ``stale``)."""
    out = {name: {"hits": info.hits, "misses": info.misses,
                  "maxsize": info.maxsize, "currsize": info.currsize}
           for name, fn in registry().items()
           for info in (fn.cache_info(),)}
    with _STORES_LOCK:
        stores = sorted(_STORES, key=lambda s: (s.name, id(s)))
    for i, store in enumerate(stores):
        key = store.name if store.name not in out else f"{store.name}#{i}"
        out[key] = store.stats()
    return out


def clear_compile_caches() -> None:
    """Drop every compilation cache (tests; memory-pressure escape hatch).

    Safe at any quiescent point: entries rebuild on demand, and in-flight
    :class:`~repro_torch.apc.lower.CompiledProgram` references stay valid
    (the caches only pin, never own, the compiled objects).
    """
    for fn in registry().values():
        fn.cache_clear()
