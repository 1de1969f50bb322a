"""Refcounted runner registry: explicit eviction for shared compiled state.

The serve path caches one compiled :class:`~repro_torch.core.hyperstep.HyperstepRunner`
per request shape. A plain ``functools.lru_cache(maxsize=8)`` is wrong for that
once requests run concurrently: the ninth distinct shape silently evicts the
least-recent entry *while another thread may still hold its lock*, orphaning a
runner mid-run and letting a second runner for the same shape be built behind
its back (two compiled programs, two backing streams, interleaved writes).

:class:`Registry` replaces it with refcounted eviction: ``acquire`` pins an
entry for the duration of a ``with`` block, and only entries with zero pins are
evictable. The registry may transiently exceed ``capacity`` when every entry is
pinned — correctness over memory ceiling — and trims back to capacity (oldest
idle first) as pins drop.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Callable, Hashable, Iterator

__all__ = ["Registry", "RegistryEntry"]


@dataclasses.dataclass
class RegistryEntry:
    """One cached value plus its pin count and a per-entry lock.

    ``lock`` serialises users of the *value* (e.g. concurrent same-shape
    requests sharing one runner + backing stream); ``refs`` counts active
    ``acquire`` holds — the registry never evicts while ``refs > 0``.
    """

    key: Hashable
    value: Any
    refs: int = 0
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)


class Registry:
    """A keyed cache with refcounted, explicit eviction.

    ``acquire(key, build)`` returns a context manager yielding the
    :class:`RegistryEntry`; the entry is pinned (unevictable) until exit.
    ``build()`` runs at most once per live key, outside any other entry's
    lock but inside the registry lock — builds are serialised, which is what
    we want for building runners (a build simulates the whole cursor walk,
    and racing duplicate builds wastes it).
    """

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: OrderedDict[Hashable, RegistryEntry] = OrderedDict()
        self.evictions = 0
        self.builds = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> list[Hashable]:
        with self._lock:
            return list(self._entries)

    def __iter__(self) -> Iterator[Hashable]:
        # iterate over a snapshot: entries may be built/evicted concurrently
        return iter(self.keys())

    @contextmanager
    def acquire(self, key: Hashable,
                build: Callable[[], Any]) -> Iterator[RegistryEntry]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = RegistryEntry(key=key, value=build())
                self.builds += 1
                self._entries[key] = entry
            else:
                self._entries.move_to_end(key)   # LRU order: recent last
            entry.refs += 1
        try:
            yield entry
        finally:
            with self._lock:
                entry.refs -= 1
                self._trim_locked()

    def _trim_locked(self) -> None:
        """Drop oldest idle entries until within capacity (registry lock held)."""
        while len(self._entries) > self.capacity:
            victim = next((k for k, e in self._entries.items() if e.refs == 0),
                          None)
            if victim is None:      # everything pinned: over capacity for now
                return
            del self._entries[victim]
            self.evictions += 1

    def clear(self) -> None:
        """Drop every idle entry (pinned entries survive)."""
        with self._lock:
            for k in [k for k, e in self._entries.items() if e.refs == 0]:
                del self._entries[k]
