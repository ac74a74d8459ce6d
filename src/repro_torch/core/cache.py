"""Immutability-aware read-path caches.

BlobSeer's central design choice (paper §4) is that published metadata
and data are **immutable**: tree nodes are created, never updated, and
every WRITE/APPEND stores *new* pages.  Caching is therefore
unconditionally safe for anything a published snapshot can reach — a
cached value can never be stale, it can only be *deleted* (by the GC
sweep, which retires whole snapshots).  This module holds the two
caches the read path layers on top of that invariant:

* :class:`NodeCache` — a per-client bounded LRU over the metadata DHT
  (promoted out of ``blob.py``).  Sequential appends re-descend the
  same published root for border resolution and repeated reads
  re-fetch the top tree levels; both become local hits.
* :class:`PageCache` — a **shared**, byte-budgeted LRU over data pages,
  layered under :meth:`~repro.core.provider.ProviderManager.fetch_pages`.
  It adds *single-flight de-duplication*: concurrent readers of the
  same page issue ONE provider RPC — the first requester becomes the
  leader, everyone else waits (in virtual time under the Simulator) for
  the leader's fill.

GC coherence (the one way a cached value can die): the version manager
fires a retire-intent notification at every ``gc_epoch`` bump and
``ProviderManager.delete_pages`` invalidates swept page ids before any
delete RPC goes out, so a cached page never outlives its sweep.  A
retired-version read is rejected by ``enter_read`` with a typed
``RetiredVersion`` *before* it could reach either cache — the cache
can reduce RPCs, never resurrect retired data.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Hashable, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.core.sim import Clock, WallClock

# A page-cache key: (page_id, offset_within_page, length_or_None).
# Pages are immutable, so the key fully determines the bytes.
PageKey = Tuple[str, int, Optional[int]]


class NodeCache:
    """Client-side cache over the metadata DHT.

    Tree nodes are immutable once written (the system never updates
    metadata in place — the paper's key design choice), so caching is
    unconditionally safe.  Sequential appends re-descend the same
    published root for border resolution and repeated reads re-fetch the
    top tree levels; both become local hits.  Negative lookups are never
    cached (the node may be written later).

    Bounded LRU: at capacity the oldest entry is evicted, so the hot top
    levels of the tree stay resident (a clear-all here would stampede
    every client back to the DHT exactly when the cache is hottest).
    Batch-aware: ``get_many`` serves hits locally and forwards only the
    misses to the DHT's batched path.

    Counters: ``hits``/``misses`` count logical keys; ``hit_bytes``
    estimates the wire bytes the hits saved (``dht.node_nbytes`` per
    node).  Hits are also reported to the DHT's ``get_keys_cached``
    counter so ``service.rpc_report()`` shows cache-hit vs RPC
    accounting for the metadata plane in one place.
    """

    MAX_ENTRIES = 65536

    def __init__(self, dht) -> None:
        self._dht = dht
        self._cache: "OrderedDict" = OrderedDict()
        self._lock = threading.Lock()
        self._node_nbytes = getattr(dht, "node_nbytes", 64)
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0
        self.miss_bytes = 0

    # ------------------------------------------------------------- accounting
    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_bytes": self.hit_bytes,
                "miss_bytes": self.miss_bytes,
            }

    def reset_counters(self) -> None:
        with self._lock:
            self.hits = self.misses = 0
            self.hit_bytes = self.miss_bytes = 0

    def _note_hits(self, n: int) -> None:
        # caller holds self._lock
        self.hits += n
        self.hit_bytes += n * self._node_nbytes
        note = getattr(self._dht, "note_cache_hits", None)
        if note is not None:
            note(n)

    def _insert(self, key, value) -> None:
        # caller holds self._lock
        if key in self._cache:
            self._cache.move_to_end(key)
        self._cache[key] = value
        while len(self._cache) > self.MAX_ENTRIES:
            self._cache.popitem(last=False)

    # -------------------------------------------------------------- DHT facade
    def get(self, key, peer=None):
        with self._lock:
            if key in self._cache:
                self._note_hits(1)
                self._cache.move_to_end(key)
                return self._cache[key]
        value = self._dht.get(key, peer=peer)
        with self._lock:
            self.misses += 1
            self.miss_bytes += self._node_nbytes
            if value is not None:
                self._insert(key, value)
        return value

    def get_many(self, keys, peer=None):
        out: Dict = {}
        missing: List = []
        with self._lock:
            for key in dict.fromkeys(keys):
                if key in self._cache:
                    self._note_hits(1)
                    self._cache.move_to_end(key)
                    out[key] = self._cache[key]
                else:
                    missing.append(key)
        if missing:
            fetched = self._dht.get_many(missing, peer=peer)
            with self._lock:
                self.misses += len(missing)
                self.miss_bytes += len(missing) * self._node_nbytes
                for key, value in fetched.items():
                    if value is not None:
                        self._insert(key, value)
            out.update(fetched)
        return out

    def put(self, key, value, peer=None):
        self._dht.put(key, value, peer=peer)
        with self._lock:
            self._insert(key, value)

    def put_many(self, items, peer=None):
        done_at = self._dht.put_many(items, peer=peer)
        with self._lock:
            for key, value in items:
                self._insert(key, value)
        return done_at


class PageCache:
    """Shared, byte-budgeted LRU over immutable data pages.

    One instance per deployment (``BlobSeerService.page_cache``),
    layered under ``ProviderManager.fetch_pages``: every client of the
    deployment shares it, so a page any reader fetched serves every
    later reader locally.  ``budget_bytes = 0`` disables the cache
    entirely (every call falls through to the provider RPC path).

    **Single-flight**: ``claim`` partitions wanted keys into hits
    (served now), *leaders* (this caller must fetch them) and *waiters*
    (another caller is fetching right now) — concurrent readers of the
    same page issue exactly one provider RPC.  A leader MUST resolve
    every claimed key with :meth:`fill` or :meth:`abandon` (failure),
    or waiters would block forever.  Waiting blocks through the
    deployment clock, so it is virtual-time-correct under the
    Simulator and adds no wall time to simulated runs.

    **GC coherence**: :meth:`invalidate_pages` drops every entry of the
    given page ids and *dooms* their in-flight fetches (a leader's
    ``fill`` racing a sweep discards the data instead of inserting it),
    so a cached page can never outlive its sweep.  The version manager
    fires it at retire-intent (``gc_epoch`` bump) and
    ``ProviderManager.delete_pages`` fires it again before the delete
    RPCs go out.
    """

    def __init__(self, budget_bytes: int, clock: Optional[Clock] = None) -> None:
        self.budget_bytes = max(0, int(budget_bytes))
        self._clock = clock if clock is not None else WallClock()
        # One condition guards all state; it is the single-flight
        # rendezvous (waiters wait on it, leaders notify after fill).
        self._cond = self._clock.condition()
        # key -> (bytes, ready_at).  ready_at is the simulated-clock
        # instant an async prefetch's bytes arrive (0.0 = already
        # arrived); a reader hitting an in-flight prefetch gates on it,
        # so the cache can serve "early" data without ever serving it
        # before its wire transfer would have completed.
        self._entries: "OrderedDict[PageKey, Tuple[bytes, float]]" = OrderedDict()
        self._by_page: Dict[str, Set[PageKey]] = {}
        self._bytes = 0
        self._inflight: Set[PageKey] = set()
        self._doomed: Set[PageKey] = set()
        # counters (guarded by self._cond's lock)
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0
        self.evictions = 0
        self.inflight_waits = 0
        self.invalidated_entries = 0
        self.prefetch_fills = 0

    # --------------------------------------------------------------- basics
    @property
    def enabled(self) -> bool:
        return self.budget_bytes > 0

    def used_bytes(self) -> int:
        with self._cond:
            return self._bytes

    def __len__(self) -> int:
        with self._cond:
            return len(self._entries)

    def cached_page_ids(self) -> Set[str]:
        """Page ids with at least one resident entry (tests/GC checks)."""
        with self._cond:
            return set(self._by_page)

    def counters(self) -> Dict[str, int]:
        with self._cond:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_bytes": self.hit_bytes,
                "evictions": self.evictions,
                "inflight_waits": self.inflight_waits,
                "invalidated_entries": self.invalidated_entries,
                "prefetch_fills": self.prefetch_fills,
                "used_bytes": self._bytes,
                "entries": len(self._entries),
            }

    def reset_counters(self) -> None:
        """Zero the counters; cached contents are kept (counter resets
        bracket a measurement, they must not change the wire schedule)."""
        with self._cond:
            self.hits = self.misses = 0
            self.hit_bytes = self.evictions = 0
            self.inflight_waits = self.invalidated_entries = 0
            self.prefetch_fills = 0

    # --------------------------------------------------------- single-flight
    def claim(
        self, keys: Sequence[PageKey], count: bool = True
    ) -> Tuple[Dict[PageKey, Tuple[bytes, float]], List[PageKey], List[PageKey]]:
        """Partition ``keys`` into ``(hits, leaders, waiters)`` atomically.

        Hits are returned as ``(bytes, ready_at)`` (LRU-touched); a
        ``ready_at`` in the future means the bytes are an async prefetch
        still on the wire — the caller gates on it before serving them.
        Leader keys are marked in-flight — the caller owns fetching them
        and must ``fill`` or ``abandon`` each one.  Waiter keys are in
        flight on behalf of another caller; resolve them with
        :meth:`wait`.

        ``count=False`` marks a *probe* claim (prefetch candidates): the
        single-flight bookkeeping is identical but the hit/miss counters
        are untouched, so ``page_cache_hits`` keeps meaning "bytes
        actually served to a reader", not "prefetch found its sibling
        already resident".
        """
        hits: Dict[PageKey, Tuple[bytes, float]] = {}
        leaders: List[PageKey] = []
        waiters: List[PageKey] = []
        with self._cond:
            for key in keys:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    if count:
                        self.hits += 1
                        self.hit_bytes += len(entry[0])
                    hits[key] = entry
                elif key in self._inflight:
                    waiters.append(key)
                else:
                    self._inflight.add(key)
                    if count:
                        self.misses += 1
                    leaders.append(key)
        return hits, leaders, waiters

    def fill(self, key: PageKey, data: bytes, prefetch: bool = False,
             ready_at: float = 0.0) -> None:
        """Leader resolution: insert the fetched bytes and wake waiters.

        ``ready_at``: arrival instant of a fire-and-forget prefetch
        (0.0 for blocking fetches — the transfer completed before this
        call).  A key doomed by a concurrent :meth:`invalidate_pages`
        (its page was swept while the fetch was in flight) is discarded
        — waiters wake and re-fetch; they will fail over or get the
        typed ``RetiredVersion`` upstream, never swept bytes from the
        cache.
        """
        with self._cond:
            self._inflight.discard(key)
            if key in self._doomed:
                self._doomed.discard(key)
            else:
                self._insert(key, data, ready_at)
                if prefetch:
                    self.prefetch_fills += 1
            self._cond.notify_all()

    def abandon(self, key: PageKey) -> None:
        """Leader resolution on failure: release the claim, wake waiters
        (they re-claim and retry against the remaining replicas)."""
        with self._cond:
            self._inflight.discard(key)
            self._doomed.discard(key)
            self._cond.notify_all()

    def wait(self, key: PageKey) -> Optional[Tuple[bytes, float]]:
        """Block until ``key``'s in-flight fetch resolves; returns
        ``(bytes, ready_at)``, or ``None`` if the leader abandoned
        (caller re-claims and retries)."""
        with self._cond:
            if key in self._inflight:
                self.inflight_waits += 1
                while key in self._inflight:
                    self._cond.wait()
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                self.hit_bytes += len(entry[0])
            return entry

    # ----------------------------------------------------------- GC coherence
    def invalidate_pages(self, page_ids: Iterable[str]) -> int:
        """Drop every entry of ``page_ids`` and doom their in-flight
        fetches.  Returns the number of entries removed.  Fired at
        retire-intent (gc_epoch bump) and again by the sweep's
        ``delete_pages`` — a cached page can never outlive its sweep."""
        removed = 0
        with self._cond:
            for pid in page_ids:
                for key in self._by_page.pop(pid, ()):  # resident entries
                    entry = self._entries.pop(key, None)
                    if entry is not None:
                        self._bytes -= len(entry[0])
                        removed += 1
                for key in list(self._inflight):
                    if key[0] == pid:
                        self._doomed.add(key)
            self.invalidated_entries += removed
        return removed

    # ---------------------------------------------------------------- eviction
    def _insert(self, key: PageKey, data: bytes, ready_at: float = 0.0) -> None:
        # caller holds the condition's lock
        if not self.enabled or len(data) > self.budget_bytes:
            return
        old = self._entries.pop(key, None)
        if old is not None:
            self._bytes -= len(old[0])
            self._by_page.get(key[0], set()).discard(key)
        self._entries[key] = (data, ready_at)
        self._bytes += len(data)
        self._by_page.setdefault(key[0], set()).add(key)
        while self._bytes > self.budget_bytes and self._entries:
            vkey, (vdata, _vready) = self._entries.popitem(last=False)
            self._bytes -= len(vdata)
            self.evictions += 1
            keys = self._by_page.get(vkey[0])
            if keys is not None:
                keys.discard(vkey)
                if not keys:
                    del self._by_page[vkey[0]]


class InvalidationSubscriber:
    """Push-based cache invalidation: the subscription plane's answer
    to the PR 4 retire-intent hook.

    The version manager's GC listener interface stays the same
    (``fn(blob_id, versions, gc_epoch, page_ids)``), but delivery is
    now modelled as a *push*: the retiring leader ships one batched
    fire-and-forget invalidation event per retire intent to this
    subscriber's endpoint (``CACHE_INVAL_EVT_BYTES`` per page id), and
    the page cache evicts at the event — the wire-accounted twin of a
    real deployment where cache nodes subscribe to gc_epoch bumps
    instead of polling them.  A down endpoint still invalidates
    (conservative: eviction is always safe, serving swept bytes never
    is).
    """

    def __init__(self, cache: PageCache, wire=None,
                 endpoint: str = "cache-inval") -> None:
        self._cache = cache
        self._wire = wire
        self.endpoint = endpoint
        self._lock = threading.Lock()
        self.pushes = 0         # invalidation batches received
        self.page_ids = 0       # page ids those batches carried
        self.invalidated = 0    # cache entries actually evicted

    def __call__(self, blob_id: str, versions: Tuple[int, ...],
                 gc_epoch: int, page_ids: Tuple[str, ...]) -> None:
        """GC-listener entry point (fired outside the shard lock)."""
        if not page_ids:
            return
        if self._wire is not None:
            from repro_torch.core.transport import (CACHE_INVAL_EVT_BYTES,
                                              EndpointDown)
            try:
                self._wire.transfer_batch(
                    self.endpoint, [CACHE_INVAL_EVT_BYTES] * len(page_ids),
                    inbound=True, fire_and_forget=True)
            except EndpointDown:
                pass  # evict anyway: stale eviction is safe, stale data is not
        removed = self._cache.invalidate_pages(page_ids)
        with self._lock:
            self.pushes += 1
            self.page_ids += len(page_ids)
            self.invalidated += removed

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {"pushes": self.pushes, "page_ids": self.page_ids,
                    "invalidated": self.invalidated}

    def reset_counters(self) -> None:
        with self._lock:
            self.pushes = self.page_ids = self.invalidated = 0
