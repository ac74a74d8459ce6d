"""Data providers + provider manager.

Paper §3.1:

* *Data providers* physically store the pages generated by WRITE and
  APPEND; they may dynamically join and leave.
* The *provider manager* keeps information about available storage
  space; each joining provider registers with it.  It picks providers
  for new pages "according to a strategy aiming at ensuring an even
  distribution of pages among providers".

Beyond-paper additions (the paper defers "volatility and failures" to
future work):

* N-way page replication with failure-aware placement,
* heartbeat-based failure detection + re-replication,
* straggler mitigation on reads (replica load-balancing: spread a
  batch's page fetches across live replicas by projected outstanding
  bytes, fail over on error),
* a shared, byte-budgeted :class:`~repro.core.cache.PageCache` under
  ``fetch_pages`` (immutable pages: hits are always safe; the GC sweep
  invalidates what it deletes),
* pluggable placement strategies (round-robin, least-loaded,
  power-of-two-choices).
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cache import PageCache

if TYPE_CHECKING:  # annotation only; the manager never constructs one
    from repro_torch.core.dedup_index import DedupIndex
from repro_torch.core.placement import (
    ErasureCodedPolicy,
    HashRing,
    PlacementPolicy,
    ReplicationPolicy,
    ec_decode,
    ec_encode,
    logical_pid,
    page_codec,
    parse_policy,
    shard_id,
    split_shard,
    stable_hash,
)
from repro_torch.core.transport import (
    DELETE_PAGE_CMD_BYTES,
    LIST_PAGE_ENTRY_BYTES,
    PM_LOCATE_REQ_BYTES,
    RING_ANNOUNCE_BYTES,
    SCRUB_PROBE_BYTES,
    WIDEN_CMD_BYTES,
    EndpointDown,
    Wire,
)
from repro_torch.store.memory import MemoryPageStore

# Outstanding-bytes estimate for a whole-page request (length=None) when
# spreading a fetch wave across replicas; only relative magnitudes
# matter for the balancing decision.
_WHOLE_PAGE_EST = 64 * 1024

# Relocation-overlay lookups a single fetch may pay per page while
# chasing a copy that live migration keeps moving (each retry requires
# the overlay to have CHANGED, so the cap only backstops pathological
# ping-pong).
_MAX_RELOCATES = 8


class PageIntegrityError(RuntimeError):
    """Stored page digest does not match payload (corruption detected)."""


def _digest(payload: bytes) -> int:
    """64-bit FNV-1a over the payload.

    This is the *reference* digest; the TPU-side Pallas kernel
    (``repro.kernels.page_digest``) computes the same function over
    device-resident checkpoint pages so delta detection never round-trips
    through host memory.  Kept dependency-free here: providers are
    control-plane processes without accelerators.
    """
    h = 0xCBF29CE484222325
    for b in payload:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


@dataclass
class DataProvider:
    """One storage endpoint. ``store`` is any page-store backend."""

    pid: str
    wire: Wire
    store: object = field(default_factory=MemoryPageStore)
    verify_digests: bool = False
    # Storage class: "hot" endpoints take new-page placement; "cold"
    # endpoints only receive lifecycle demotions (cheap, slow capacity —
    # an S3-class backend) and still serve reads through the overlay.
    tier: str = "hot"

    def __post_init__(self) -> None:
        self._digests: Dict[str, int] = {}
        self._put_at: Dict[str, float] = {}  # pid -> clock time of storage
        self._lock = threading.Lock()
        self.last_heartbeat = self.wire.clock.now()

    # -- remote API (everything below crosses the wire) ----------------------
    def put_page(self, page_id: str, payload: bytes, peer: Optional[str] = None) -> None:
        """Store one page (single-item facade over :meth:`put_pages`)."""
        self.put_pages([(page_id, payload)], peer=peer)

    def put_pages(
        self,
        items: Sequence[Tuple[str, bytes]],
        peer: Optional[str] = None,
        fire_and_forget: bool = False,
    ) -> float:
        """Batched store: one round trip for many ``(page_id, payload)``.

        The write-plane mirror of :meth:`get_pages`: the whole batch
        pays a single latency charge plus the summed payload bytes
        (async in-flight sends, paper Alg 2 'in parallel' — the peer
        NIC pays bytes only).  Raises :class:`EndpointDown` for the
        whole batch when the endpoint is down.

        ``fire_and_forget``: pipelined stores — the wire is charged
        identically but the issuing task never blocks; the returned
        completion instant is the durability barrier the writer must
        sleep to *before* calling ``metadata_complete`` (a snapshot may
        never publish before its pages have arrived).  Returns the
        batch's completion instant in simulated-clock coordinates.
        """
        if self.wire.is_down(self.pid):
            raise EndpointDown(self.pid)
        done_at = self.wire.transfer_batch(
            self.pid, [len(p) for _, p in items], inbound=True, peer=peer,
            async_peer=True, fire_and_forget=fire_and_forget,
        )
        now = self.wire.clock.now()
        with self._lock:
            for page_id, payload in items:
                if self.verify_digests:
                    self._digests[page_id] = _digest(payload)
                self._put_at[page_id] = now
        for page_id, payload in items:
            self.store.put(page_id, payload)
        return done_at

    def _read_one(self, page_id: str, off: int, length: Optional[int]) -> bytes:
        """Local read shared by the single and batched paths; raises on
        missing pages and integrity failures."""
        payload = self.store.get(page_id)
        if payload is None:
            raise KeyError(f"provider {self.pid}: no page {page_id}")
        if self.verify_digests:
            with self._lock:
                want = self._digests.get(page_id)
            if want is not None and _digest(payload) != want:
                raise PageIntegrityError(page_id)
        if length is None:
            length = len(payload) - off
        return payload[off : off + length]

    def get_page(
        self,
        page_id: str,
        off: int = 0,
        length: Optional[int] = None,
        peer: Optional[str] = None,
    ) -> bytes:
        view = self._read_one(page_id, off, length)
        # async parallel fetches (paper Alg 1 'in parallel')
        self.wire.transfer(self.pid, len(view), inbound=False, peer=peer,
                           async_peer=True)
        return view

    def get_pages(
        self,
        items: Sequence[Tuple[str, int, Optional[int]]],
        peer: Optional[str] = None,
        fire_and_forget: bool = False,
    ) -> List[object]:
        """Batched read: one round trip for many ``(page_id, off, length)``.

        Returns one entry per item: the bytes on success, or the
        per-page exception (missing page / integrity failure) so the
        caller can fail over just that page to another replica.  The
        endpoint being down raises :class:`EndpointDown` for the whole
        batch.  The wire is charged a single latency plus the summed
        bytes actually served.

        ``fire_and_forget``: prefetch-only batches — the wire is
        charged identically but the issuing task never blocks; the
        caller reads the arrival instant from the endpoint's
        ``sim_busy_until`` (see ``Wire.transfer``).
        """
        if self.wire.is_down(self.pid):
            raise EndpointDown(self.pid)
        results: List[object] = []
        sizes: List[int] = []
        for page_id, off, length in items:
            try:
                view = self._read_one(page_id, off, length)
            except (KeyError, PageIntegrityError) as e:
                results.append(e)
                continue
            results.append(view)
            sizes.append(len(view))
        self.wire.transfer_batch(self.pid, sizes, inbound=False, peer=peer,
                                 async_peer=True,
                                 fire_and_forget=fire_and_forget)
        return results

    def delete_pages(
        self, page_ids: Sequence[str], peer: Optional[str] = None
    ) -> Tuple[int, int]:
        """Batched page delete (GC sweep): one round trip for the batch.

        The batch pays one latency charge plus ``DELETE_PAGE_CMD_BYTES``
        per page id — a delete moves identifiers, not payloads.  Returns
        ``(n_deleted, freed_bytes)``; absent pages (already swept, or
        re-sent after a partial round) are counted as no-ops, so the
        sweep is idempotent.
        """
        self.wire.transfer_batch(self.pid,
                                 [DELETE_PAGE_CMD_BYTES] * len(page_ids),
                                 inbound=True, peer=peer, async_peer=True)
        n = freed = 0
        for pid in page_ids:
            payload = self.store.get(pid)
            if payload is None:
                continue
            self.store.delete(pid)
            with self._lock:
                self._digests.pop(pid, None)
                self._put_at.pop(pid, None)
            n += 1
            freed += len(payload)
        return n, freed

    def list_pages(self, peer: Optional[str] = None) -> List[Tuple[str, float]]:
        """Wire-accounted store inventory: ``(page_id, stored_at)`` pairs.

        One batched round trip carrying ``LIST_PAGE_ENTRY_BYTES`` per
        entry.  ``stored_at`` is the clock instant :meth:`put_page`
        recorded; pages found on disk without one (a cold-restarted
        spool) report 0.0, i.e. arbitrarily old.  The GC orphan scan
        uses the age to spare pages a writer stored moments ago but has
        not yet registered with the version manager.
        """
        out = []
        with self._lock:
            for pid in self.store.iter_pids():
                out.append((pid, self._put_at.get(pid, 0.0)))
        self.wire.transfer_batch(self.pid, [LIST_PAGE_ENTRY_BYTES] * len(out),
                                 inbound=False, peer=peer, async_peer=True)
        return out

    def verify_pages(self, peer: Optional[str] = None) -> List[str]:
        """Scrub probe: re-digest every stored page *in place* and return
        the ids whose bytes no longer match the digest recorded at store
        time (or that vanished from the backend entirely).

        The page bytes never cross the wire — the provider hashes
        locally (the host twin of the ``page_digest`` Pallas kernel) and
        the batch pays one round trip of ``SCRUB_PROBE_BYTES`` per page
        checked.  Pages stored while ``verify_digests`` was off have no
        recorded digest and are only checked for presence.
        """
        if self.wire.is_down(self.pid):
            raise EndpointDown(self.pid)
        with self._lock:
            want = dict(self._digests)
            known = sorted(self._put_at)
        bad: List[str] = []
        for pid in known:
            payload = self.store.get(pid)
            if payload is None:
                bad.append(pid)
                continue
            expect = want.get(pid)
            if expect is not None and _digest(payload) != expect:
                bad.append(pid)
        self.wire.transfer_batch(self.pid, [SCRUB_PROBE_BYTES] * len(known),
                                 inbound=False, peer=peer, async_peer=True)
        return bad

    def has_page(self, page_id: str) -> bool:
        return self.store.has(page_id)

    def heartbeat(self) -> None:
        self.last_heartbeat = self.wire.clock.now()

    # -- introspection ---------------------------------------------------------
    def page_count(self) -> int:
        return len(self.store)

    def stored_bytes(self) -> int:
        return self.store.total_bytes()


PlacementStrategy = Callable[["ProviderManager", int], List[DataProvider]]


def round_robin(pm: "ProviderManager", n: int) -> List[DataProvider]:
    alive = pm.placement_pool()
    if not alive:
        raise RuntimeError("no alive providers")
    out = []
    with pm._rr_lock:
        for _ in range(n):
            out.append(alive[pm._rr_next % len(alive)])
            pm._rr_next += 1
    return out

def least_loaded(pm: "ProviderManager", n: int) -> List[DataProvider]:
    alive = pm.placement_pool()
    if not alive:
        raise RuntimeError("no alive providers")
    ordered = sorted(alive, key=lambda p: p.page_count())
    return [ordered[i % len(ordered)] for i in range(n)]

def two_choice(pm: "ProviderManager", n: int) -> List[DataProvider]:
    """Power-of-two-choices: near-least-loaded at O(1) coordination cost."""
    alive = pm.placement_pool()
    if not alive:
        raise RuntimeError("no alive providers")
    rng = pm._rng
    out = []
    for _ in range(n):
        a, b = rng.choice(alive), rng.choice(alive)
        out.append(a if a.page_count() <= b.page_count() else b)
    return out


STRATEGIES: Dict[str, PlacementStrategy] = {
    "round_robin": round_robin,
    "least_loaded": least_loaded,
    "two_choice": two_choice,
}

#: The consistent-hash ring strategy is not a :data:`STRATEGIES` entry —
#: placement is keyed per page (ring state + placement key), not drawn
#: from a pool sequence, so ``allocate`` handles it directly.
RING_STRATEGY = "ring"

# "rep:0" = the deployment's default replication factor.
_DEFAULT_POLICY = ReplicationPolicy(0)


class ProviderManager:
    """Registry + placement + failure handling for data providers."""

    def __init__(
        self,
        wire: Wire,
        *,
        strategy: str = "round_robin",
        replication: int = 1,
        heartbeat_timeout: float = 5.0,
        seed: int = 0,
        page_cache: Optional[PageCache] = None,
        dedup_index: Optional["DedupIndex"] = None,
    ) -> None:
        self.wire = wire
        # "ring": consistent-hash placement (the default deployment
        # wiring since the elastic-membership PR); the legacy pool
        # strategies remain selectable for the §5 reproductions that
        # study them.
        self.ring: Optional[HashRing] = None
        if strategy == RING_STRATEGY:
            self.strategy: Optional[PlacementStrategy] = None
            self.ring = HashRing()
        else:
            self.strategy = STRATEGIES[strategy]
        self.replication = max(1, replication)
        self.heartbeat_timeout = heartbeat_timeout
        # Shared read-path page cache (None or budget 0 = disabled):
        # fetch_pages serves hits locally and single-flights concurrent
        # fetches of the same page.  delete_pages invalidates through it.
        self.page_cache = page_cache
        # Content-hash index (None = no dedup deployment): delete_pages
        # unindexes through it so a digest match can never resurrect a
        # deleted page.
        self.dedup_index = dedup_index
        self._providers: Dict[str, DataProvider] = {}
        self._lock = threading.RLock()
        # Per-blob placement policies (default: deployment replication).
        self._blob_policies: Dict[str, PlacementPolicy] = {}
        # Relocation overlay: physical page/shard id -> provider ids now
        # holding it.  Repair and lifecycle demotion move bytes without
        # rewriting published (immutable) descriptors; readers consult
        # the overlay via :meth:`locate` only after the descriptor's
        # replica list is exhausted, and ``delete_pages`` expands through
        # it so a relocated copy never outlives its sweep.
        self._relocations: Dict[str, Tuple[str, ...]] = {}
        # Elastic-membership state.  ``_ring_keys`` maps page_id -> the
        # deterministic placement key its group was derived from (a
        # per-blob allocation sequence, NOT the globally-counted page id
        # — same-seed replays must place identically even though the
        # page-id counter keeps running across runs in one process).
        # ``_draining`` holds members mid-drain (out of the ring and the
        # placement pool, still serving); ``_departed`` members that
        # completed a drain and deregistered — their deletes are no-ops,
        # not retriable misses (the drain's final sweep emptied them).
        self._ring_keys: Dict[str, str] = {}
        self._alloc_seq: Dict[str, int] = {}
        self._draining: set = set()
        self._departed: set = set()
        # Flash-crowd bookkeeping: per-logical-page read tallies and
        # per-provider served-read load (the rpc counters hot-spot
        # detection reads), plus the widened-replica overlay merged into
        # every fetch's candidate list.
        self._read_tally: Dict[str, int] = {}
        self._served_reads: Dict[str, int] = {}
        self._widened: Dict[str, Tuple[str, ...]] = {}
        self._rr_next = 0
        self._rr_lock = threading.Lock()
        self._rng = random.Random(seed)
        self._ctr_lock = threading.Lock()
        self.read_rounds = 0  # batched provider round trips issued
        self.read_pages = 0   # logical page reads served
        self.sweep_rounds = 0  # batched per-endpoint delete round trips
        self.swept_pages = 0   # page replicas actually freed
        self.write_rounds = 0  # batched per-endpoint store round trips
        self.write_pages = 0   # page replicas stored
        self.repair_pages = 0  # physical copies restored by repair plane
        self.repair_bytes = 0  # wire bytes moved by repair/demotion
        self.locate_lookups = 0  # relocation-overlay fallbacks on reads
        self.migrated_pages = 0  # physical copies moved by ring rebalance
        self.migrated_bytes = 0  # wire bytes of those moves (payload + cmd)
        self.migrated_payload_bytes = 0  # payload-only bytes landed on new owners
        self.widened_pages = 0   # flash-crowd replica copies added
        self.widened_bytes = 0   # wire bytes those copies cost
        self.promoted_pages = 0  # cold->hot promotions (lifecycle plane)
        self.promoted_bytes = 0  # wire bytes those promotions moved

    def rpc_counters(self) -> Dict[str, int]:
        """Data-plane round-trip/page counters (``provider_*`` in the
        deployment's ``rpc_report``)."""
        with self._ctr_lock:
            return {
                "read_rounds": self.read_rounds,
                "read_pages": self.read_pages,
                "sweep_rounds": self.sweep_rounds,
                "swept_pages": self.swept_pages,
                "write_rounds": self.write_rounds,
                "write_pages": self.write_pages,
                "repair_pages": self.repair_pages,
                "repair_bytes": self.repair_bytes,
                "locate_lookups": self.locate_lookups,
                "migrated_pages": self.migrated_pages,
                "migrated_bytes": self.migrated_bytes,
                "migrated_payload_bytes": self.migrated_payload_bytes,
                "widened_pages": self.widened_pages,
                "widened_bytes": self.widened_bytes,
                "promoted_pages": self.promoted_pages,
                "promoted_bytes": self.promoted_bytes,
            }

    def reset_counters(self) -> None:
        with self._ctr_lock:
            self.read_rounds = self.read_pages = 0
            self.sweep_rounds = self.swept_pages = 0
            self.write_rounds = self.write_pages = 0
            self.repair_pages = self.repair_bytes = 0
            self.locate_lookups = 0
            self.migrated_pages = self.migrated_bytes = 0
            self.migrated_payload_bytes = 0
            self.widened_pages = self.widened_bytes = 0
            self.promoted_pages = self.promoted_bytes = 0

    def note_migration(self, pages: int, nbytes: int,
                       payload_bytes: int = 0) -> None:
        """Migration-plane accounting hook (``provider_migrated_*``)."""
        with self._ctr_lock:
            self.migrated_pages += pages
            self.migrated_bytes += nbytes
            self.migrated_payload_bytes += payload_bytes

    def note_promotion(self, pages: int, nbytes: int) -> None:
        """Cold->hot promotion accounting (``provider_promoted_*``)."""
        with self._ctr_lock:
            self.promoted_pages += pages
            self.promoted_bytes += nbytes

    def note_repair(self, pages: int, nbytes: int) -> None:
        """Repair-plane accounting hook (``provider_repair_*``)."""
        with self._ctr_lock:
            self.repair_pages += pages
            self.repair_bytes += nbytes

    # -- placement policy ---------------------------------------------------------
    def set_blob_policy(self, blob_id: str, spec) -> PlacementPolicy:
        """Select ``"rep:N"`` / ``"ec:K+M"`` placement for one blob's
        *future* pages (already-stored pages keep their layout — ids are
        self-describing)."""
        policy = parse_policy(spec)
        if isinstance(policy, ErasureCodedPolicy):
            width = policy.k + policy.m
            if len(self.placement_pool()) < width:
                raise RuntimeError(
                    f"ec:{policy.k}+{policy.m} needs {width} distinct live "
                    f"providers, have {len(self.placement_pool())}")
        with self._lock:
            self._blob_policies[blob_id] = policy
        return policy

    def policy_for(self, blob_id: Optional[str]) -> PlacementPolicy:
        with self._lock:
            policy = self._blob_policies.get(blob_id) if blob_id else None
        return policy if policy is not None else _DEFAULT_POLICY

    # -- relocation overlay -------------------------------------------------------
    def record_relocation(self, phys_id: str, providers: Sequence[str]) -> None:
        with self._lock:
            self._relocations[phys_id] = tuple(dict.fromkeys(providers))

    def relocated(self, phys_id: str) -> Tuple[str, ...]:
        """Overlay peek without wire cost (repair/GC internals)."""
        with self._lock:
            return self._relocations.get(phys_id, ())

    def locate(self, phys_id: str, peer: Optional[str] = None) -> Tuple[str, ...]:
        """Wire-accounted overlay lookup at the provider-manager
        endpoint: where did repair/demotion move this physical page?
        Readers call this once per page, only after the descriptor's
        replica list is exhausted (the overlay is empty for the vast
        majority of pages, so the common read path never pays it)."""
        self.wire.transfer(self.PM_ENDPOINT, PM_LOCATE_REQ_BYTES,
                           inbound=False, peer=peer, async_peer=True)
        with self._ctr_lock:
            self.locate_lookups += 1
        return self.relocated(phys_id)

    PM_ENDPOINT = "pmgr"

    # -- membership -------------------------------------------------------------
    def register(self, provider: DataProvider) -> None:
        with self._lock:
            self._providers[provider.pid] = provider
            self._departed.discard(provider.pid)
            self._draining.discard(provider.pid)
            # hot endpoints join the placement ring; cold endpoints only
            # ever receive lifecycle demotions, never ring placement
            if self.ring is not None and getattr(provider, "tier",
                                                 "hot") == "hot":
                self.ring.add(provider.pid)

    def deregister(self, pid: str) -> None:
        with self._lock:
            self._providers.pop(pid, None)
            if self.ring is not None:
                self.ring.remove(pid)

    def mark_draining(self, pid: str) -> None:
        """Take ``pid`` out of the ring and the placement pool while it
        keeps serving reads — the first half of a drain (the membership
        announcement crosses the wire; the data moves in budgeted
        migration rounds, see ``core/membership.py``)."""
        self.wire.transfer(self.PM_ENDPOINT, RING_ANNOUNCE_BYTES,
                           inbound=True, async_peer=True)
        with self._lock:
            self._draining.add(pid)
            if self.ring is not None:
                self.ring.remove(pid)

    def finish_drain(self, pid: str) -> None:
        """Deregister a fully-migrated member.  Departed ids are
        remembered so a later GC sweep treats their (already emptied)
        copies as freed instead of eternally-pending misses."""
        with self._lock:
            self._providers.pop(pid, None)
            self._draining.discard(pid)
            self._departed.add(pid)

    def is_draining(self, pid: str) -> bool:
        with self._lock:
            return pid in self._draining

    def announce_join(self, pid: str) -> None:
        """Wire cost of a join's membership broadcast (the ring update
        itself happens in :meth:`register`)."""
        self.wire.transfer(self.PM_ENDPOINT, RING_ANNOUNCE_BYTES,
                           inbound=True, async_peer=True)

    def alive_providers(self) -> List[DataProvider]:
        with self._lock:
            return [p for p in self._providers.values() if not self.wire.is_down(p.pid)]

    def placement_pool(self) -> List[DataProvider]:
        """Alive providers eligible for *new-page* placement: the hot
        tier.  Cold endpoints only receive lifecycle demotions.  With no
        hot provider alive the pool degrades to every alive endpoint —
        availability beats tiering policy."""
        alive = [p for p in self.alive_providers()
                 if p.pid not in self._draining]
        hot = [p for p in alive if getattr(p, "tier", "hot") == "hot"]
        return hot if hot else alive

    def all_providers(self) -> List[DataProvider]:
        with self._lock:
            return list(self._providers.values())

    def get(self, pid: str) -> DataProvider:
        with self._lock:
            return self._providers[pid]

    def n_alive(self) -> int:
        return len(self.alive_providers())

    # -- placement ---------------------------------------------------------------
    def place_key(self, page_id: str) -> str:
        """The deterministic ring-placement key of a stored page.

        Pages allocated through :meth:`allocate` were keyed by a
        per-blob sequence number recorded at allocation time; anything
        else (pages predating the ring, restored deployments) falls
        back to the page id itself — still a pure function of ring
        state within one run, which is all migration planning needs."""
        with self._lock:
            return self._ring_keys.get(page_id, page_id)

    def ring_owners(self, key: str, width: int,
                    extra_exclude: Sequence[str] = ()) -> List[str]:
        """The ``width`` ring owners of placement key ``key`` among the
        currently-eligible (alive, hot, not draining) members."""
        if self.ring is None:
            raise RuntimeError("ring placement is not enabled")
        eligible = {p.pid for p in self.placement_pool()} - set(extra_exclude)
        return self.ring.owners(key, width, eligible)

    def allocate(self, n_pages: int,
                 blob_id: Optional[str] = None,
                 page_ids: Optional[Sequence[str]] = None,
                 ) -> List[List[DataProvider]]:
        """Pick a provider group for each of ``n_pages`` under the
        blob's placement policy.

        Paper Alg 2 line 2: "PP <- the list of n page providers".  Under
        replication each entry is a replica group of ``width`` distinct
        endpoints (when enough providers are alive); under erasure
        coding the group is *positional* — ``group[j]`` will hold shard
        ``j`` — and ``k + m`` distinct live providers are required
        outright (fewer would co-locate shards and void the fault
        tolerance the parity pays for).

        Under ring placement the group is the page's consistent-hash
        owner set: ``page_ids`` (when supplied) pin each page's
        placement key — a per-blob allocation sequence — so the same
        seed replays to the same layout and a later join/drain can
        recompute exactly which pages it owes or is owed.
        """
        policy = self.policy_for(blob_id)
        width = policy.width(self.replication)
        strict = isinstance(policy, ErasureCodedPolicy)
        alive = self.placement_pool()
        if strict and len(alive) < width:
            raise EndpointDown(
                f"ec placement needs {width} live providers, "
                f"have {len(alive)}")
        if self.ring is not None:
            return self._allocate_ring(n_pages, blob_id, page_ids,
                                       width, strict)
        primaries = self.strategy(self, n_pages)
        groups: List[List[DataProvider]] = []
        for prim in primaries:
            group = [prim]
            if width > 1 and len(alive) > 1:
                # deterministic walk from the primary for replica diversity
                idx = alive.index(prim) if prim in alive else 0
                k = 1
                while len(group) < min(width, len(alive)):
                    cand = alive[(idx + k) % len(alive)]
                    if cand not in group:
                        group.append(cand)
                    k += 1
            groups.append(group)
        return groups

    def _allocate_ring(self, n_pages: int, blob_id: Optional[str],
                       page_ids: Optional[Sequence[str]],
                       width: int, strict: bool) -> List[List[DataProvider]]:
        if not self.placement_pool():
            raise RuntimeError("no alive providers")
        groups: List[List[DataProvider]] = []
        with self._lock:
            seq0 = self._alloc_seq.get(blob_id or "_", 0)
            self._alloc_seq[blob_id or "_"] = seq0 + n_pages
            for i in range(n_pages):
                key = f"{blob_id or '_'}#{seq0 + i}"
                if page_ids is not None:
                    self._ring_keys[page_ids[i]] = key
                groups.append(key)  # resolved below, outside the lock
        eligible = {p.pid for p in self.placement_pool()}
        out: List[List[DataProvider]] = []
        for key in groups:
            owner_ids = self.ring.owners(key, width, eligible)
            if strict and len(owner_ids) < width:
                raise EndpointDown(
                    f"ec placement needs {width} live providers, "
                    f"ring offered {len(owner_ids)}")
            if not owner_ids:
                raise RuntimeError("no alive providers on the ring")
            with self._lock:
                out.append([self._providers[pid] for pid in owner_ids])
        return out

    # -- replicated page IO ---------------------------------------------------------
    def store_page(
        self,
        group: Sequence[DataProvider],
        page_id: str,
        payload: bytes,
        peer: Optional[str] = None,
    ) -> List[str]:
        """Store ``payload`` on every replica; return provider ids that hold it.
        Single-page facade over :meth:`store_pages` (same batching,
        failover and accounting)."""
        locations, _done = self.store_pages([(group, page_id, payload)],
                                            peer=peer)
        return locations[0]

    def store_pages(
        self,
        puts: Sequence[Tuple[Sequence[DataProvider], str, bytes]],
        peer: Optional[str] = None,
    ) -> Tuple[List[List[str]], float]:
        """Grouped, pipelined store of many pages (the write-plane
        mirror of :meth:`fetch_pages`).

        ``puts`` holds ``(replica_group, page_id, payload)`` tuples; all
        page replicas bound for one provider endpoint coalesce into ONE
        batched round trip (one latency charge + summed bytes) instead
        of paying per-page latency.  Under a **virtual clock** the
        per-endpoint batches are issued fire-and-forget so they overlap
        each other *and* whatever the writer does next (version
        assignment, border prefetch, metadata puts); the returned
        ``done_at`` is the store-durability barrier the writer sleeps
        to before signalling ``metadata_complete`` — a snapshot never
        publishes before its pages have arrived.  Under the wall clock
        the batches block as ordinary transfers and ``done_at`` is 0.0.

        Failure semantics match :meth:`store_page` per page: a downed
        endpoint just loses that replica; a page with *no* surviving
        replica raises :class:`EndpointDown`.  Returns
        ``(locations, done_at)`` where ``locations[i]`` lists the
        provider ids now holding page ``i``.
        """
        by_prov: Dict[str, List[Tuple[int, str, bytes]]] = {}
        prov_of: Dict[str, DataProvider] = {}
        need: Dict[int, int] = {}            # min physical copies for success
        ec_groups: Dict[int, List[str]] = {}  # positional EC locations
        for i, (group, page_id, payload) in enumerate(puts):
            codec = page_codec(page_id)
            if codec is None:
                need[i] = 1
                for prov in group:
                    by_prov.setdefault(prov.pid, []).append(
                        (i, page_id, payload))
                    prov_of[prov.pid] = prov
                continue
            # Erasure-coded page: shard j goes to group[j] (positional).
            # The descriptor records the FULL group — a position whose
            # put failed is simply a missing shard the read path decodes
            # around; fewer than k arrivals means the page is not
            # durable and the store must fail.
            k, m = codec
            if len(group) < k + m:
                raise EndpointDown(
                    f"ec page {page_id} needs {k + m} providers, "
                    f"group has {len(group)}")
            need[i] = k
            ec_groups[i] = [prov.pid for prov in group[:k + m]]
            for j, shard in enumerate(ec_encode(payload, k, m)):
                prov = group[j]
                by_prov.setdefault(prov.pid, []).append(
                    (i, shard_id(page_id, j), shard))
                prov_of[prov.pid] = prov
        virtual = self.wire.clock.is_virtual
        stored: Dict[int, List[str]] = {i: [] for i in range(len(puts))}
        errors: List[Exception] = []
        done_at = 0.0
        rounds = replicas = 0
        for pid in sorted(by_prov):
            batch = by_prov[pid]
            try:
                d = prov_of[pid].put_pages(
                    [(page_id, payload) for _i, page_id, payload in batch],
                    peer=peer, fire_and_forget=virtual,
                )
            except EndpointDown as e:  # failure injection
                errors.append(e)
                continue
            done_at = max(done_at, d if virtual else 0.0)
            rounds += 1
            replicas += len(batch)
            for i, _page_id, _payload in batch:
                stored[i].append(pid)
        for i, (_group, page_id, _payload) in enumerate(puts):
            if not stored[i]:
                raise EndpointDown(
                    f"all replicas down for page {page_id}: {errors}")
            if len(stored[i]) < need[i]:
                raise EndpointDown(
                    f"only {len(stored[i])}/{need[i]} shards stored for "
                    f"page {page_id}: {errors}")
        with self._ctr_lock:
            self.write_rounds += rounds
            self.write_pages += replicas
        return [ec_groups.get(i, stored[i]) for i in range(len(puts))], done_at

    def fetch_page(
        self,
        provider_ids: Sequence[str],
        page_id: str,
        off: int = 0,
        length: Optional[int] = None,
        peer: Optional[str] = None,
    ) -> bytes:
        """Read one page range; the single-page facade over
        :meth:`fetch_pages` (same cache, balancing and failover)."""
        return self.fetch_pages([(provider_ids, page_id, off, length)],
                                peer=peer)[0]

    def _pick_replica(
        self,
        candidates: List[DataProvider],
        outstanding: Dict[str, int],
        est_bytes: int,
    ) -> DataProvider:
        """Least-projected-load replica for one request of a fetch wave.

        Projected completion = the endpoint's simulated busy horizon
        plus the bytes this wave has already routed to it.  Spreading by
        outstanding bytes (instead of sorting every request by the same
        pre-wave queue depth) keeps a hot page set from dogpiling one
        replica: within a wave each assignment sees the load the earlier
        assignments created.  The pid tie-break keeps virtual-clock
        replays deterministic.
        """
        bw = self.wire.bandwidth

        def projected(p: DataProvider) -> Tuple[float, str]:
            busy = self.wire.stats(p.pid).sim_busy_until
            return (busy + outstanding.get(p.pid, 0) / bw, p.pid)

        best = min(candidates, key=projected)
        outstanding[best.pid] = outstanding.get(best.pid, 0) + est_bytes
        return best

    @staticmethod
    def _sort_key(key) -> Tuple[str, int, int]:
        pid, off, length = key
        return (pid, off, -1 if length is None else length)

    def fetch_pages(
        self,
        requests: Sequence[Tuple[Sequence[str], str, int, Optional[int]]],
        peer: Optional[str] = None,
        prefetch: Sequence[Tuple[Sequence[str], str, int, Optional[int]]] = (),
    ) -> List[bytes]:
        """Cached, load-balanced, grouped read of many pages.

        ``requests`` holds ``(provider_ids, page_id, off, length)``
        tuples; the result list matches the request order.  The shared
        :class:`~repro.core.cache.PageCache` (when enabled) is consulted
        first: hits are served locally (counted as
        ``wire.note_local_hit``, never as provider RPCs), keys already
        in flight from another reader are *waited on* (single-flight:
        one RPC per page no matter how many concurrent readers), and
        only true misses go to the providers.

        Misses targeting the same provider endpoint coalesce into ONE
        batched round trip, and each page's replica is chosen by
        projected outstanding bytes (see :meth:`_pick_replica`) instead
        of always hitting the same primary.  Failover is per page: a
        downed provider — or a per-page miss — re-routes just the
        affected requests to an untried replica in the following wave;
        ``EndpointDown`` is raised only when a required page exhausts
        its replicas.

        ``prefetch`` lists extra whole-page requests to pull into the
        cache (sibling pages from the caller's segment-tree descent).
        Prefetches piggyback on a required page's per-endpoint batch
        when they co-locate; prefetch-only batches go out
        *fire-and-forget* — the wire is charged, the caller never
        blocks, and the cache records the arrival instant so a later
        reader of that page gates on it instead of time-travelling.
        Prefetches are best-effort: dropped silently when already
        cached/in flight or when every replica fails, and their bytes
        are never returned.
        """
        cache = self.page_cache
        if cache is not None and not cache.enabled:
            cache = None

        key_of: List[Tuple[str, int, Optional[int]]] = []
        units: Dict[Tuple[str, int, Optional[int]], Sequence[str]] = {}
        for pids, page_id, off, length in requests:
            key = (page_id, off, length)
            key_of.append(key)
            units.setdefault(key, pids)

        value_by_key: Dict[Tuple[str, int, Optional[int]], bytes] = {}
        if cache is None:
            fetched = self._fetch_units(units, peer, cache=None)
            value_by_key.update(fetched)
            return [value_by_key[k] for k in key_of]

        arrival = 0.0  # latest in-flight-prefetch instant we must gate on
        hits, leaders, waiters = cache.claim(list(units))
        for key, (data, ready_at) in hits.items():
            self.wire.note_local_hit(len(data))
            value_by_key[key] = data
            arrival = max(arrival, ready_at)

        pf_units: Dict[Tuple[str, int, Optional[int]], Sequence[str]] = {}
        for pids, page_id, off, length in prefetch:
            key = (page_id, off, length)
            if key not in units and key not in pf_units:
                pf_units[key] = pids
        _pf_hits, pf_leaders, _pf_waiters = cache.claim(list(pf_units),
                                                        count=False)
        # prefetch hits/waiters need nothing: the page is (or will be)
        # resident; only this caller's prefetch leaders are fetched.

        fetched = self._fetch_units(
            {k: units[k] for k in leaders}, peer, cache=cache,
            best_effort={k: pf_units[k] for k in pf_leaders},
        )
        value_by_key.update(fetched)

        for key in waiters:
            while key not in value_by_key:
                entry = cache.wait(key)
                if entry is not None:
                    self.wire.note_local_hit(len(entry[0]))
                    value_by_key[key] = entry[0]
                    arrival = max(arrival, entry[1])
                    break
                # leader abandoned (its replicas failed); re-claim and
                # retry with our own replica list
                h2, l2, _w2 = cache.claim([key])
                if key in h2:
                    self.wire.note_local_hit(len(h2[key][0]))
                    value_by_key[key] = h2[key][0]
                    arrival = max(arrival, h2[key][1])
                elif l2:
                    value_by_key.update(self._fetch_units(
                        {key: units[key]}, peer, cache=cache))
        clock = self.wire.clock
        if arrival > 0.0 and clock.is_virtual and arrival > clock.now():
            # a hit on bytes still in flight (async prefetch): wait for
            # the transfer the wire already scheduled to complete
            clock.sleep_until(arrival)
        return [value_by_key[k] for k in key_of]

    def _fetch_units(
        self,
        units: Dict[Tuple[str, int, Optional[int]], Sequence[str]],
        peer: Optional[str],
        cache: Optional[PageCache],
        best_effort: Optional[Dict[Tuple[str, int, Optional[int]],
                                   Sequence[str]]] = None,
    ) -> Dict[Tuple[str, int, Optional[int]], bytes]:
        """Route unit fetches by page codec: replicated units take the
        per-endpoint wave path (:meth:`_fetch_plain`), erasure-coded
        units (self-describing ``-ecK+M`` page ids) take the
        shard/decode path (:meth:`_fetch_ec`).  Both resolve every
        cache claim they own; a failure in the plain leg abandons the
        EC leg's claims so single-flight waiters never block forever.
        """
        best_effort = best_effort or {}
        ec_u = {k: v for k, v in units.items()
                if page_codec(k[0]) is not None}
        ec_b = {k: v for k, v in best_effort.items()
                if page_codec(k[0]) is not None}
        if not ec_u and not ec_b:
            return self._fetch_plain(units, peer, cache, best_effort)
        plain_u = {k: v for k, v in units.items() if k not in ec_u}
        plain_b = {k: v for k, v in best_effort.items() if k not in ec_b}
        out: Dict[Tuple[str, int, Optional[int]], bytes] = {}
        try:
            if plain_u or plain_b:
                out.update(self._fetch_plain(plain_u, peer, cache, plain_b))
        except BaseException:
            if cache is not None:
                for key in list(ec_u) + list(ec_b):
                    cache.abandon(key)
            raise
        out.update(self._fetch_ec(ec_u, peer, cache, ec_b))
        return out

    def _fetch_plain(
        self,
        units: Dict[Tuple[str, int, Optional[int]], Sequence[str]],
        peer: Optional[str],
        cache: Optional[PageCache],
        best_effort: Optional[Dict[Tuple[str, int, Optional[int]],
                                   Sequence[str]]] = None,
    ) -> Dict[Tuple[str, int, Optional[int]], bytes]:
        """Fetch unique page units in per-endpoint batched waves.

        ``units`` are required (exhausting their replicas raises);
        ``best_effort`` units (prefetch) just get dropped.  Every unit
        claimed in ``cache`` is resolved (fill or abandon) even when an
        error propagates — single-flight waiters never block forever.

        A unit that exhausts its descriptor's replicas consults the
        relocation overlay ONCE (:meth:`locate`) before failing: repair
        and lifecycle demotion move bytes without rewriting published
        descriptors, so the overlay is where a moved page actually
        lives.
        """
        best_effort = best_effort or {}
        required = set(units)
        # unit key -> untried replica providers
        pending: Dict[Tuple[str, int, Optional[int]], List[DataProvider]] = {}
        with self._lock:
            for key, pids in list(units.items()) + list(best_effort.items()):
                # flash-crowd mitigation: widened replicas join the
                # candidate list up front, so _pick_replica's projected-
                # load balancing spreads the crowd across them (the
                # overlay-after-exhaustion path is for *moved* bytes;
                # widened copies are extra, not replacements)
                cand = list(pids)
                for extra in self._widened.get(logical_pid(key[0]), ()):
                    if extra not in cand:
                        cand.append(extra)
                pending[key] = [self._providers[p] for p in cand
                                if p in self._providers]
        tried: Dict[Tuple[str, int, Optional[int]], set] = {
            key: set() for key in pending}
        # last overlay snapshot + lookup count per unit: a reader that
        # exhausts its replicas consults the relocation overlay, and —
        # because migration can move a page AGAIN while the reader is
        # in flight (join/drain runs concurrently with reads) — it may
        # re-consult as long as the overlay keeps CHANGING, chasing the
        # per-page configuration pointer to wherever the copy landed.
        # A page that is simply gone pays one lookup and fails as
        # before (unchanged snapshot = no retry).
        located: Dict[Tuple[str, int, Optional[int]], Tuple[str, ...]] = {}
        relocates: Dict[Tuple[str, int, Optional[int]], int] = {}
        out: Dict[Tuple[str, int, Optional[int]], bytes] = {}
        errors: Dict[Tuple[str, int, Optional[int]], Exception] = {}
        try:
            while pending:
                by_prov: Dict[str, List[Tuple[str, int, Optional[int]]]] = {}
                prov_of: Dict[str, DataProvider] = {}
                outstanding: Dict[str, int] = {}
                for key in sorted(pending, key=self._sort_key):
                    provs = pending[key]
                    if not provs and relocates.get(key, 0) < _MAX_RELOCATES:
                        relocates[key] = relocates.get(key, 0) + 1
                        with self._lock:
                            known = dict(self._providers)
                        snap = tuple(self.locate(key[0], peer=peer))
                        prev = located.get(key)
                        located[key] = snap
                        if prev is None:
                            extra = [known[hid] for hid in snap
                                     if hid in known
                                     and hid not in tried[key]]
                            if not extra and snap:
                                # every overlay holder was already
                                # tried — but the copy may have LANDED
                                # on one after our attempt (a migration
                                # raced this fetch): retry them
                                extra = [known[hid] for hid in snap
                                         if hid in known]
                        elif snap != prev:
                            # the pointer flipped since we last looked:
                            # a previously-tried endpoint may hold the
                            # copy now, so everything is fair game again
                            extra = [known[hid] for hid in snap
                                     if hid in known]
                        else:
                            extra = []
                        if extra:
                            pending[key] = extra
                            provs = extra
                    if not provs:
                        if key in required:
                            raise EndpointDown(
                                f"no replica served page {key[0]}: "
                                f"{errors.get(key)}"
                            )
                        del pending[key]        # prefetch: drop silently
                        if cache is not None:
                            cache.abandon(key)
                        continue
                    est = key[2] if key[2] is not None else _WHOLE_PAGE_EST
                    chosen = self._pick_replica(provs, outstanding, est)
                    provs.remove(chosen)
                    tried[key].add(chosen.pid)
                    by_prov.setdefault(chosen.pid, []).append(key)
                    prov_of[chosen.pid] = chosen
                for pid in sorted(by_prov):
                    keys = by_prov[pid]
                    batch = [(k[0], k[1], k[2]) for k in keys]
                    # prefetch-only batches fire-and-forget: the wire is
                    # charged, the issuer does not block, and the cache
                    # records when the bytes arrive
                    fire = all(k not in required for k in keys)
                    try:
                        results = prov_of[pid].get_pages(
                            batch, peer=peer, fire_and_forget=fire)
                    except EndpointDown as e:
                        for k in keys:
                            errors[k] = e
                        continue            # untried replicas next wave
                    ready_at = (self.wire.stats(pid).sim_busy_until
                                if fire else 0.0)
                    served = 0
                    served_logicals: List[str] = []
                    for k, res in zip(keys, results):
                        if isinstance(res, Exception):
                            errors[k] = res
                        else:
                            out[k] = res
                            served += 1
                            served_logicals.append(logical_pid(k[0]))
                            del pending[k]
                            if cache is not None:
                                cache.fill(k, res,
                                           prefetch=k not in required,
                                           ready_at=ready_at)
                    with self._ctr_lock:
                        self.read_rounds += 1
                        self.read_pages += served
                        # hot-spot detection inputs: which pages are
                        # being hammered, and which endpoints carry it
                        if served:
                            self._served_reads[pid] = \
                                self._served_reads.get(pid, 0) + served
                        for lg in served_logicals:
                            self._read_tally[lg] = \
                                self._read_tally.get(lg, 0) + 1
        finally:
            if cache is not None:
                for key in pending:     # unresolved claims on error exit
                    if key not in out:
                        cache.abandon(key)
        return out

    def _fetch_ec(
        self,
        units: Dict[Tuple[str, int, Optional[int]], Sequence[str]],
        peer: Optional[str],
        cache: Optional[PageCache],
        best_effort: Optional[Dict[Tuple[str, int, Optional[int]],
                                   Sequence[str]]] = None,
    ) -> Dict[Tuple[str, int, Optional[int]], bytes]:
        """Erasure-coded unit fetch: stream data shards, decode on gaps.

        EC reads are page-granular — serving any byte range needs ``k``
        shard bodies — so all units of one page are satisfied by a
        single reconstruction.  Healthy path: the ``k`` data shards
        stream whole from their home providers (pure concatenation, no
        field math).  A missing/corrupt/unreachable shard *escalates*
        the page to its parity shards and the relocation overlay; any
        ``k`` of the ``k + m`` shards reconstruct.  Fewer than ``k``
        reachable shards raises :class:`EndpointDown` for required
        units; best-effort (prefetch) units are dropped.  EC batches
        always block (prefetch too): the decode needs the bytes in
        hand before any unit can fill.
        """
        best_effort = best_effort or {}
        required = set(units)
        all_units = dict(best_effort)
        all_units.update(units)
        out: Dict[Tuple[str, int, Optional[int]], bytes] = {}
        try:
            by_page: Dict[str, List[Tuple[str, int, Optional[int]]]] = {}
            groups: Dict[str, List[str]] = {}
            for key in sorted(all_units, key=self._sort_key):
                by_page.setdefault(key[0], []).append(key)
                groups.setdefault(key[0], list(all_units[key]))
            req_pages = {pid for pid, keys in by_page.items()
                         if any(k in required for k in keys)}
            payloads = self._reconstruct_pages(groups, req_pages, peer)
            for pid in sorted(by_page):
                payload = payloads.get(pid)
                if payload is None:
                    continue    # best-effort page lost; abandoned below
                for key in by_page[pid]:
                    _p, off, length = key
                    view = (payload[off:] if length is None
                            else payload[off:off + length])
                    out[key] = view
                    if cache is not None:
                        cache.fill(key, view, prefetch=key not in required)
        finally:
            if cache is not None:
                for key in all_units:
                    if key not in out:
                        cache.abandon(key)
        return out

    def _reconstruct_pages(
        self,
        groups: Dict[str, List[str]],
        required: set,
        peer: Optional[str],
    ) -> Dict[str, bytes]:
        """Fetch >= k shards of each EC page and decode.

        ``groups[pid]`` is the page's positional provider group
        (``groups[pid][j]`` is shard ``j``'s home).  Shard requests
        bound for one endpoint coalesce into batched waves exactly like
        the replicated path, and each shard falls back to the
        relocation overlay once before counting as lost.
        """
        geom = {pid: page_codec(pid) for pid in groups}
        bodies: Dict[str, Dict[int, bytes]] = {pid: {} for pid in groups}
        pending: Dict[Tuple[str, int], List[DataProvider]] = {}
        tried: Dict[Tuple[str, int], set] = {}
        located: set = set()
        escalated: set = set()
        dead: set = set()
        errors: Dict[str, Exception] = {}
        out: Dict[str, bytes] = {}

        def add_shard(pid: str, j: int) -> None:
            skey = (pid, j)
            if skey in pending or skey in tried or j in bodies[pid]:
                return
            group = groups[pid]
            hid = group[j] if j < len(group) else None
            with self._lock:
                prov = self._providers.get(hid) if hid is not None else None
            pending[skey] = [prov] if prov is not None else []
            tried[skey] = set()

        def escalate(pid: str) -> None:
            if pid in escalated:
                return
            escalated.add(pid)
            k, m = geom[pid]
            for j in range(k + m):
                add_shard(pid, j)

        def try_decode(pid: str) -> None:
            k, m = geom[pid]
            if pid in out or len(bodies[pid]) < k:
                return
            out[pid] = ec_decode(sorted(bodies[pid].items())[:k], k, m)

        for pid in sorted(groups):
            k, _m = geom[pid]
            for j in range(k):
                add_shard(pid, j)

        while pending:
            by_prov: Dict[str, List[Tuple[str, int]]] = {}
            prov_of: Dict[str, DataProvider] = {}
            outstanding: Dict[str, int] = {}
            for skey in sorted(pending):
                pid, j = skey
                if pid in out or pid in dead:
                    del pending[skey]
                    continue
                provs = pending[skey]
                if not provs and skey not in located:
                    located.add(skey)
                    with self._lock:
                        known = dict(self._providers)
                    extra = [known[hid]
                             for hid in self.locate(shard_id(pid, j),
                                                    peer=peer)
                             if hid in known and hid not in tried[skey]]
                    if extra:
                        pending[skey] = extra
                        provs = extra
                if not provs:
                    del pending[skey]
                    escalate(pid)
                    k, _m = geom[pid]
                    avail = len(bodies[pid]) + sum(
                        1 for (p2, _j2) in pending if p2 == pid)
                    if avail < k:
                        if pid in required:
                            raise EndpointDown(
                                f"unrecoverable ec page {pid}: "
                                f"{len(bodies[pid])} of {k} shards "
                                f"reachable ({errors.get(pid)})")
                        dead.add(pid)
                    continue
                est = _WHOLE_PAGE_EST // max(1, geom[pid][0])
                chosen = self._pick_replica(provs, outstanding, est)
                provs.remove(chosen)
                tried[skey].add(chosen.pid)
                by_prov.setdefault(chosen.pid, []).append(skey)
                prov_of[chosen.pid] = chosen
            for ppid in sorted(by_prov):
                skeys = by_prov[ppid]
                batch = [(shard_id(p, j), 0, None) for p, j in skeys]
                try:
                    results = prov_of[ppid].get_pages(batch, peer=peer)
                except EndpointDown as e:
                    for p, _j in skeys:
                        errors[p] = e
                    continue        # untried candidates/overlay next wave
                served = 0
                for (p, j), res in zip(skeys, results):
                    if isinstance(res, Exception):
                        errors[p] = res
                        escalate(p)  # shard-level miss: widen to parity
                    else:
                        bodies[p][j] = bytes(res)
                        served += 1
                        pending.pop((p, j), None)
                with self._ctr_lock:
                    self.read_rounds += 1
                    self.read_pages += served
            for pid in sorted(groups):
                try_decode(pid)
        for pid in sorted(groups):
            try_decode(pid)
        for pid in sorted(required):
            if pid not in out:
                k, _m = geom[pid]
                raise EndpointDown(
                    f"unrecoverable ec page {pid}: {len(bodies[pid])} of "
                    f"{k} shards reachable ({errors.get(pid)})")
        return out

    def delete_pages(
        self,
        items: Sequence[Tuple[Sequence[str], str]],
        peer: Optional[str] = None,
    ) -> Tuple[int, int, List[str]]:
        """Grouped batched delete of many pages (GC sweep).

        ``items`` holds ``(provider_ids, page_id)`` tuples; every replica
        of every page is deleted, and all commands bound for one
        provider endpoint coalesce into ONE batched round trip — the
        sweep-side mirror of :meth:`fetch_pages`.  A downed endpoint is
        skipped (its pages are unreachable anyway); the affected page
        ids come back in ``missed`` so the caller can retry the sweep
        later — deletes are idempotent.  Returns
        ``(pages_freed, bytes_freed, missed_page_ids)``.

        Cache coherence: every page id in the batch is invalidated from
        the shared page cache (and its in-flight fetches doomed)
        *before* the first delete RPC goes out — even a page whose
        delete then fails is conservatively dropped, so a cached page
        can never outlive its sweep.
        """
        logicals = dict.fromkeys(
            split_shard(page_id)[0] if split_shard(page_id) else page_id
            for _pids, page_id in items)
        if self.page_cache is not None:
            self.page_cache.invalidate_pages(logicals)
        # Index coherence mirrors cache coherence: unindex before the
        # first delete RPC (local hook, rides the delete round) so no
        # entry outlives its bytes.
        if self.dedup_index is not None:
            self.dedup_index.forget_pages(logicals)
        # Expand logical page ids into physical store ids: an EC page
        # fans out into its positional shards, and the relocation
        # overlay adds any copies repair/demotion moved elsewhere (so a
        # relocated copy never outlives its sweep).  Raw shard ids (the
        # GC orphan scan passes what providers actually listed) pass
        # through unexpanded.
        phys_items: List[Tuple[str, str, str]] = []  # (prov, phys, logical)
        with self._lock:
            for pids, page_id in items:
                codec = page_codec(page_id)
                if codec is None or split_shard(page_id) is not None:
                    targets = [(pid, page_id) for pid in pids]
                    targets.extend((hid, page_id) for hid
                                   in self._relocations.get(page_id, ()))
                else:
                    k, m = codec
                    targets = [(pid, shard_id(page_id, j))
                               for j, pid in enumerate(pids)]
                    for j in range(k + m):
                        sid = shard_id(page_id, j)
                        targets.extend((hid, sid) for hid
                                       in self._relocations.get(sid, ()))
                for prov_id, phys in targets:
                    phys_items.append((prov_id, phys, page_id))
        by_prov: Dict[str, List[str]] = {}
        prov_of: Dict[str, DataProvider] = {}
        missed: List[str] = []
        logical_of: Dict[Tuple[str, str], str] = {}
        with self._lock:
            for prov_id, phys, logical in dict.fromkeys(phys_items):
                p = self._providers.get(prov_id)
                if p is None:
                    if prov_id in self._departed:
                        # cleanly-drained member: its store was emptied
                        # by the drain's final sweep, so this copy is
                        # already gone — treating it as a retriable miss
                        # would leave the version pending forever
                        continue
                    # deregistered endpoint: same contract as a downed
                    # one — report the page so the sweep stays pending
                    # and retries after the provider (re)registers
                    missed.append(logical)
                    continue
                by_prov.setdefault(prov_id, []).append(phys)
                logical_of[(prov_id, phys)] = logical
                prov_of[prov_id] = p
        freed_pages = freed_bytes = 0
        done_phys: set = set()
        failed_phys: set = set()
        for prov_id, page_ids in by_prov.items():
            try:
                n, nbytes = prov_of[prov_id].delete_pages(page_ids, peer=peer)
            except EndpointDown:
                missed.extend(logical_of[(prov_id, ph)] for ph in page_ids)
                failed_phys.update(page_ids)
                continue
            done_phys.update(page_ids)
            freed_pages += n
            freed_bytes += nbytes
            with self._ctr_lock:
                self.sweep_rounds += 1
                self.swept_pages += n
        # Overlay hygiene: a relocated copy whose every delete landed is
        # gone for good; partially-failed ones stay mapped for the retry.
        with self._lock:
            for phys in done_phys - failed_phys:
                self._relocations.pop(phys, None)
        return freed_pages, freed_bytes, list(dict.fromkeys(missed))

    # -- failure handling -------------------------------------------------------------
    def check_heartbeats(self) -> List[str]:
        """Mark providers that missed their heartbeat window as down."""
        now = self.wire.clock.now()
        dead = []
        with self._lock:
            for p in self._providers.values():
                if now - p.last_heartbeat > self.heartbeat_timeout and not self.wire.is_down(p.pid):
                    self.wire.set_down(p.pid, True)
                    dead.append(p.pid)
        return dead

    def rereplicate_from(
        self, failed_pid: str, page_locations: Dict[str, List[str]]
    ) -> Tuple[int, List[str]]:
        """Restore replication for every page the failed provider held.

        ``page_locations`` maps page_id -> current replica provider ids
        (the metadata layer owns this map; see ``blob.BlobClient``).
        Returns ``(moved, losses)``: the number of pages re-replicated
        and the page ids with *no* serving replica.  An unrecoverable
        page never aborts the sweep — every later page still gets its
        replica back, and the losses list is what the scrub plane
        surfaces for operators (raising here used to strand the whole
        remainder of the failed node's page set un-repaired).  Mutates
        the map in place with the new replica locations and records
        each move in the relocation overlay so reads holding older
        descriptors still find the bytes.

        Reads go *directly* to the surviving providers, bypassing the
        page cache: maintenance traffic must not occupy the reader
        budget (nor count in the reader-facing hit/miss accounting),
        and a mass re-replication sweeping a failed node's pages
        through the LRU would evict the hot set.
        """
        moved = 0
        losses: List[str] = []
        refreshed: List[Tuple[str, Tuple[str, ...]]] = []
        for page_id in sorted(page_locations):
            locs = page_locations[page_id]
            if failed_pid not in locs:
                continue
            survivors = [l for l in locs if l != failed_pid and not self.wire.is_down(l)]
            payload = None
            last_err: Optional[Exception] = None
            for spid in survivors:
                with self._lock:
                    prov = self._providers.get(spid)
                if prov is None:
                    continue
                try:
                    payload = prov.get_page(page_id)
                    break
                except (EndpointDown, KeyError, PageIntegrityError) as e:
                    last_err = e
            if payload is None:
                # data loss (no survivor listed, or none served): record
                # it and keep sweeping — the scrub plane surfaces losses
                losses.append(page_id)
                continue
            candidates = [p for p in self.placement_pool()
                          if p.pid not in locs]
            if not candidates:
                continue
            target = min(candidates, key=lambda p: (p.page_count(), p.pid))
            target.put_page(page_id, payload)
            locs.remove(failed_pid)
            locs.append(target.pid)
            self.record_relocation(page_id, locs)
            refreshed.append((page_id, tuple(locs)))
            self.note_repair(1, 2 * len(payload))
            moved += 1
        # stale-descriptor hygiene: dedup hits must stop handing out the
        # dead provider (batched refresh verb; no-op pre-first-register)
        if self.dedup_index is not None and refreshed:
            if getattr(self.dedup_index, "ever_registered", False):
                self.dedup_index.refresh_providers(refreshed)
        return moved, losses

    # -- flash-crowd mitigation ---------------------------------------------
    def read_load(self) -> Dict[str, int]:
        """Cumulative served-read count per provider endpoint — the
        per-endpoint load distribution the flash-crowd bench's p-load
        gate compares across runs (NOT cleared by a tally reset, so
        mitigated and unmitigated twins stay comparable)."""
        with self._ctr_lock:
            return dict(self._served_reads)

    def read_tallies(self) -> Dict[str, int]:
        """Served-read count per logical page since the last reset."""
        with self._ctr_lock:
            return dict(self._read_tally)

    def hot_pages(self, threshold: int) -> List[Tuple[str, int]]:
        """Logical pages whose tally reached ``threshold``, hottest
        first (page-id tie-break keeps replays deterministic)."""
        with self._ctr_lock:
            items = [(pid, n) for pid, n in self._read_tally.items()
                     if n >= threshold]
        return sorted(items, key=lambda it: (-it[1], it[0]))

    def reset_read_tallies(self) -> None:
        """Clear the per-page tallies so each mitigation interval's
        crowd is judged on its own (the per-endpoint ``read_load``
        stays cumulative)."""
        with self._ctr_lock:
            self._read_tally.clear()

    def widened(self, page_id: str) -> Tuple[str, ...]:
        with self._lock:
            return self._widened.get(page_id, ())

    def widen_page(self, page_id: str, holders: Sequence[str],
                   extra: int = 1, peer: Optional[str] = None,
                   ) -> Tuple[str, ...]:
        """Widen a hot replicated page's replica set by ``extra`` copies.

        The new holders are the page's *next* ring owners past its
        current replica group (deterministic — any node can compute
        them), the copy itself is a wire move (read from a live holder,
        put to each target, plus a widening command per copy), and the
        widened set lands in both the relocation overlay (so scrub/GC
        see the extra copies) and the ``_widened`` read-side overlay
        (so fetch waves balance across them immediately).  Returns the
        page's full holder set after widening; a page that cannot be
        widened (EC, no live holder, no eligible target) returns its
        holders unchanged.
        """
        if page_codec(page_id) is not None:
            return tuple(holders)  # EC pages spread load by construction
        current = list(dict.fromkeys(
            list(self._relocations.get(page_id, ())) or list(holders)))
        payload = None
        for hid in current:
            with self._lock:
                prov = self._providers.get(hid)
            if prov is None or self.wire.is_down(hid):
                continue
            try:
                payload = prov.get_page(page_id, peer=peer)
                break
            except (EndpointDown, KeyError, PageIntegrityError):
                continue
        if payload is None:
            return tuple(current)
        width = len(current) + extra
        targets = [pid for pid in
                   self.ring_owners(self.place_key(page_id), width)
                   if pid not in current][:extra] if self.ring is not None \
            else [p.pid for p in self.placement_pool()
                  if p.pid not in current][:extra]
        added = []
        for tpid in targets:
            with self._lock:
                tprov = self._providers.get(tpid)
            if tprov is None:
                continue
            try:
                self.wire.transfer(self.PM_ENDPOINT, WIDEN_CMD_BYTES,
                                   inbound=True, peer=peer, async_peer=True)
                tprov.put_pages([(page_id, payload)], peer=peer)
            except EndpointDown:
                continue
            added.append(tpid)
        if not added:
            return tuple(current)
        full = tuple(current + added)
        self.record_relocation(page_id, full)
        with self._lock:
            prev = self._widened.get(page_id, ())
            self._widened[page_id] = tuple(dict.fromkeys(
                list(prev) + added))
        with self._ctr_lock:
            self.widened_pages += len(added)
            self.widened_bytes += len(added) * (len(payload)
                                                + WIDEN_CMD_BYTES)
        # content-hash hygiene: a dedup hit on this page must hand out
        # the widened holder set, never a stale (possibly draining) one
        if self.dedup_index is not None and \
                getattr(self.dedup_index, "ever_registered", False):
            self.dedup_index.refresh_providers([(page_id, full)], peer=peer)
        return full

    def retarget_widened(self, pid: str, replacement: Optional[str]) -> None:
        """Drop (or substitute) a departing member from every widened
        set — drained endpoints must never linger in read candidates."""
        with self._lock:
            for page_id, extras in list(self._widened.items()):
                if pid not in extras:
                    continue
                new = [e for e in extras if e != pid]
                if replacement and replacement not in new:
                    new.append(replacement)
                if new:
                    self._widened[page_id] = tuple(new)
                else:
                    self._widened.pop(page_id)
