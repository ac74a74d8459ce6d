"""Metadata DHT.

Paper §4.1/§5: tree nodes are stored on metadata providers "in a
distributed way, using a simple DHT".  The paper's "simple static
distribution scheme" is replaced by a consistent-hash ring
(:class:`~repro.core.placement.HashRing`): a key's home shards are its
``replication`` distinct ring owners, so placement stays a pure
function of (ring membership, key) while shards can now join and drain
*online*.  Keys are immutable once written (new metadata is always
*created*, never updated — the paper's key design choice), which is
what makes lock-free concurrent access safe.

Reconfiguration follows the Fragmented-ARES playbook (arXiv:2201.13292):
while a join/drain is in flight the ring keeps BOTH configurations and
a per-range configuration pointer — the merged arc set of the old and
new rings.  Writes land on the union of both configurations' owners
(idempotent re-puts are permitted, so a racing writer can never lose a
key to a mid-flight range transfer); reads race the same union.  A
budgeted migration round copies each arc's keys to their new owners and
then flips that arc's pointer; once every arc has flipped, a completion
sweep re-verifies every key against the final ring, deletes the copies
on shards that no longer own them, and (for a drain) deregisters the
now-empty shard — zero failed ops throughout.

Beyond-paper: optional R-way replication of each key across distinct
ring owners (the paper lists volatility/failure support as future
work), plus replica racing on reads for straggler mitigation.
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable, List, Optional, Set, Tuple

from repro_torch.core.placement import HashRing
from repro_torch.core.placement import stable_hash as _ring_hash
from repro_torch.core.transport import (
    DELETE_NODE_KEY_BYTES,
    MIGRATE_META_KEY_BYTES,
    RING_ANNOUNCE_BYTES,
    EndpointDown,
    Wire,
)


class MetadataShard:
    """One metadata provider endpoint."""

    def __init__(self, shard_id: str, wire: Wire) -> None:
        self.shard_id = shard_id
        self.wire = wire
        self._kv: Dict[Hashable, object] = {}
        self._lock = threading.Lock()

    def put(self, key: Hashable, value: object, nbytes: int, peer: Optional[str] = None) -> None:
        self.wire.transfer(self.shard_id, nbytes, inbound=True, peer=peer)
        self.put_local(key, value)

    def put_local(self, key: Hashable, value: object) -> None:
        with self._lock:
            existing = self._kv.get(key)
            # Immutability invariant: a key is written at most once
            # (concurrent writers never produce the same (version, range)).
            # Replica re-sends of an identical node are permitted.
            if existing is not None and existing != value:
                raise ValueError(f"DHT key {key!r} rewritten with different value")
            self._kv[key] = value

    def get(self, key: Hashable, nbytes: int, peer: Optional[str] = None) -> Optional[object]:
        self.wire.transfer(self.shard_id, nbytes, inbound=False, peer=peer)
        return self.get_local(key)

    def get_local(self, key: Hashable) -> Optional[object]:
        with self._lock:
            return self._kv.get(key)

    def delete_local(self, key: Hashable) -> bool:
        """Remove a key (GC sweep). Immutability only ever applies while
        a key exists: retired keys are deleted, never rewritten."""
        with self._lock:
            return self._kv.pop(key, None) is not None

    def keys(self) -> List[Hashable]:
        """Snapshot of the shard's stored keys (migration planning)."""
        with self._lock:
            return list(self._kv)

    def __len__(self) -> int:
        with self._lock:
            return len(self._kv)


class MetadataDHT:
    """Static-distribution DHT over ``n_shards`` metadata providers."""

    def __init__(
        self,
        wire: Wire,
        n_shards: int,
        *,
        replication: int = 1,
        node_nbytes: int = 64,
    ) -> None:
        self.wire = wire
        self.replication = max(1, min(replication, n_shards))
        self.node_nbytes = node_nbytes  # wire-cost estimate per tree node
        self.shards: List[MetadataShard] = [
            MetadataShard(f"meta-{i:04d}", wire) for i in range(n_shards)
        ]
        self._by_id: Dict[str, MetadataShard] = {
            s.shard_id: s for s in self.shards}
        self.ring = HashRing(self._by_id)
        # ARES-style reconfiguration state: while a join/drain is in
        # flight, ``_old_ring`` holds the previous configuration,
        # ``_arcs`` the merged per-range pointer boundaries, and
        # ``_flipped`` the arcs already transferred to the new ring.
        self._old_ring: Optional[HashRing] = None
        self._arcs: List[int] = []
        self._flipped: Set[int] = set()
        self._draining_shard: Optional[str] = None
        self._ctr_lock = threading.Lock()
        self._counters: Dict[str, int] = {
            "get_keys": 0,        # logical keys requested
            "get_keys_cached": 0,  # keys served by client node caches, no RPC
            "get_rounds": 0,      # client-visible batched waves (get/get_many calls loop)
            "get_shard_rpcs": 0,  # per-shard round trips actually issued
            "put_keys": 0,
            "put_shard_rpcs": 0,
            "delete_keys": 0,        # logical keys swept
            "delete_shard_rpcs": 0,  # batched per-shard delete round trips
            "migrate_keys": 0,       # key copies moved by ring rebalance
            "migrate_shard_rpcs": 0,  # batched per-shard migration round trips
            "arcs_flipped": 0,       # per-range configuration-pointer flips
        }

    def _count(self, **deltas: int) -> None:
        with self._ctr_lock:
            for k, d in deltas.items():
                self._counters[k] += d

    def rpc_counters(self) -> Dict[str, int]:
        with self._ctr_lock:
            return dict(self._counters)

    def reset_rpc_counters(self) -> None:
        with self._ctr_lock:
            for k in self._counters:
                self._counters[k] = 0

    def note_cache_hits(self, n: int) -> None:
        """Client node caches report their hits here, so one
        ``rpc_counters()`` read shows cache-hit vs RPC accounting for
        the whole metadata plane (``get_keys`` = keys that DID cross
        the wire path, ``get_keys_cached`` = keys that did not)."""
        self._count(get_keys_cached=n)

    # -- key placement: consistent-hash ring, R distinct owners -----------------
    @staticmethod
    def key_pos(key: Hashable) -> int:
        """Ring position of a metadata key (stable across runs — keys
        are tuples of deterministic components, never raw page ids)."""
        return _ring_hash(repr(key))

    def _home_shards(self, key: Hashable) -> List[MetadataShard]:
        """The shards serving ``key`` right now.

        Steady state: the key's ``replication`` distinct ring owners.
        Mid-reconfiguration, the per-range configuration pointer
        decides: a flipped arc routes to the new ring alone; an
        unflipped arc routes to the UNION of old and new owners — puts
        land on both configurations (idempotent re-puts make that safe)
        and reads race both, so no interleaving of writers with the
        range transfer can lose or miss a key.
        """
        pos = self.key_pos(key)
        if self._old_ring is None:
            ids = self.ring.owners_at(pos, self.replication)
        else:
            new = self.ring.owners_at(pos, self.replication)
            if HashRing.arc_index(self._arcs, pos) in self._flipped:
                ids = new
            else:
                old = self._old_ring.owners_at(pos, self.replication)
                ids = list(dict.fromkeys(old + new))
        return [self._by_id[i] for i in ids]

    # -- elastic membership ------------------------------------------------------
    @property
    def reconfiguring(self) -> bool:
        return self._old_ring is not None

    def _begin_reconfig(self, old_nodes: Set[str]) -> None:
        self.wire.transfer(self.shards[0].shard_id, RING_ANNOUNCE_BYTES,
                           inbound=True, async_peer=True)
        self._old_ring = HashRing(old_nodes)
        self._arcs = HashRing.merged_arcs(self._old_ring, self.ring)
        self._flipped = set()

    def begin_join(self, shard_id: str) -> MetadataShard:
        """A metadata shard joins the ring; its owed key ranges arrive
        via subsequent :meth:`migration_round` calls (ARES: transfer
        the fragment set, then flip each range's pointer)."""
        if self._old_ring is not None:
            raise RuntimeError("a ring reconfiguration is already in flight")
        if shard_id in self._by_id:
            raise ValueError(f"shard {shard_id} already registered")
        old_nodes = self.ring.nodes()
        shard = MetadataShard(shard_id, self.wire)
        self.shards.append(shard)
        self._by_id[shard_id] = shard
        self.ring.add(shard_id)
        self._begin_reconfig(old_nodes)
        return shard

    def begin_drain(self, shard_id: str) -> None:
        """Start draining a shard: it leaves the new configuration at
        once (new writes stop targeting it beyond the transfer window)
        but keeps serving its arcs until they flip; the completion sweep
        deregisters it empty."""
        if self._old_ring is not None:
            raise RuntimeError("a ring reconfiguration is already in flight")
        if shard_id not in self._by_id:
            raise KeyError(f"unknown shard {shard_id}")
        if len(self.shards) - 1 < self.replication:
            raise RuntimeError(
                f"draining {shard_id} would leave fewer shards than "
                f"replication={self.replication}")
        old_nodes = self.ring.nodes()
        self.ring.remove(shard_id)
        self._draining_shard = shard_id
        self._begin_reconfig(old_nodes)

    def migration_round(self, budget_bytes: int) -> Dict[str, int]:
        """One budgeted migration round of the in-flight reconfiguration.

        Scans the old configuration's shards once, buckets keys by
        merged arc, copies each unflipped arc's keys to their new-ring
        owners (one batched round trip per destination shard), and
        flips the arc's configuration pointer.  Arcs are processed in
        ring order and the round stops when the byte budget is spent —
        migration runs *concurrently* with client traffic, never as a
        stop-the-world pass.  When every arc has flipped, a completion
        sweep deletes stale copies from shards that no longer own their
        keys and deregisters a drained shard.  Returns round stats with
        ``done=1`` once the reconfiguration is fully complete.
        """
        stats = {"arcs_flipped": 0, "keys_moved": 0, "bytes_moved": 0,
                 "done": 0}
        if self._old_ring is None:
            stats["done"] = 1
            return stats
        per_key = self.node_nbytes + MIGRATE_META_KEY_BYTES
        # one scan, bucketed by arc (keys seen on any old-config shard)
        by_arc: Dict[int, Dict[Hashable, MetadataShard]] = {}
        for shard in self.shards:
            for key in shard.keys():
                arc = HashRing.arc_index(self._arcs, self.key_pos(key))
                if arc in self._flipped:
                    continue
                by_arc.setdefault(arc, {}).setdefault(key, shard)
        spent = 0
        for arc in range(len(self._arcs)):
            if arc in self._flipped:
                continue
            moves: Dict[MetadataShard, List[Hashable]] = {}
            for key, holder in sorted(
                    by_arc.get(arc, {}).items(),
                    key=lambda kv: (self.key_pos(kv[0]), repr(kv[0]))):
                for dst_id in self.ring.owners_at(
                        self.key_pos(key), self.replication):
                    dst = self._by_id[dst_id]
                    if dst.get_local(key) is None:
                        moves.setdefault(dst, []).append(key)
            cost = per_key * sum(len(ks) for ks in moves.values())
            if moves and spent and spent + cost > budget_bytes:
                break  # budget spent; later arcs wait for the next round
                # (a round always flips at least one non-empty arc, so an
                # arc larger than the budget still makes progress)
            for dst in sorted(moves, key=lambda s: s.shard_id):
                batch = moves[dst]
                self.wire.transfer_batch(
                    dst.shard_id, [per_key] * len(batch), inbound=True,
                    async_peer=True,
                    fire_and_forget=self.wire.clock.is_virtual)
                for key in batch:
                    dst.put_local(key, by_arc[arc][key].get_local(key))
                self._count(migrate_keys=len(batch), migrate_shard_rpcs=1)
            spent += cost
            self._flipped.add(arc)
            self._count(arcs_flipped=1)
            stats["arcs_flipped"] += 1
            stats["keys_moved"] += sum(len(ks) for ks in moves.values())
            stats["bytes_moved"] += cost
        if len(self._flipped) >= len(self._arcs):
            stats["bytes_moved"] += self._complete_reconfig()
            stats["done"] = 1
        return stats

    def _complete_reconfig(self) -> int:
        """Completion sweep: re-verify every key against the final ring
        (catches a writer that raced an arc flip), delete copies from
        shards that no longer own them, deregister a drained shard."""
        moved_bytes = 0
        per_key = self.node_nbytes + MIGRATE_META_KEY_BYTES
        for shard in list(self.shards):
            stale: List[Hashable] = []
            for key in shard.keys():
                owner_ids = self.ring.owners_at(
                    self.key_pos(key), self.replication)
                if shard.shard_id in owner_ids:
                    continue
                # safety net for raced writes: make sure every final
                # owner holds the key before this copy goes away
                for dst_id in owner_ids:
                    dst = self._by_id[dst_id]
                    if dst.get_local(key) is None:
                        self.wire.transfer(
                            dst.shard_id, per_key, inbound=True,
                            async_peer=True,
                            fire_and_forget=self.wire.clock.is_virtual)
                        dst.put_local(key, shard.get_local(key))
                        moved_bytes += per_key
                        self._count(migrate_keys=1, migrate_shard_rpcs=1)
                stale.append(key)
            if stale:
                self.wire.transfer_batch(
                    shard.shard_id, [DELETE_NODE_KEY_BYTES] * len(stale),
                    inbound=True, async_peer=True,
                    fire_and_forget=self.wire.clock.is_virtual)
                for key in stale:
                    shard.delete_local(key)
        if self._draining_shard is not None:
            gone = self._by_id.pop(self._draining_shard)
            self.shards.remove(gone)
            self._draining_shard = None
        self._old_ring = None
        self._arcs = []
        self._flipped = set()
        return moved_bytes

    def put(self, key: Hashable, value: object, peer: Optional[str] = None) -> None:
        errs = []
        ok = 0
        self._count(put_keys=1)
        for shard in self._home_shards(key):
            try:
                shard.put(key, value, self.node_nbytes, peer=peer)
                ok += 1
                self._count(put_shard_rpcs=1)
            except EndpointDown as e:
                errs.append(e)
        if ok == 0:
            raise EndpointDown(f"all metadata replicas down for {key!r}: {errs}")

    def put_many(self, items, peer: Optional[str] = None) -> float:
        """Batched put: one wire round-trip per (shard, batch).

        BUILD_META writes all of an update's tree nodes "in parallel"
        (paper Alg 4 l.34); batching them per home shard collapses the
        per-node latency on the writer's NIC into one per shard — a
        measurable append-bandwidth win at small page sizes (§Perf).
        Under a **virtual clock** the per-shard batches are issued
        fire-and-forget and the call sleeps once to the *latest* batch
        completion, so writes to distinct shards overlap in simulated
        time instead of serializing on the issuing task — the paper's
        "in parallel" made literal.  The blocking contract is
        unchanged: when ``put_many`` returns, every batch's transfer
        has completed.  Returns that completion instant (0.0 on the
        wall backend).  Storage semantics are unchanged (same keys,
        same shards, same immutability check).
        """
        by_shard: Dict[MetadataShard, list] = {}
        n_items = 0
        for key, value in items:
            n_items += 1
            for shard in self._home_shards(key):
                by_shard.setdefault(shard, []).append((key, value))
        self._count(put_keys=n_items)
        virtual = self.wire.clock.is_virtual
        failures = 0
        done_at = 0.0
        for shard, batch in by_shard.items():
            try:
                d = self.wire.transfer_batch(shard.shard_id,
                                             [self.node_nbytes] * len(batch),
                                             inbound=True, peer=peer,
                                             async_peer=True,
                                             fire_and_forget=virtual)
                self._count(put_shard_rpcs=1)
                done_at = max(done_at, d if virtual else 0.0)
                for key, value in batch:
                    shard.put_local(key, value)
            except EndpointDown:
                failures += 1
        if failures == len(by_shard) and by_shard:
            raise EndpointDown("all metadata shards down for batched put")
        if virtual and done_at > self.wire.clock.now():
            # the blocking contract: return only once the last batch
            # has arrived (overlapped, not serialized)
            self.wire.clock.sleep_until(done_at)
        return done_at

    def get(self, key: Hashable, peer: Optional[str] = None) -> Optional[object]:
        homes = self._home_shards(key)
        # replica racing: least-busy replica first (shard-id tie-break
        # keeps replays deterministic when queue depths are equal)
        homes.sort(key=lambda s: (self.wire.stats(s.shard_id).sim_busy_until,
                                  s.shard_id))
        last: Optional[Exception] = None
        reachable = False
        self._count(get_keys=1, get_rounds=1)
        for shard in homes:
            try:
                value = shard.get(key, self.node_nbytes, peer=peer)
                self._count(get_shard_rpcs=1)
                reachable = True
                if value is not None:
                    return value
                # A None miss on one replica may be the hole a partial
                # put left behind; keep trying the remaining replicas
                # before concluding the key is absent.
            except EndpointDown as e:
                last = e
        if reachable:
            return None
        raise EndpointDown(f"all metadata replicas down for {key!r}: {last}")

    def get_many(
        self, keys, peer: Optional[str] = None
    ) -> Dict[Hashable, Optional[object]]:
        """Batched get: group keys per home shard, one round trip per shard.

        The read-side mirror of :meth:`put_many`: READ_META descends a
        whole tree *level* at a time, so the per-node latency collapses
        into one batched round trip per (level, shard).  Per-key replica
        failover matches :meth:`get` exactly — a downed shard or a
        replication hole sends just the affected keys to their next
        replica (another batched wave), and ``EndpointDown`` is raised
        only when every replica of a key is unreachable.
        """
        # key -> ordered replica shards still to try (least busy first)
        pending: Dict[Hashable, List[MetadataShard]] = {}
        for key in dict.fromkeys(keys):
            homes = self._home_shards(key)
            homes.sort(key=lambda s: (self.wire.stats(s.shard_id).sim_busy_until,
                                      s.shard_id))
            pending[key] = homes
        out: Dict[Hashable, Optional[object]] = {}
        reachable_miss = set()  # keys a live shard answered None for
        self._count(get_keys=len(pending))
        while pending:
            self._count(get_rounds=1)
            by_shard: Dict[MetadataShard, List[Hashable]] = {}
            for key, homes in pending.items():
                by_shard.setdefault(homes[0], []).append(key)
            nxt: Dict[Hashable, List[MetadataShard]] = {}
            for shard, batch in by_shard.items():
                try:
                    self.wire.transfer_batch(shard.shard_id,
                                             [self.node_nbytes] * len(batch),
                                             inbound=False, peer=peer,
                                             async_peer=True)
                    self._count(get_shard_rpcs=1)
                except EndpointDown as e:
                    for key in batch:
                        rest = pending[key][1:]
                        if rest:
                            nxt[key] = rest
                        elif key in reachable_miss:
                            out[key] = None
                        else:
                            raise EndpointDown(
                                f"all metadata replicas down for {key!r}: {e}"
                            )
                    continue
                for key in batch:
                    value = shard.get_local(key)
                    if value is not None:
                        out[key] = value
                        continue
                    reachable_miss.add(key)
                    rest = pending[key][1:]
                    if rest:
                        nxt[key] = rest  # hole fallthrough, as in get()
                    else:
                        out[key] = None
            pending = nxt
        return out

    def delete_many(
        self, keys, peer: Optional[str] = None
    ) -> Tuple[int, List[Hashable]]:
        """Batched delete (GC sweep): one round trip per touched shard.

        Every replica of every key is contacted; all commands bound for
        one shard collapse into a single ``transfer_batch`` carrying
        ``DELETE_NODE_KEY_BYTES`` per key (a delete moves identifiers,
        not node payloads).  Returns ``(n_deleted, failed_keys)`` where
        ``failed_keys`` lists keys with at least one unreachable replica
        — the sweep retries those in a later round (deletes are
        idempotent), so a downed shard never silently leaks its keys.
        """
        by_shard: Dict[MetadataShard, List[Hashable]] = {}
        n_keys = 0
        for key in dict.fromkeys(keys):
            n_keys += 1
            for shard in self._home_shards(key):
                by_shard.setdefault(shard, []).append(key)
        self._count(delete_keys=n_keys)
        removed: Dict[Hashable, bool] = {}
        failed_set: Dict[Hashable, bool] = {}
        for shard, batch in by_shard.items():
            try:
                self.wire.transfer_batch(shard.shard_id,
                                         [DELETE_NODE_KEY_BYTES] * len(batch),
                                         inbound=True, peer=peer,
                                         async_peer=True)
                self._count(delete_shard_rpcs=1)
                for key in batch:
                    if shard.delete_local(key):
                        removed[key] = True
            except EndpointDown:
                for key in batch:
                    failed_set[key] = True
        deleted = sum(1 for k in removed if k not in failed_set)
        return deleted, list(failed_set)

    # -- introspection -----------------------------------------------------------
    def total_keys(self) -> int:
        return sum(len(s) for s in self.shards)

    def shard_loads(self) -> List[Tuple[str, int]]:
        return [(s.shard_id, len(s)) for s in self.shards]
