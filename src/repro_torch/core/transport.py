"""Simulated transport + wire-cost accounting.

The paper evaluates BlobSeer on Grid'5000 (1 Gbit/s intra-cluster
Ethernet, measured 117.5 MB/s TCP, 0.1 ms latency).  This container is a
single CPU core, so we cannot measure real network throughput.  Instead,
every remote interaction goes through a :class:`Wire`, which

* optionally injects *real* latency (``sleep_scale > 0``) so that
  concurrency tests exercise true interleavings, and
* always accounts *simulated* wire time per endpoint
  (``latency + bytes / bandwidth``), so benchmarks can report derived
  Grid'5000-equivalent bandwidth figures next to raw wall-clock numbers.

Per-endpoint serialization is modelled with one lock per endpoint: two
clients hitting the same provider serialize there, exactly the conflict
the paper says the provider-manager placement strategy must minimize
(§4.3 "data access serialization is only necessary when the same
provider is contacted at the same time by different clients").

Under a virtual :class:`~repro.core.sim.Simulator` clock the queueing
model is promoted from accounting to *actual scheduling*: the issuing
task sleeps (in virtual time) until its request's completion instant
``max(now, endpoint_busy_until) + cost``, so endpoint contention shapes
the schedule exactly as it shaped the derived makespans before.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

from repro_torch.core.sim import Clock, WallClock


GRID5000_BANDWIDTH = 117.5e6  # bytes/s, measured TCP figure from the paper
GRID5000_LATENCY = 0.1e-3     # seconds

# Wire-cost model of the GC sweep verbs (beyond paper; the paper never
# reclaims space).  A delete carries only an identifier, no payload:
# the per-item cost of a batched `MetadataDHT.delete_many` /
# `DataProvider.delete_pages` is one key/page-id plus framing, and the
# whole batch pays a single latency charge via `transfer_batch`.
DELETE_NODE_KEY_BYTES = 40  # one metadata-node key in a batched delete
DELETE_PAGE_CMD_BYTES = 24  # one page-id in a batched page delete
LIST_PAGE_ENTRY_BYTES = 28  # one (page id, stored-at) entry in an inventory

# Wire-cost model of the version-manager control plane.  Singleton verbs
# (GET_RECENT, SYNC, a lone assign, ...) each pay one latency charge plus
# VM_CTRL_MSG_BYTES.  The batched writer verbs of the scale-out write
# plane — `VersionManager.assign_versions_many` and
# `metadata_complete_many` — pay ONE latency charge for the whole batch
# plus a per-item framing cost below, which is what lets an appender
# swarm amortize version-manager round trips the way `get_many`
# amortized metadata reads.
VM_CTRL_MSG_BYTES = 96      # one singleton control-plane verb
VM_ASSIGN_REQ_BYTES = 128   # one request inside assign_versions_many
VM_COMPLETE_CMD_BYTES = 48  # one command inside metadata_complete_many

# Wire-cost model of the HA control plane (replicated lineage shards).
# Every journal record a shard leader commits is streamed to its F
# followers: all of one verb's records ride ONE fire-and-forget
# `transfer_batch` per follower, per record below.  Publication acks
# barrier on the stream's completion instant (per-endpoint FIFO makes
# that cover every earlier record too), so replication adds bandwidth
# but no blocking round trip to the assign path.  Failover pays one
# blocking promotion handshake to the follower being promoted.
VM_WAL_REC_BYTES = 112     # one replicated journal record in a stream batch
VM_WAL_PROMOTE_BYTES = 64  # the lease-takeover promotion handshake RPC

# Wire-cost model of the subscription plane (watch/notify version
# leases).  Watch registration/renewal/cancel are singleton control
# verbs on the lineage leader.  Notification fan-out is the inverted
# primitive: at publication time the leader coalesces every watcher's
# pending gap into ONE entry and ships all entries bound for the same
# inbox endpoint as ONE fire-and-forget `transfer_batch` — a burst of K
# publications to W watchers costs O(K x endpoints-with-watchers)
# round trips, never O(W).  Push-based page-cache invalidation rides
# the same shape: one batched fire-and-forget send per retire intent.
VM_WATCH_REQ_BYTES = 64      # one watch/unwatch/renew control verb
WATCH_NOTIFY_EVT_BYTES = 32  # one coalesced per-watcher entry in a notify batch
CACHE_INVAL_EVT_BYTES = 24   # one page-id entry in a push-invalidation batch

# Wire-cost model of the dedup index (``core/dedup_index.py``).  The
# lookup is the one blocking control round trip the handshake adds per
# write burst: all of a burst's digests ride ONE `transfer_batch`, per
# item below.  Registrations and plain decrements are fire-and-forget
# (they never gate the writer); GC's release batch is blocking because
# the sweeper needs the refcount verdicts back.
DEDUP_LOOKUP_REQ_BYTES = 24    # one (digest64, length) probe in lookup_and_acquire
DEDUP_REGISTER_REQ_BYTES = 48  # one (digest64, page descriptor) in register
DEDUP_RELEASE_REQ_BYTES = 24   # one reference-drop command in release/unreference
DEDUP_REFRESH_REQ_BYTES = 56   # one (page_id, new provider tuple) in refresh_providers

# Wire-cost model of the durability plane (``core/durability.py``).
# A scrub round asks each provider to re-digest its stored pages in
# place (one batched round trip, one probe entry per page — bytes stay
# on the provider), and consults the provider manager's relocation
# overlay when a descriptor's replica list is exhausted (repair and
# lifecycle demotion move bytes without rewriting published metadata).
SCRUB_PROBE_BYTES = 24     # one per-page verify entry in a scrub batch
PM_LOCATE_REQ_BYTES = 40   # one relocation-overlay lookup at the manager

# Wire-cost model of the elastic-membership plane (hash-ring join/drain,
# ``core/membership.py``).  A migration copy pays the full page payload
# through the ordinary provider put/get path; these constants price only
# the *control* framing around it — the per-page move command, the
# per-key metadata handoff, and the ring-membership announcement a
# join/drain broadcasts — so the rebalance gate (moved bytes vs the
# theoretical minimum) accounts for real protocol overhead instead of
# pretending coordination is free.
MIGRATE_PAGE_CMD_BYTES = 48   # one page/shard move command in a migration batch
MIGRATE_META_KEY_BYTES = 48   # one DHT key handoff command in an arc transfer
RING_ANNOUNCE_BYTES = 96      # one join/drain membership announcement
WIDEN_CMD_BYTES = 48          # one replica-widening command (flash-crowd)


@dataclass
class WireStats:
    """Cumulative per-endpoint wire accounting."""

    bytes_in: int = 0
    bytes_out: int = 0
    requests: int = 0
    sim_busy_until: float = 0.0  # simulated clock: when this endpoint frees up


class EndpointDown(RuntimeError):
    """Raised when a failed endpoint is contacted (failure injection)."""


@dataclass
class Wire:
    """Shared wire model for one deployment.

    ``sleep_scale``  multiply injected real sleeps (0 = don't sleep; tests
                     that need true interleaving set a small value).
    """

    bandwidth: float = GRID5000_BANDWIDTH
    latency: float = GRID5000_LATENCY
    sleep_scale: float = 0.0
    clock: Clock = field(default_factory=WallClock)

    _stats: Dict[str, WireStats] = field(default_factory=dict)
    _locks: Dict[str, threading.Lock] = field(default_factory=dict)
    _down: Dict[str, bool] = field(default_factory=dict)
    _slow: Dict[str, float] = field(default_factory=dict)  # straggler factor
    _global: threading.Lock = field(default_factory=threading.Lock)
    _sim_clock: float = 0.0
    _round_trips: int = 0
    _local_hits: int = 0       # requests served from a local cache, no RPC
    _local_hit_bytes: int = 0  # bytes those hits kept off the wire

    # -- endpoint registry ---------------------------------------------------
    def _ep(self, endpoint: str) -> WireStats:
        with self._global:
            if endpoint not in self._stats:
                self._stats[endpoint] = WireStats()
                self._locks[endpoint] = threading.Lock()
            return self._stats[endpoint]

    def lock(self, endpoint: str) -> threading.Lock:
        self._ep(endpoint)
        return self._locks[endpoint]

    # -- failure / straggler injection ----------------------------------------
    def set_down(self, endpoint: str, down: bool = True) -> None:
        self._ep(endpoint)
        self._down[endpoint] = down

    def is_down(self, endpoint: str) -> bool:
        return self._down.get(endpoint, False)

    def set_straggler(self, endpoint: str, factor: float) -> None:
        """Make an endpoint ``factor`` x slower (simulated + injected)."""
        self._ep(endpoint)
        self._slow[endpoint] = factor

    # -- the actual transfer ---------------------------------------------------
    def transfer(
        self, endpoint: str, nbytes: int, *, inbound: bool,
        peer: Optional[str] = None, async_peer: bool = False,
        fire_and_forget: bool = False,
    ) -> float:
        """Account one request moving ``nbytes`` to/from ``endpoint``.

        ``peer`` is the other side of the connection (usually the
        client); its NIC is charged wire time too, which is what makes a
        single appender's bandwidth top out near the measured per-link
        figure, as in the paper's Fig 2(a).

        ``async_peer`` models the paper's "for all ... in parallel"
        loops: with many RPCs in flight, the peer's NIC is occupied by
        the *bytes* only — per-request latency overlaps across requests
        and is paid by the remote endpoint, not the issuing NIC.

        ``fire_and_forget`` models a request the issuer does not wait
        for (cache prefetch): the endpoint queue, byte counters and
        round-trip count are charged exactly as usual, but the issuing
        task is **never blocked** — not in virtual time, not by
        ``sleep_scale``.  The completion instant is still recorded in
        the endpoint's ``sim_busy_until``, which is how the cache learns
        when the prefetched bytes "arrive".

        Returns the completion instant ``done_at`` (simulated-clock
        coordinates).  Raises :class:`EndpointDown` on failed endpoints.

        Under a virtual clock a non-fire-and-forget issuing task
        *blocks in virtual time* until ``done_at`` — the per-endpoint
        queue stops being mere accounting and becomes the schedule.
        """
        if self._down.get(endpoint, False):
            raise EndpointDown(endpoint)
        st = self._ep(endpoint)
        factor = self._slow.get(endpoint, 1.0)
        cost = (self.latency + nbytes / self.bandwidth) * factor
        virtual = self.clock.is_virtual
        base = self.clock.now() if virtual else self._sim_clock
        with self._locks[endpoint]:
            st.requests += 1
            if inbound:
                st.bytes_in += nbytes
            else:
                st.bytes_out += nbytes
            # Endpoint serialization in simulated time: requests queue.
            with self._global:
                self._round_trips += 1
                start = max(base, st.sim_busy_until)
                st.sim_busy_until = start + cost
        done_at = start + cost
        if peer is not None:
            peer_cost = (nbytes / self.bandwidth) if async_peer else cost
            pst = self._ep(peer)
            with self._locks[peer]:
                pst.requests += 1
                if inbound:
                    pst.bytes_out += nbytes
                else:
                    pst.bytes_in += nbytes
                with self._global:
                    start = max(base, pst.sim_busy_until)
                    pst.sim_busy_until = start + peer_cost
        if not fire_and_forget:
            if virtual:
                self.clock.sleep_until(done_at)
            elif self.sleep_scale > 0.0:
                self.clock.sleep(cost * self.sleep_scale)
        return done_at

    def transfer_batch(
        self, endpoint: str, sizes: Sequence[int], *, inbound: bool,
        peer: Optional[str] = None, async_peer: bool = True,
        fire_and_forget: bool = False,
    ) -> float:
        """Account ONE batched request carrying ``len(sizes)`` items.

        The whole batch pays a single latency charge plus the summed
        bytes — the accounting ``MetadataDHT.put_many`` pioneered, now a
        first-class primitive shared by the batched read plane
        (``get_many``, ``fetch_pages``).  Counts as one round trip.
        Returns the batch's completion instant (see :meth:`transfer`).
        """
        return self.transfer(
            endpoint, sum(sizes), inbound=inbound, peer=peer,
            async_peer=async_peer, fire_and_forget=fire_and_forget,
        )

    # -- simulated clock -------------------------------------------------------
    def advance_clock(self, seconds: float) -> None:
        with self._global:
            self._sim_clock += seconds

    def sim_span(self) -> float:
        """Simulated makespan: latest endpoint-free time."""
        with self._global:
            busy = [s.sim_busy_until for s in self._stats.values()]
            return max(busy) if busy else 0.0

    def stats(self, endpoint: str) -> WireStats:
        return self._ep(endpoint)

    def total_bytes(self) -> int:
        with self._global:
            return sum(s.bytes_in + s.bytes_out for s in self._stats.values())

    def total_round_trips(self) -> int:
        """RPCs issued so far (a batched transfer counts once)."""
        with self._global:
            return self._round_trips

    # -- cache-hit vs RPC accounting -------------------------------------------
    def note_local_hit(self, nbytes: int) -> None:
        """Account a request served from a local cache: zero round trips,
        zero wire time — ``nbytes`` records what an RPC *would* have
        moved, so benchmarks can report bytes kept off the wire next to
        ``total_bytes()``.  Never touches endpoint queues or the clock."""
        with self._global:
            self._local_hits += 1
            self._local_hit_bytes += nbytes

    def total_local_hits(self) -> int:
        with self._global:
            return self._local_hits

    def total_local_hit_bytes(self) -> int:
        """Bytes served from local caches instead of the wire."""
        with self._global:
            return self._local_hit_bytes

    def reset_accounting(self) -> None:
        with self._global:
            for s in self._stats.values():
                s.bytes_in = s.bytes_out = s.requests = 0
                s.sim_busy_until = 0.0
            self._sim_clock = 0.0
            self._round_trips = 0
            self._local_hits = 0
            self._local_hit_bytes = 0
