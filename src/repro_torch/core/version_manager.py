"""The version manager (paper §3.1, §4.2, §4.3) — sharded by lineage.

"The version manager is the key actor of the system.  It registers
update requests (APPEND and WRITE), assigning snapshot version numbers,
and eventually publishes these updates, guaranteeing total ordering and
atomicity."

Responsibilities implemented here, faithfully:

* assign strictly increasing snapshot versions per blob; APPEND offsets
  are the size of the previous snapshot (assigned, possibly unpublished);
* keep the in-flight registry of assigned-but-unpublished updates and
  hand each new writer (a) the ranges of every update between the last
  published snapshot and its own version — the *partial border set*
  information of §4.2 — and (b) a recently published snapshot version to
  resolve the rest of its border nodes;
* publish versions **in order** once their metadata is complete, so a
  reader can never observe snapshot ``v`` without snapshots ``< v``
  being fully resolvable (atomicity in the sense of [9]);
* serve GET_RECENT / GET_SIZE / SYNC.

Scale-out write plane (beyond paper; the paper calls the version
manager the potential bottleneck):

* manager state is **partitioned into per-lineage shards** — one
  :class:`LineageShard` per CREATE-rooted branch family, each with its
  own lock and publication condition.  The ordering guarantee the paper
  needs is *per blob*, so nothing is lost: versions of one blob still
  publish strictly in order, but a slow writer on blob A never holds
  any lock or condition a writer/reader of blob B touches.  Branches
  share their ancestor's shard because every cross-blob rule
  (branch-root pinning, inherited-version ownership, in-flight ``vp``
  anchors) stays inside one lineage by construction;
* **batched writer verbs** — :meth:`VersionManager.assign_versions_many`
  and :meth:`VersionManager.metadata_complete_many` carry many updates
  in ONE control round trip (costed per item in ``transport.py``), the
  write-plane mirror of the read plane's ``get_many``.  Per-verb
  counters are exposed through :meth:`rpc_counters` and show up in
  ``service.rpc_report()`` as ``vm_*``.

Beyond-paper (the paper defers failure handling):

* every version assignment is journaled to a write-ahead log together
  with the update's page descriptors (pages are already durably stored
  at assignment time), so a crashed writer's metadata can be rebuilt
  deterministically by any recovery agent (`find_stalled` +
  ``BlobClient.rebuild_metadata``) instead of stalling the publication
  pipeline forever;
* the version manager itself recovers its full state from the WAL.
  Every WAL record carries its **lineage id**, so a recovered manager
  rebuilds the same shard layout; records of different lineages commute
  (the journal only promises order *within* a lineage, which is exactly
  what each shard's lock serializes).

HA control plane (``replication > 0``; see ARCHITECTURE.md):

* each lineage shard becomes a **replicated state machine**: its journal
  records stream to F follower endpoints over the wire (batched,
  fire-and-forget), a clock-based lease marks the leader, and when the
  leader endpoint dies mid-burst the next verb waits out the lease and
  promotes the most-caught-up follower — replaying its copy of the
  journal with exactly the rules :meth:`VersionManager.recover_from_wal`
  applies to the on-disk WAL.  Publication acks barrier on the stream's
  completion instant, so an acked publication is never lost to failover.

Subscription plane (watch/notify; see docs/watch.md):

* :meth:`VersionManager.watch` leases a push subscription on a blob —
  publications past ``from_version`` are coalesced per watcher and
  shipped as ONE fire-and-forget batch per inbox endpoint at
  publication time, so a K-publication burst to W watchers costs
  O(K x endpoints-with-watchers) notify RPCs, never O(W).  Leases use
  the GC pin-lease clock machinery (absolute expiry, renewal) and
  replicate through the journal, so watches survive leader failover;
  a cold restart drops them (clients re-watch), like pins.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.core.pages import pages_spanned, root_pages_for
from repro_torch.core.sim import Clock, WallClock
from repro_torch.core.transport import (
    VM_ASSIGN_REQ_BYTES,
    VM_COMPLETE_CMD_BYTES,
    VM_CTRL_MSG_BYTES,
    VM_WAL_PROMOTE_BYTES,
    VM_WAL_REC_BYTES,
    VM_WATCH_REQ_BYTES,
    WATCH_NOTIFY_EVT_BYTES,
    EndpointDown,
    Wire,
)

VMGR_ENDPOINT = "vmgr"
_CTRL_MSG_BYTES = VM_CTRL_MSG_BYTES  # wire-cost estimate of one control RPC


def owner_fn_for_lineage(chain: Sequence[Tuple[str, int]]):
    """Version -> owning blob id, from a :meth:`VersionManager.lineage`
    chain (youngest first).  The single home of the ownership rule —
    version ``v`` belongs to the first entry with ``v > base`` — shared
    by the client (cached chains), the GC mark walk and the manager."""

    def owner(version: int) -> str:
        for bid, base in chain:
            if version > base:
                return bid
        return chain[-1][0]

    return owner


class BlobUnknown(KeyError):
    """No blob with that id exists at this version manager."""


class VersionUnpublished(RuntimeError):
    """The snapshot version is not published (or not even assigned):
    reads, GET_SIZE and pins of it are rejected — the paper's READ
    'fails if the version is not published yet'."""


class WriteBeyondEnd(ValueError):
    """WRITE offset larger than the size of the previous snapshot."""


class RetiredVersion(RuntimeError):
    """The snapshot was retired by GC: its space has been (or is being)
    reclaimed.  Raised for reads, pins and branches of retired versions
    — a typed, deliberate answer, never a stray ``KeyError`` from a
    swept page or tree node."""


@dataclass
class UpdateRecord:
    """One assigned update (WRITE/APPEND) in a blob's history: the
    version manager's journaled source of truth for the update's range,
    page descriptors (``pd``), completion state and the published
    anchor ``vp`` its writer resolves border nodes against.  GC derives
    a retired version's sweep candidates from this record alone."""

    version: int
    offset: int            # bytes
    size: int              # bytes written
    new_blob_size: int     # bytes: size of this snapshot
    root_pages: int
    p0: int                # page extent of the update
    p1: int
    is_append: bool
    client: str
    pd: Tuple = ()         # ((pid, rel_page_index, providers, length), ...)
    complete: bool = False
    assigned_at: float = field(default_factory=time.monotonic)
    vp: Optional[int] = None  # published anchor handed to the writer (GC keeps it)


@dataclass
class PinLease:
    """One client's pin on ``(blob, version)``: GC keeps the snapshot
    until the lease is released or its clock-based expiry passes."""

    lease_id: str
    blob_id: str
    version: int
    client: Optional[str]
    expires_at: Optional[float]  # None = until released


@dataclass
class WatchLease:
    """One client's watch on a blob: every publication past
    ``from_version`` is pushed (coalesced) to the lease's inbox
    endpoint until :meth:`VersionManager.unwatch` or the clock-based
    expiry passes — the same absolute-expiry/renewal machinery as
    :class:`PinLease`.  ``delivered_up_to`` is the per-watcher
    coalescing watermark: a flush sends one entry covering
    ``(delivered_up_to, published]`` and advances it, so deliveries
    are monotone and never skip a version past ``from_version``."""

    watch_id: str
    blob_id: str
    client: Optional[str]
    endpoint: str                # inbox endpoint notifies are shipped to
    from_version: int
    delivered_up_to: int
    expires_at: Optional[float]  # None = until unwatched


@dataclass
class BlobRecord:
    """Per-blob manager state: page size, branch parentage, the update
    log, publication watermark, and the GC bookkeeping (retention
    policy, retired/swept sets, ``gc_epoch``)."""

    blob_id: str
    psize: int
    parent: Optional[Tuple[str, int]] = None  # (parent blob id, branch version)
    base_version: int = 0                     # versions <= base live in the parent
    updates: Dict[int, UpdateRecord] = field(default_factory=dict)
    last_assigned: int = 0
    published: int = 0
    keep_last: int = 0                        # retention policy; 0 = keep all
    retired: Set[int] = field(default_factory=set)  # retire-intent: reads rejected
    swept: Set[int] = field(default_factory=set)    # sweep finalized
    gc_epoch: int = 0                         # bumped at every retire-intent
    lineage_id: str = ""                      # shard key (root blob of the family)


class _FollowerReplica:
    """One follower's copy of a lineage's replicated journal.

    ``records`` is exactly the prefix of the leader's journal that was
    successfully streamed to this endpoint.  A single failed stream
    marks the follower ``lost`` forever: its journal now has a gap, so
    it can never be promoted (a promoted gap would silently unassign
    versions the leader already acked)."""

    __slots__ = ("endpoint", "records", "lost")

    def __init__(self, endpoint: str) -> None:
        self.endpoint = endpoint
        self.records: List[dict] = []
        self.lost = False


class _ShardReplication:
    """Replication state of one lineage shard (the HA control plane).

    The leader is an endpoint name, not a process: every verb on the
    lineage charges the leader endpoint, which both accounts the RPC
    and *detects death* (``EndpointDown``).  ``lease_expires_at`` is
    renewed on every successfully charged verb; failover must wait it
    out before promoting, because the old leader may still be acking
    verbs issued before the fault was observed (the same clock-based
    expiry rule as GC pin leases).  Mutated only under the shard lock,
    except the benign lease-renewal stamp."""

    __slots__ = ("leader_ep", "followers", "lease_ttl", "lease_expires_at",
                 "epoch", "pending", "failing_over", "barrier_at",
                 "assigned_keys")

    def __init__(self, lineage_id: str, n_followers: int, lease_ttl: float,
                 now: float) -> None:
        self.leader_ep = f"vm-{lineage_id}"
        self.followers: Tuple[_FollowerReplica, ...] = tuple(
            _FollowerReplica(f"vm-{lineage_id}-f{k}")
            for k in range(1, n_followers + 1)
        )
        self.lease_ttl = lease_ttl
        self.lease_expires_at = now + lease_ttl
        self.epoch = 1                    # bumped at every failover
        self.pending: List[dict] = []     # records journaled by the verb in flight
        self.failing_over = False         # guards concurrent failover attempts
        self.barrier_at = 0.0             # completion instant of the newest stream
        # idempotency: journaled assign key -> (blob, version); a re-driven
        # assign with a known key returns the already-assigned version
        self.assigned_keys: Dict[str, Tuple[str, int]] = {}


class LineageShard:
    """One partition of the version manager's state: a CREATE-rooted
    blob plus every branch forked (transitively) from it.

    Each shard owns its blobs' records, read-lease counts, an RLock and
    a clock-bound condition for SYNC / publication / drain waits.  Every
    per-blob verb takes exactly this one lock, so the only writers that
    ever contend on a version-manager critical section are writers of
    the *same lineage* — publication on blob B proceeds even while a
    task holds blob A's shard lock (see ``tests/test_write_plane.py``).

    Branches join their ancestor's shard: inherited-version ownership,
    branch-root retention and in-flight ``vp`` anchors are then all
    intra-shard facts, which is what lets :meth:`VersionManager.\
plan_retirement` run under a single shard lock.
    """

    __slots__ = ("lineage_id", "lock", "cond", "blobs", "active_reads",
                 "repl", "watches")

    def __init__(self, lineage_id: str, clock: Clock) -> None:
        self.lineage_id = lineage_id
        self.lock = threading.RLock()
        # SYNC / publication / drain waits block through the clock:
        # real threading.Condition on the wall backend, virtual-time
        # waits under a Simulator.
        self.cond = clock.condition(self.lock)
        self.blobs: Dict[str, BlobRecord] = {}
        # in-flight read counts per (owner blob, version), for the GC
        # sweep's drain barrier
        self.active_reads: Dict[Tuple[str, int], int] = {}
        # HA replication group (None with replication off: every verb
        # then charges the shared VMGR_ENDPOINT exactly as before)
        self.repl: Optional[_ShardReplication] = None
        # subscription plane: blob id -> {watch id -> WatchLease},
        # mutated under the shard lock, rebuilt on failover from the
        # replicated journal's watch/unwatch/renew/notify records
        self.watches: Dict[str, Dict[str, WatchLease]] = {}


class VersionManager:
    """The system's serialization point (paper §3.1), sharded by
    lineage: it assigns strictly increasing snapshot versions per blob,
    keeps the in-flight registry concurrent writers resolve their
    border sets from, and publishes each blob's versions **in order**
    once their metadata completes.  The critical section is per
    lineage (:class:`LineageShard`), so unrelated blobs never contend.

    Beyond the paper it also owns the durability and GC control planes:
    every assignment is journaled to a WAL (crashed writers are
    rebuilt deterministically, the manager itself recovers via
    :meth:`recover_from_wal`), and retirement state — retention
    policies, pin leases, read leases/drain barrier, retire-intent and
    sweep finalization — lives here so that a single critical section
    per lineage decides what GC may reclaim (see ``core/gc.py``)."""

    #: batch fsync policy: coalesce at most this many journal records
    #: between fsyncs (publication acks always sync, see _repl_barrier)
    FSYNC_COALESCE = 256

    def __init__(self, wire: Optional[Wire] = None, wal_path: Optional[str] = None,
                 clock: Optional[Clock] = None, *, replication: int = 0,
                 lease_ttl: float = 0.25,
                 fsync_policy: str = "batch") -> None:
        if fsync_policy not in ("never", "batch", "always"):
            raise ValueError(f"fsync_policy must be never/batch/always, "
                             f"got {fsync_policy!r}")
        if replication < 0:
            raise ValueError("replication must be >= 0")
        self.wire = wire
        if clock is None:
            clock = wire.clock if wire is not None else WallClock()
        self._clock = clock
        # HA config: replication = follower count per lineage shard
        # (0 = single shared endpoint, the pre-HA behavior).
        self._replication = replication
        self._lease_ttl = lease_ttl
        self._fsync_policy = fsync_policy
        self._wal_dirty = 0   # records written since the last fsync
        # Lineage registry: blob id -> lineage id -> shard.  The
        # registry lock guards only these maps and the id counter; it
        # is never held across a shard operation (lock order:
        # shard lock > registry/pins/WAL/counter locks, one shard lock
        # at a time — cross-lineage iteration visits shards serially).
        self._registry_lock = threading.Lock()
        self._shards: Dict[str, LineageShard] = {}
        self._lineage_of: Dict[str, str] = {}
        self._blob_order: List[str] = []   # global creation order
        self._ids = itertools.count(1)
        self._wal_lock = threading.Lock()
        self._wal: List[dict] = []
        self._wal_path = wal_path
        self._wal_file = open(wal_path, "a") if wal_path else None
        # GC state: pin leases (volatile — leases die with the manager,
        # recovery falls back to retention).
        self._pins_lock = threading.Lock()
        self._pins: Dict[str, PinLease] = {}
        self._pin_ids = itertools.count(1)
        # Subscription plane: watch leases live on their lineage shard
        # (sh.watches, under the shard lock, replicated via the
        # journal).  The facade keeps only the routing map (watch id ->
        # blob id), the id counter, and the registered delivery inboxes.
        # Inboxes are process memory: they survive leader failover (the
        # promoted leader keeps pushing to the same endpoints) but die
        # with the manager process — after a cold restart clients
        # re-watch, exactly like pin leases.
        self._watches_lock = threading.Lock()
        self._watch_of: Dict[str, str] = {}
        self._watch_ids = itertools.count(1)
        self._inboxes: Dict[str, object] = {}
        # Retire-intent listeners (gc_epoch notifications): fired after
        # every plan_retirement that retires something, OUTSIDE the
        # shard lock, with (blob_id, versions, epoch, page_ids).  The
        # deployment's page cache subscribes so a retired version's
        # pages are evicted the instant the epoch bumps.
        self._gc_listeners: List = []
        # Control-plane accounting (see rpc_counters / rpc_report):
        # ops = logical verbs, round_trips = RPCs actually paid,
        # batched_ops = verbs that rode a batched RPC.
        self._ctr_lock = threading.Lock()
        self._counters: Dict[str, int] = {
            "ops": 0,
            "round_trips": 0,
            "batched_ops": 0,
            "assign_batches": 0,
            "complete_batches": 0,
            "wal_records": 0,        # journal records streamed to followers
            "wal_stream_batches": 0,  # fire-and-forget stream batches sent
            "wal_fsyncs": 0,
            "failovers": 0,
        }
        # watch_* counter family (service.rpc_report): registration
        # traffic plus notify fan-out accounting — notify_rpcs is the
        # number the bench gate compares against the poll twin.
        self._watch_ctr: Dict[str, int] = {
            "registered": 0,
            "renewed": 0,
            "unwatched": 0,
            "expired": 0,
            "notify_rpcs": 0,      # fire-and-forget batches shipped
            "notify_entries": 0,   # coalesced per-watcher entries in them
            "notify_versions": 0,  # versions those entries covered
            "dropped_sends": 0,    # batches lost to a down inbox endpoint
        }

    # ------------------------------------------------------------------ utils
    def _charge(self, client: Optional[str], sh: Optional[LineageShard] = None,
                nbytes: int = _CTRL_MSG_BYTES) -> None:
        """Account one singleton control-plane verb (routed to the
        lineage's leader endpoint when the shard is replicated)."""
        with self._ctr_lock:
            self._counters["ops"] += 1
            self._counters["round_trips"] += 1
        self._charge_wire(sh, lambda ep: self.wire.transfer(
            ep, nbytes, inbound=True, peer=client))

    def _charge_batch(self, n_items: int, item_bytes: int, kind: str,
                      client: Optional[str],
                      shards: Optional[Sequence[LineageShard]] = None) -> None:
        """Account one batched control RPC carrying ``n_items`` verbs.

        With replication on, ``shards`` (aligned with the items) routes
        each item to its lineage's leader: the batch becomes one RPC
        *per touched leader* — cross-lineage batches split, same-lineage
        bursts still amortize exactly as before."""
        repl_groups: Optional[Dict[str, Tuple[LineageShard, int]]] = None
        if shards is not None and any(s.repl is not None for s in shards):
            repl_groups = {}
            for s in shards:
                lid = s.lineage_id
                repl_groups[lid] = (s, repl_groups.get(lid, (s, 0))[1] + 1)
        n_rpcs = 1 if repl_groups is None else len(repl_groups)
        with self._ctr_lock:
            self._counters["ops"] += n_items
            self._counters["batched_ops"] += n_items
            self._counters["round_trips"] += n_rpcs
            self._counters[f"{kind}_batches"] += n_rpcs
        if repl_groups is None:
            if self.wire is not None:
                self.wire.transfer_batch(VMGR_ENDPOINT, [item_bytes] * n_items,
                                         inbound=True, peer=client)
            return
        for lid in sorted(repl_groups):
            s, cnt = repl_groups[lid]
            self._charge_wire(s, lambda ep, cnt=cnt: self.wire.transfer_batch(
                ep, [item_bytes] * cnt, inbound=True, peer=client))

    def _charge_wire(self, sh: Optional[LineageShard],
                     send: Callable[[str], float]) -> None:
        """Issue one control RPC, retrying through failover: a dead
        leader endpoint triggers promotion of a follower, after which
        the verb is re-charged against the new leader.  Must be called
        with NO shard lock held (failover sleeps out the old lease)."""
        if self.wire is None:
            return
        repl = sh.repl if sh is not None else None
        if repl is None:
            send(VMGR_ENDPOINT)
            return
        while True:
            try:
                send(repl.leader_ep)
            except EndpointDown:
                self._failover(sh)
                continue
            # the leader answered: it provably held the lease just now
            repl.lease_expires_at = self._clock.now() + repl.lease_ttl
            return

    def rpc_counters(self) -> Dict[str, int]:
        """Control-plane accounting: ``ops`` (logical verbs),
        ``round_trips`` (control RPCs actually paid — a batched verb
        counts once), ``batched_ops`` (verbs that rode a batch), and
        per-verb batch counts.  ``ops / round_trips`` is the write
        plane's amortization factor; ``service.rpc_report()`` surfaces
        these as ``vm_*``."""
        with self._ctr_lock:
            return dict(self._counters)

    def reset_rpc_counters(self) -> None:
        with self._ctr_lock:
            for k in self._counters:
                self._counters[k] = 0

    def watch_counters(self) -> Dict[str, int]:
        """Subscription-plane accounting (``watch_*`` in
        ``service.rpc_report()``): lease traffic plus notify fan-out —
        ``notify_rpcs`` counts fire-and-forget batches (one per inbox
        endpoint per flush), ``notify_entries`` the coalesced
        per-watcher entries they carried, ``notify_versions`` the
        versions those entries covered."""
        with self._ctr_lock:
            return dict(self._watch_ctr)

    def reset_watch_counters(self) -> None:
        with self._ctr_lock:
            for k in self._watch_ctr:
                self._watch_ctr[k] = 0

    def _journal(self, sh: LineageShard, rec: dict) -> None:
        """Append one WAL record (stamped with its lineage id).

        Called while holding the lineage's shard lock, so the journal
        order of any single lineage matches its state-mutation order;
        records of different lineages may interleave freely — they
        reference disjoint state, so replay commutes across lineages.

        With replication on the record is also buffered on the shard;
        the verb streams its whole buffer to the followers in one batch
        per follower via :meth:`_repl_flush` before releasing the lock.
        """
        rec = dict(rec)
        rec["lineage"] = sh.lineage_id
        with self._wal_lock:
            self._wal.append(rec)
            if self._wal_file is not None:
                self._wal_file.write(json.dumps(rec) + "\n")
                self._wal_file.flush()
                if self._fsync_policy == "always":
                    os.fsync(self._wal_file.fileno())
                    with self._ctr_lock:
                        self._counters["wal_fsyncs"] += 1
                elif self._fsync_policy == "batch":
                    self._wal_dirty += 1
        if sh.repl is not None:
            sh.repl.pending.append(rec)
        if self._fsync_policy == "batch" and self._wal_dirty >= self.FSYNC_COALESCE:
            self._wal_sync()

    def _wal_sync(self) -> None:
        """Force journaled records to stable storage (fsync).  Called at
        publication-ack points and when the batch-coalescing threshold
        fills; a no-op with ``fsync_policy='never'`` or a clean file."""
        if self._fsync_policy == "never":
            return
        with self._wal_lock:
            if self._wal_file is None or self._wal_dirty == 0:
                return
            self._wal_file.flush()
            os.fsync(self._wal_file.fileno())
            self._wal_dirty = 0
        with self._ctr_lock:
            self._counters["wal_fsyncs"] += 1

    # ------------------------------------------------------- HA replication
    def _repl_flush(self, sh: LineageShard) -> None:
        """Stream the records the current verb journaled to every live
        follower: ONE fire-and-forget batch per follower (latency paid
        once, ``VM_WAL_REC_BYTES`` per record).  Caller holds the shard
        lock, so follower journals extend in exactly leader-journal
        order.  A follower whose endpoint is down misses the batch and
        is dropped from the group for good (its journal has a gap)."""
        repl = sh.repl
        if repl is None or not repl.pending:
            return
        recs, repl.pending = repl.pending, []
        live = 0
        for f in repl.followers:
            if f.lost:
                continue
            if self.wire is not None:
                try:
                    done = self.wire.transfer_batch(
                        f.endpoint, [VM_WAL_REC_BYTES] * len(recs),
                        inbound=True, peer=repl.leader_ep,
                        fire_and_forget=True)
                except EndpointDown:
                    f.lost = True
                    continue
                if done > repl.barrier_at:
                    repl.barrier_at = done
            f.records.extend(recs)
            live += 1
        if live:
            with self._ctr_lock:
                self._counters["wal_records"] += len(recs) * live
                self._counters["wal_stream_batches"] += live

    def _repl_barrier(self, sh: LineageShard) -> None:
        """Durability barrier before a publication-affecting ack: fsync
        the local WAL and (under a virtual clock) wait until the newest
        follower stream has arrived.  Endpoint FIFO makes the newest
        stream's completion instant cover every earlier record too, so
        one wait suffices.  Must be called with NO shard lock held —
        under the simulator this sleeps in virtual time."""
        self._wal_sync()
        repl = sh.repl
        if repl is None or self.wire is None:
            return
        t = repl.barrier_at
        if self._clock.is_virtual and t > self._clock.now():
            self._clock.sleep_until(t)

    def _failover(self, sh: LineageShard) -> None:
        """Promote the most-caught-up live follower of a dead leader.

        Called from :meth:`_charge_wire` (no shard lock held) when the
        leader endpoint answered :class:`EndpointDown`.  Exactly one
        task runs the promotion; concurrent verbs wait on the shard
        condition and retry against the new leader.  The promotion:

        1. waits out the dead leader's lease (it may still be acking
           verbs issued before the fault was observed);
        2. picks the live follower with the longest journal (ties break
           by endpoint name — deterministic under the simulator);
        3. pays one blocking promotion handshake RPC;
        4. replays the follower's journal with the same rules as
           :meth:`recover_from_wal` — plus the soft state a same-epoch
           failover can keep that a cold restart drops: pin leases and
           assign idempotency keys are rebuilt from their records, and
           read leases carry over (re-registration with the new leader);
        5. swaps the shard's blob records, bumps the epoch, renews the
           lease and journals a ``failover`` audit record (ignored by
           WAL replay).

        Raises :class:`EndpointDown` when no live follower remains.
        """
        repl = sh.repl
        with sh.cond:
            if repl.failing_over:
                epoch0 = repl.epoch
                while repl.failing_over and repl.epoch == epoch0:
                    sh.cond.wait(repl.lease_ttl)
                return
            if not self.wire.is_down(repl.leader_ep):
                return   # a concurrent failover already installed a new leader
            repl.failing_over = True
            lease_until = repl.lease_expires_at
            candidates = [f for f in repl.followers
                          if not f.lost and not self.wire.is_down(f.endpoint)]
        try:
            if lease_until > self._clock.now():
                self._clock.sleep_until(lease_until)
            if not candidates:
                raise EndpointDown(
                    f"{repl.leader_ep}: no live follower to promote")
            promoted = max(candidates,
                           key=lambda f: (len(f.records), f.endpoint))
            self.wire.transfer(promoted.endpoint, VM_WAL_PROMOTE_BYTES,
                               inbound=True)
            blobs, pins, keys, watches = self.replay_lineage(promoted.records)
            with sh.cond:
                old_blobs = set(sh.blobs)
                old_watch_ids = [wid for table in sh.watches.values()
                                 for wid in table]
                sh.blobs = blobs
                sh.watches = watches
                repl.followers = tuple(f for f in repl.followers
                                       if f is not promoted)
                repl.leader_ep = promoted.endpoint
                repl.epoch += 1
                repl.assigned_keys = keys
                repl.lease_expires_at = self._clock.now() + repl.lease_ttl
                with self._pins_lock:
                    for lid in [lid for lid, p in self._pins.items()
                                if p.blob_id in old_blobs]:
                        del self._pins[lid]
                    self._pins.update(pins)
                with self._watches_lock:
                    for wid in old_watch_ids:
                        self._watch_of.pop(wid, None)
                    for bid, table in watches.items():
                        for wid in table:
                            self._watch_of[wid] = bid
                self._journal(sh, {"op": "failover", "epoch": repl.epoch,
                                   "leader": promoted.endpoint})
                # resume deliveries: any publication the old leader
                # acked but whose notify record never reached this
                # follower re-flushes now — the inbox watermark drops
                # what was already delivered (no gap, no duplicate)
                for bid in sorted(sh.watches):
                    self._flush_watch_locked(sh, bid)
                self._repl_flush(sh)
                sh.cond.notify_all()
            with self._ctr_lock:
                self._counters["failovers"] += 1
        finally:
            with sh.cond:
                repl.failing_over = False
                sh.cond.notify_all()

    def _shard_of(self, blob_id: str) -> LineageShard:
        with self._registry_lock:
            lid = self._lineage_of.get(blob_id)
            if lid is None:
                raise BlobUnknown(blob_id)
            return self._shards[lid]

    def _all_shards(self) -> List[LineageShard]:
        """Every shard, in lineage-creation order (deterministic)."""
        with self._registry_lock:
            return [self._shards[lid] for lid in sorted(self._shards)]

    def lineage_id(self, blob_id: str) -> str:
        """The shard key of ``blob_id``'s lineage: the root blob the
        family was CREATEd as.  Blobs with different lineage ids share
        no version-manager lock — publication on one can never wait on
        the other (the write plane's independence contract)."""
        with self._registry_lock:
            lid = self._lineage_of.get(blob_id)
            if lid is None:
                raise BlobUnknown(blob_id)
            return lid

    @staticmethod
    def _blob_in(sh: LineageShard, blob_id: str) -> BlobRecord:
        try:
            return sh.blobs[blob_id]
        except KeyError:
            raise BlobUnknown(blob_id)

    def _owner_record(self, sh: LineageShard, blob_id: str, version: int) -> BlobRecord:
        """BlobRecord owning ``version`` (walks branch lineage).
        Caller holds the shard lock; the whole walk stays in-shard."""
        b = self._blob_in(sh, blob_id)
        while version <= b.base_version and b.parent is not None:
            b = self._blob_in(sh, b.parent[0])
        return b

    def _record(self, sh: LineageShard, blob_id: str, version: int) -> Optional[UpdateRecord]:
        """Update record for ``version``, walking branch lineage."""
        return self._owner_record(sh, blob_id, version).updates.get(version)

    def _check_not_retired(self, sh: LineageShard, blob_id: str, version: int) -> None:
        # caller holds the shard lock; retirement is recorded on the owner
        # blob, so a branch reading an inherited snapshot sees it too
        if version in self._owner_record(sh, blob_id, version).retired:
            raise RetiredVersion(f"{blob_id} v{version} retired by GC")

    def _latest_live_published(self, sh: LineageShard, b: BlobRecord) -> int:
        """Newest published, non-retired version — what GET_RECENT hands
        out and what new updates anchor their border descents on (a
        retired anchor would race the sweep)."""
        v = b.published
        while v > 0 and v in self._owner_record(sh, b.blob_id, v).retired:
            v -= 1
        return v

    def owner_of(self, blob_id: str, version: int) -> str:
        """Blob id owning the tree nodes of ``version`` (branch lineage)."""
        sh = self._shard_of(blob_id)
        with sh.lock:
            return self._owner_record(sh, blob_id, version).blob_id

    def lineage(self, blob_id: str) -> Tuple[Tuple[str, int], ...]:
        """Branch chain as ((blob_id, base_version), ...) youngest first.

        Version ``v`` is owned by the first entry with ``v > base``.
        Clients cache this; it only ever grows by BRANCH.
        """
        sh = self._shard_of(blob_id)
        with sh.lock:
            chain: List[Tuple[str, int]] = []
            b = self._blob_in(sh, blob_id)
            while True:
                chain.append((b.blob_id, b.base_version))
                if b.parent is None:
                    break
                b = self._blob_in(sh, b.parent[0])
            return tuple(chain)

    def _size_of(self, sh: LineageShard, blob_id: str, version: int) -> int:
        if version == 0:
            return 0
        rec = self._record(sh, blob_id, version)
        if rec is None:
            raise VersionUnpublished(f"{blob_id} v{version} not assigned")
        return rec.new_blob_size

    def _root_pages_of(self, sh: LineageShard, blob_id: str, version: int) -> int:
        if version == 0:
            return 0
        rec = self._record(sh, blob_id, version)
        if rec is None:
            raise VersionUnpublished(f"{blob_id} v{version} not assigned")
        return rec.root_pages

    # ------------------------------------------------------------- public API
    def create(self, psize: int, client: Optional[str] = None) -> str:
        """CREATE: new empty blob, snapshot 0 (size 0).  Roots a fresh
        lineage shard — updates to it will never contend with any
        existing blob's version-manager critical section."""
        self._charge(client)   # CREATE is a registry verb: always "vmgr"
        with self._registry_lock:
            blob_id = f"blob-{next(self._ids):08d}"
            sh = LineageShard(blob_id, self._clock)
            sh.blobs[blob_id] = BlobRecord(blob_id=blob_id, psize=psize,
                                           lineage_id=blob_id)
            if self._replication > 0:
                sh.repl = _ShardReplication(blob_id, self._replication,
                                            self._lease_ttl, self._clock.now())
            self._shards[blob_id] = sh
            self._lineage_of[blob_id] = blob_id
            self._blob_order.append(blob_id)
            # journal BEFORE the registry lock drops: the instant the
            # blob is visible, another thread may journal an op on it,
            # and recovery requires the 'create' record to come first
            self._journal(sh, {"op": "create", "blob": blob_id,
                               "psize": psize})
        with sh.lock:
            # the create record opens the lineage's replicated journal,
            # so each follower's copy is self-contained from record one
            self._repl_flush(sh)
        return blob_id

    def branch(self, blob_id: str, version: int, client: Optional[str] = None) -> str:
        """BRANCH: fork ``blob_id`` at published snapshot ``version``.
        The fork joins its ancestor's lineage shard (inherited versions,
        branch-root retention and border anchors stay intra-shard)."""
        sh = self._shard_of(blob_id)
        self._charge(client, sh)
        with sh.lock:
            src = self._blob_in(sh, blob_id)
            if version > src.published:
                raise VersionUnpublished(f"{blob_id} v{version} not published")
            if version > 0:
                self._check_not_retired(sh, blob_id, version)
            with self._registry_lock:
                bid = f"blob-{next(self._ids):08d}"
                self._lineage_of[bid] = sh.lineage_id
                self._blob_order.append(bid)
            sh.blobs[bid] = BlobRecord(
                blob_id=bid,
                psize=src.psize,
                parent=(blob_id, version),
                base_version=version,
                last_assigned=version,
                published=version,
                lineage_id=sh.lineage_id,
            )
            self._journal(sh, {"op": "branch", "blob": bid, "src": blob_id,
                               "at": version})
            self._repl_flush(sh)
            return bid

    def get_recent(self, blob_id: str, client: Optional[str] = None) -> int:
        """GET_RECENT: a recently published, still-live version.

        Retired snapshots are never handed out — after a GC round the
        recency pointer skips them (the retention policy always keeps
        the newest published version, so this only walks under an
        explicit-keep GC).
        """
        sh = self._shard_of(blob_id)
        self._charge(client, sh)
        with sh.lock:
            return self._latest_live_published(sh, self._blob_in(sh, blob_id))

    def get_size(self, blob_id: str, version: int, client: Optional[str] = None) -> int:
        """GET_SIZE of a *published* snapshot (paper: fails otherwise)."""
        sh = self._shard_of(blob_id)
        self._charge(client, sh)
        with sh.lock:
            if version > self._blob_in(sh, blob_id).published:
                raise VersionUnpublished(f"{blob_id} v{version} not published")
            if version > 0:
                self._check_not_retired(sh, blob_id, version)
            return self._size_of(sh, blob_id, version)

    def psize_of(self, blob_id: str) -> int:
        """The blob's immutable page size (fixed at CREATE)."""
        sh = self._shard_of(blob_id)
        with sh.lock:
            return self._blob_in(sh, blob_id).psize

    def sync(self, blob_id: str, version: int, timeout: Optional[float] = None,
             client: Optional[str] = None) -> None:
        """SYNC: block until ``version`` is published (waits on the
        blob's lineage shard — publication on other lineages neither
        wakes nor delays this)."""
        sh = self._shard_of(blob_id)
        self._charge(client, sh)
        deadline = None if timeout is None else self._clock.now() + timeout
        with sh.cond:
            while self._blob_in(sh, blob_id).published < version:
                remaining = None if deadline is None else deadline - self._clock.now()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"SYNC {blob_id} v{version}")
                sh.cond.wait(remaining)

    def is_published(self, blob_id: str, version: int) -> bool:
        """Has ``version`` been published (atomically visible)?  True
        for retired versions too — reads of those get the typed
        :class:`RetiredVersion` from :meth:`enter_read`, not a
        'not published' answer."""
        sh = self._shard_of(blob_id)
        with sh.lock:
            return version <= self._blob_in(sh, blob_id).published

    # ----------------------------------------------------- update registration
    def _reassign_info_locked(self, sh: LineageShard, blob_id: str,
                              version: int) -> "AssignInfo":
        """Reconstruct the AssignInfo of an already-assigned version for
        an idempotent re-drive (same journaled key seen again, e.g. a
        batch retried across a failover).  Caller holds the shard lock."""
        b = self._blob_in(sh, blob_id)
        rec = b.updates[version]
        vp = rec.vp if rec.vp is not None else 0
        recent: List[Tuple[int, int, int]] = []
        for u in range(vp + 1, version):
            r = b.updates.get(u)
            if r is not None and u not in b.retired:
                recent.append((r.version, r.p0, r.p1))
        return AssignInfo(
            version=version, offset=rec.offset,
            prev_size=self._size_of(sh, blob_id, version - 1) if version > 1 else 0,
            new_size=rec.new_blob_size, root_pages=rec.root_pages,
            p0=rec.p0, p1=rec.p1, vp=rec.vp,
            vp_root_pages=self._root_pages_of(sh, blob_id, vp) if vp > 0 else 0,
            recent_updates=tuple(recent),
        )

    def _assign_locked(
        self,
        sh: LineageShard,
        blob_id: str,
        offset: Optional[int],
        size: int,
        client: str,
        pd: Tuple,
        key: Optional[str] = None,
    ) -> "AssignInfo":
        """Register one update; caller holds the shard lock and has
        already charged the wire."""
        if key is not None and sh.repl is not None:
            hit = sh.repl.assigned_keys.get(key)
            if hit is not None:
                # idempotent re-drive: this key's assignment is already
                # in the replicated journal — hand back the same version
                # instead of double-assigning
                return self._reassign_info_locked(sh, hit[0], hit[1])
        b = self._blob_in(sh, blob_id)
        prev_size = self._size_of(sh, blob_id, b.last_assigned)
        if offset is None:
            offset = prev_size           # APPEND semantics
            is_append = True
        else:
            is_append = False
            if offset > prev_size:
                raise WriteBeyondEnd(
                    f"offset {offset} > size {prev_size} of snapshot v{b.last_assigned}"
                )
        if size <= 0:
            raise ValueError("update size must be positive")
        vw = b.last_assigned + 1
        b.last_assigned = vw
        new_size = max(prev_size, offset + size)
        root_pages = root_pages_for(new_size, b.psize)
        p0, p1 = pages_spanned(offset, size, b.psize)
        rec = UpdateRecord(
            version=vw, offset=offset, size=size, new_blob_size=new_size,
            root_pages=root_pages, p0=p0, p1=p1, is_append=is_append,
            client=client, pd=tuple(pd), assigned_at=self._clock.now(),
        )
        b.updates[vw] = rec
        # §4.2: ranges of every update between the last published
        # snapshot and vw — the information from which the writer
        # resolves border nodes of concurrent unpublished updates.
        # The anchor vp must be a *live* (non-retired) published
        # version: the writer descends its tree, and GC keeps every
        # anchor of an in-flight update pinned until it completes.
        vp = self._latest_live_published(sh, b)
        rec.vp = vp if vp > 0 else None
        recent: List[Tuple[int, int, int]] = []
        for u in range(vp + 1, vw):
            r = b.updates.get(u)
            if r is not None and u not in b.retired:
                recent.append((r.version, r.p0, r.p1))
        vp_out: Optional[int] = vp if vp > 0 else None
        vp_root = self._root_pages_of(sh, blob_id, vp) if vp > 0 else 0
        self._journal(sh, {
            "op": "assign", "blob": blob_id, "v": vw, "offset": offset,
            "size": size, "new_size": new_size, "append": is_append,
            "client": client, "pd": [list(x) for x in pd],
            "vp": rec.vp, "key": key,
        })
        if key is not None and sh.repl is not None:
            sh.repl.assigned_keys[key] = (blob_id, vw)
        return AssignInfo(
            version=vw, offset=offset, prev_size=prev_size,
            new_size=new_size, root_pages=root_pages, p0=p0, p1=p1,
            vp=vp_out, vp_root_pages=vp_root, recent_updates=tuple(recent),
        )

    def assign_version(
        self,
        blob_id: str,
        offset: Optional[int],     # None => APPEND
        size: int,
        client: str,
        pd: Tuple = (),
        key: Optional[str] = None,
    ) -> "AssignInfo":
        """Register an update; returns everything the writer needs (§4.2).

        The page descriptors ``pd`` (for pages already stored) are
        journaled so a recovery agent can replay BUILD_META if the
        writer dies before completing its metadata.  The returned
        :class:`AssignInfo` carries the full border context (``vp``,
        ``vp_root_pages``, ``recent_updates``, the update's page
        extent), which is what lets the client *prefetch* its whole
        border set in level-batched waves before BUILD_META starts.

        ``key`` is an optional client-chosen idempotency token (see
        :meth:`assign_versions_many`).
        """
        sh = self._shard_of(blob_id)
        self._charge(client, sh)
        with sh.lock:
            info = self._assign_locked(sh, blob_id, offset, size, client,
                                       tuple(pd), key)
            self._repl_flush(sh)
            return info

    def assign_versions_many(
        self,
        requests: Sequence[Tuple[str, Optional[int], int, Tuple]],
        client: str,
        keys: Optional[Sequence[Optional[str]]] = None,
    ) -> List["AssignInfo"]:
        """Batched :meth:`assign_version`: ONE control round trip for
        many updates.

        ``requests`` holds ``(blob_id, offset_or_None, size, pd)``
        tuples (``None`` offset = APPEND); the result list matches the
        request order.  The whole batch pays a single wire latency plus
        ``VM_ASSIGN_REQ_BYTES`` per request — an appender issuing
        bursts of K amortizes the version-manager round trip K-fold,
        the paper's Fig 3 concern addressed the way ``get_many`` fixed
        the metadata read plane.

        Requests for one blob are assigned in list order, and each
        later request's ``recent_updates`` includes the earlier ones
        (they are in-flight registry entries by then), so a client can
        weave an entire burst without any extra border round trips.
        Requests for different blobs are routed to their lineage shards
        independently.  The batch is **atomic with respect to
        validation**: every request is validated against the batch's
        own running state (all touched shards locked, in sorted lineage
        order) before anything is assigned, so a request that fails
        (:class:`WriteBeyondEnd`, non-positive size, unknown blob)
        raises with NO version assigned — a failed batch never leaves
        half-assigned updates stalling a publication pipeline.

        ``keys`` (optional, aligned with ``requests``) are client-chosen
        idempotency tokens, journaled on the assign records.  With a
        replicated shard, re-driving a request whose key is already in
        the journal — a batch retried across a leader failover — returns
        the previously assigned version instead of assigning a new one,
        which is what makes writer retry loops double-assign-safe.
        """
        requests = [(blob_id, offset, size, tuple(pd))
                    for blob_id, offset, size, pd in requests]
        if not requests:
            return []
        if keys is None:
            keys = [None] * len(requests)
        shard_of: List[LineageShard] = [self._shard_of(blob_id)
                                        for blob_id, *_ in requests]
        self._charge_batch(len(requests), VM_ASSIGN_REQ_BYTES, "assign",
                           client, shards=shard_of)
        ordered = sorted({sh.lineage_id: sh for sh in shard_of}.values(),
                         key=lambda sh: sh.lineage_id)
        for sh in ordered:                 # sorted order: deadlock-free
            sh.lock.acquire()
        try:
            # phase 1: validate the whole batch against its running
            # per-blob state (sizes only grow within the batch);
            # re-driven requests (key already assigned) don't re-apply
            running: Dict[str, int] = {}   # blob -> projected size
            for i, (blob_id, offset, size, _pd) in enumerate(requests):
                sh = shard_of[i]
                if (keys[i] is not None and sh.repl is not None
                        and keys[i] in sh.repl.assigned_keys):
                    continue
                b = self._blob_in(sh, blob_id)
                prev = running.get(blob_id)
                if prev is None:
                    prev = self._size_of(sh, blob_id, b.last_assigned)
                if size <= 0:
                    raise ValueError("update size must be positive")
                if offset is not None and offset > prev:
                    raise WriteBeyondEnd(
                        f"offset {offset} > projected size {prev} "
                        f"of {blob_id} (request {i} of the batch)"
                    )
                off = prev if offset is None else offset
                running[blob_id] = max(prev, off + size)
            # phase 2: apply in request order (locks held throughout)
            out = [
                self._assign_locked(shard_of[i], blob_id, offset, size,
                                    client, pd, keys[i])
                for i, (blob_id, offset, size, pd) in enumerate(requests)
            ]
            for sh in ordered:
                self._repl_flush(sh)
            return out
        finally:
            for sh in reversed(ordered):
                sh.lock.release()

    def register_pd(self, blob_id: str, version: int, pd: Tuple,
                    client: Optional[str] = None) -> None:
        """(Re-)journal the final page-descriptor set for an update.

        Used by APPENDs (which learn their offset at assignment) and by
        unaligned WRITEs (whose boundary pages are stored after
        assignment).  Keeps WAL-based recovery deterministic.
        """
        sh = self._shard_of(blob_id)
        self._charge(client, sh)
        with sh.lock:
            rec = self._blob_in(sh, blob_id).updates[version]
            rec.pd = tuple(pd)
            self._journal(sh, {
                "op": "pd", "blob": blob_id, "v": version,
                "pd": [list(x) for x in pd],
            })
            self._repl_flush(sh)

    def _complete_locked(self, sh: LineageShard, blob_id: str,
                         version: int) -> None:
        """Mark ``version`` complete and publish in order; caller holds
        the shard cond's lock."""
        b = self._blob_in(sh, blob_id)
        rec = b.updates[version]
        rec.complete = True
        self._journal(sh, {"op": "complete", "blob": blob_id, "v": version})
        # In-order publication *per blob*: snapshot v is revealed only
        # once every snapshot < v of the same blob is published, so
        # readers can always resolve the full weaved tree of anything
        # they are allowed to see.  Other blobs — even in this lineage
        # — publish independently.
        while True:
            nxt = b.updates.get(b.published + 1)
            if nxt is None or not nxt.complete:
                break
            b.published += 1
            self._journal(sh, {"op": "publish", "blob": blob_id, "v": b.published})

    def metadata_complete(self, blob_id: str, version: int,
                          client: Optional[str] = None) -> None:
        """Writer finished BUILD_META; publish in order (atomicity).

        With a replicated shard the ack barriers on the follower
        streams (and the local fsync): a publication acked to a writer
        is durable on every live replica, so no failover can lose it."""
        sh = self._shard_of(blob_id)
        self._charge(client, sh)
        with sh.cond:
            self._complete_locked(sh, blob_id, version)
            self._flush_watch_locked(sh, blob_id)
            self._repl_flush(sh)
            sh.cond.notify_all()
        self._repl_barrier(sh)

    def metadata_complete_many(
        self,
        items: Sequence[Tuple[str, int]],
        client: Optional[str] = None,
    ) -> None:
        """Batched :meth:`metadata_complete`: ONE control round trip
        marks many ``(blob_id, version)`` updates complete and runs
        each blob's in-order publication.

        The batch pays one wire latency plus ``VM_COMPLETE_CMD_BYTES``
        per command.  Items are applied in list order per lineage
        (publication is per blob, so cross-blob order inside the batch
        is immaterial); SYNC waiters of every touched lineage are woken
        once per lineage.
        """
        items = list(items)
        if not items:
            return
        item_shards = [self._shard_of(blob_id) for blob_id, _ in items]
        self._charge_batch(len(items), VM_COMPLETE_CMD_BYTES, "complete",
                           client, shards=item_shards)
        groups: Dict[str, List[Tuple[str, int]]] = {}
        shards: Dict[str, LineageShard] = {}
        for (blob_id, version), sh in zip(items, item_shards):
            shards.setdefault(sh.lineage_id, sh)
            groups.setdefault(sh.lineage_id, []).append((blob_id, version))
        for lid in sorted(groups):
            sh = shards[lid]
            with sh.cond:
                for blob_id, version in groups[lid]:
                    self._complete_locked(sh, blob_id, version)
                # notify AFTER the whole lineage group published: a
                # K-item burst on one blob is ONE flush — one coalesced
                # entry per watcher, one RPC per inbox endpoint
                for bid in sorted({b for b, _ in groups[lid]}):
                    self._flush_watch_locked(sh, bid)
                self._repl_flush(sh)
                sh.cond.notify_all()
        for lid in sorted(groups):
            # durability barrier per touched lineage, outside every lock
            self._repl_barrier(shards[lid])

    def wait_metadata(self, blob_id: str, version: int,
                      timeout: Optional[float] = None) -> None:
        """Block until ``version``'s metadata is complete (not necessarily
        published).  Needed only by unaligned writes that must merge
        boundary-page content from snapshot ``version`` (§3 "slightly
        more complex" path)."""
        sh = self._shard_of(blob_id)
        deadline = None if timeout is None else self._clock.now() + timeout
        with sh.cond:
            while True:
                b = self._blob_in(sh, blob_id)
                if version <= b.base_version and b.parent is not None:
                    if self._record(sh, blob_id, version) is not None or version == 0:
                        return
                rec = b.updates.get(version)
                if version == 0 or version <= b.published or (rec is not None and rec.complete):
                    return
                remaining = None if deadline is None else deadline - self._clock.now()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"metadata {blob_id} v{version}")
                sh.cond.wait(remaining)

    # ----------------------------------------------------------- introspection
    def update_log(self, blob_id: str, version: int) -> UpdateRecord:
        """The journaled :class:`UpdateRecord` of ``version`` (walks
        branch lineage to the owner blob); raises
        :class:`VersionUnpublished` for never-assigned versions.
        Retirement does NOT hide the record — GC itself reads retired
        records to derive sweep candidates."""
        sh = self._shard_of(blob_id)
        with sh.lock:
            rec = self._record(sh, blob_id, version)
            if rec is None:
                raise VersionUnpublished(f"{blob_id} v{version} not assigned")
            return rec

    def version_bounds(self, blob_id: str) -> Tuple[int, int]:
        """``(base_version, last_assigned)`` of the blob: the half-open
        version interval ``(base, last]`` this blob *owns* (everything
        ``<= base`` is inherited from its branch parent).  Restore and
        GC iterate a blob's own history with this instead of reaching
        into manager internals."""
        sh = self._shard_of(blob_id)
        with sh.lock:
            b = self._blob_in(sh, blob_id)
            return b.base_version, b.last_assigned

    def root_pages_published(self, blob_id: str, version: int) -> int:
        """Page span of the snapshot's segment-tree root, for published,
        non-retired versions (the read path's entry point to the tree)."""
        sh = self._shard_of(blob_id)
        with sh.lock:
            if version > self._blob_in(sh, blob_id).published:
                raise VersionUnpublished(f"{blob_id} v{version} not published")
            if version > 0:
                self._check_not_retired(sh, blob_id, version)
            return self._root_pages_of(sh, blob_id, version)

    def known_blobs(self) -> List[str]:
        """Every blob id this manager has created (branches included),
        in global creation order."""
        with self._registry_lock:
            return list(self._blob_order)

    def leader_endpoint(self, blob_id: str) -> str:
        """The wire endpoint currently serving this blob's lineage:
        the shared ``vmgr`` endpoint with replication off, the lineage's
        current leader (followers promote on failover) with it on.
        Failure injection kills *this* to exercise a failover."""
        sh = self._shard_of(blob_id)
        with sh.lock:
            return sh.repl.leader_ep if sh.repl is not None else VMGR_ENDPOINT

    def replication_report(self, blob_id: str) -> dict:
        """HA state of the blob's lineage, for tests and operators:
        leader endpoint, per-follower journal length and lost flag,
        failover epoch and current lease expiry."""
        sh = self._shard_of(blob_id)
        with sh.lock:
            repl = sh.repl
            if repl is None:
                return {"leader": VMGR_ENDPOINT, "followers": [],
                        "epoch": 0, "lease_expires_at": None}
            return {
                "leader": repl.leader_ep,
                "followers": [(f.endpoint, len(f.records), f.lost)
                              for f in repl.followers],
                "epoch": repl.epoch,
                "lease_expires_at": repl.lease_expires_at,
            }

    def follower_records(self, blob_id: str, index: int = 0) -> List[dict]:
        """Copy of one follower's replicated journal (the prefix of the
        leader's journal successfully streamed to it) — the input the
        follower-replay equivalence property test feeds back through
        :meth:`replay_lineage`."""
        sh = self._shard_of(blob_id)
        with sh.lock:
            if sh.repl is None:
                return []
            return list(sh.repl.followers[index].records)

    # ------------------------------------------- subscription plane: watch
    def register_inbox(self, inbox) -> None:
        """Register a delivery inbox (anything with ``.endpoint`` and
        ``.deliver(entries, ready_at=...)``) as a notify target.
        Inboxes are process memory: they survive leader failover (the
        promoted leader keeps pushing to the same endpoints) but die
        with the manager process — after a cold restart clients
        re-watch and re-register."""
        with self._watches_lock:
            self._inboxes[inbox.endpoint] = inbox

    def watch(self, blob_id: str, from_version: int = 0, *,
              endpoint: str, client: Optional[str] = None,
              ttl: Optional[float] = None) -> str:
        """WATCH: lease a push subscription on ``blob_id``.

        Every publication with version ``> from_version`` is delivered
        to ``endpoint`` (see :meth:`register_inbox`), coalesced per
        watcher — versions already published at registration time are
        caught up immediately in one entry.  ``ttl`` arms the same
        absolute-clock expiry as GC pin leases (renewable via
        :meth:`renew_watch`; ``None`` = until :meth:`unwatch`).  The
        lease replicates through the lineage journal, so it survives
        leader failover; retired versions are skipped (a watcher never
        receives a version its own poll could not read), but the
        watermark still advances past them.  Returns the lease id."""
        if from_version < 0:
            raise ValueError("from_version must be >= 0")
        sh = self._shard_of(blob_id)
        self._charge(client, sh, nbytes=VM_WATCH_REQ_BYTES)
        with sh.cond:
            self._blob_in(sh, blob_id)
            with self._watches_lock:
                wid = f"watch-{next(self._watch_ids):08d}"
                self._watch_of[wid] = blob_id
            expires = None if ttl is None else self._clock.now() + ttl
            lease = WatchLease(wid, blob_id, client, endpoint,
                               from_version, from_version, expires)
            sh.watches.setdefault(blob_id, {})[wid] = lease
            self._journal(sh, {"op": "watch", "blob": blob_id,
                               "watch": wid, "from": from_version,
                               "endpoint": endpoint, "client": client,
                               "expires": expires})
            # catch-up delivery: anything already published past
            # from_version goes out now, as one coalesced entry
            self._flush_watch_locked(sh, blob_id)
            self._repl_flush(sh)
        with self._ctr_lock:
            self._watch_ctr["registered"] += 1
        self._repl_barrier(sh)
        return wid

    def unwatch(self, watch_id: str, client: Optional[str] = None) -> None:
        """Cancel a watch lease (idempotent: unknown/expired ids are
        no-ops, like :meth:`unpin`); nothing is delivered afterward."""
        with self._watches_lock:
            blob_id = self._watch_of.get(watch_id)
        if blob_id is None:
            self._charge(client, nbytes=VM_WATCH_REQ_BYTES)
            return
        sh = self._shard_of(blob_id)
        self._charge(client, sh, nbytes=VM_WATCH_REQ_BYTES)
        with sh.lock:
            if sh.watches.get(blob_id, {}).pop(watch_id, None) is None:
                return
            with self._watches_lock:
                self._watch_of.pop(watch_id, None)
            self._journal(sh, {"op": "unwatch", "watch": watch_id,
                               "blob": blob_id})
            self._repl_flush(sh)
        with self._ctr_lock:
            self._watch_ctr["unwatched"] += 1

    def renew_watch(self, watch_id: str, ttl: Optional[float],
                    client: Optional[str] = None) -> None:
        """Extend (or make permanent, ``ttl=None``) a watch lease's
        expiry — the pin-lease renewal rule on the watch table.  Raises
        ``KeyError`` for unknown/already-expired leases."""
        with self._watches_lock:
            blob_id = self._watch_of.get(watch_id)
        if blob_id is None:
            raise KeyError(f"unknown watch lease {watch_id!r}")
        sh = self._shard_of(blob_id)
        self._charge(client, sh, nbytes=VM_WATCH_REQ_BYTES)
        with sh.lock:
            lease = sh.watches.get(blob_id, {}).get(watch_id)
            if lease is None:
                raise KeyError(f"unknown watch lease {watch_id!r}")
            lease.expires_at = (None if ttl is None
                                else self._clock.now() + ttl)
            self._journal(sh, {"op": "watch_renew", "watch": watch_id,
                               "blob": blob_id,
                               "expires": lease.expires_at})
            self._repl_flush(sh)
        with self._ctr_lock:
            self._watch_ctr["renewed"] += 1

    def watch_report(self, blob_id: str) -> List[WatchLease]:
        """Current watch leases on ``blob_id`` (tests and operators)."""
        sh = self._shard_of(blob_id)
        with sh.lock:
            return list(sh.watches.get(blob_id, {}).values())

    def _flush_watch_locked(self, sh: LineageShard, blob_id: str) -> None:
        """Coalesce and push the pending publication gap of every live
        watcher of ``blob_id``; caller holds the shard lock (runs at
        publication, at registration catch-up and after failover
        replay).

        Per flush each watcher costs ONE coalesced entry covering its
        whole ``(delivered_up_to, published]`` gap, and all entries
        bound for the same inbox endpoint ride ONE fire-and-forget
        batch — a K-publication burst pays O(endpoints-with-watchers)
        notify RPCs, independent of the watcher count.  Expired leases
        are pruned here (nothing is sent to them); retired versions are
        filtered out but the watermark still advances past them."""
        table = sh.watches.get(blob_id)
        if not table:
            return
        b = self._blob_in(sh, blob_id)
        pub = b.published
        now = self._clock.now()
        expired = [wid for wid, lease in table.items()
                   if lease.expires_at is not None and lease.expires_at < now]
        if expired:
            for wid in expired:
                del table[wid]
            with self._watches_lock:
                for wid in expired:
                    self._watch_of.pop(wid, None)
            with self._ctr_lock:
                self._watch_ctr["expired"] += len(expired)
        by_ep: Dict[str, List[Tuple[str, Tuple[int, ...]]]] = {}
        advanced = False
        for wid in sorted(table):       # sorted: deterministic fan-out
            lease = table[wid]
            if lease.delivered_up_to >= pub:
                continue
            versions = tuple(
                v for v in range(lease.delivered_up_to + 1, pub + 1)
                if v not in self._owner_record(sh, blob_id, v).retired)
            lease.delivered_up_to = pub
            advanced = True
            if versions:
                by_ep.setdefault(lease.endpoint, []).append((wid, versions))
        if by_ep:
            self._send_notify(sh, blob_id, by_ep)
        if advanced:
            # coarse per-blob watermark record: replay raises every
            # lease registered before it to pub (see replay_lineage),
            # which is what lets a promoted follower resume deliveries
            # with no gap (stale watermark -> re-flush; the inbox
            # watermark dedups) and no duplicate
            self._journal(sh, {"op": "notify", "blob": blob_id, "v": pub})

    def _send_notify(self, sh: LineageShard, blob_id: str,
                     by_ep: Dict[str, List[Tuple[str, Tuple[int, ...]]]]) -> None:
        """Ship one batched fire-and-forget notify per inbox endpoint
        (the PR 4/5 primitive: charged on the receiving endpoint, never
        blocks the publishing verb — safe under the shard lock).  A
        down endpoint drops its batch: at-most-once to dead inboxes;
        the lease still advances and eventually expires via its ttl."""
        repl = sh.repl
        leader = repl.leader_ep if repl is not None else VMGR_ENDPOINT
        rpcs = entries = nvers = dropped = 0
        for ep in sorted(by_ep):
            batch = by_ep[ep]
            done_at = 0.0
            if self.wire is not None:
                try:
                    done_at = self.wire.transfer_batch(
                        ep, [WATCH_NOTIFY_EVT_BYTES] * len(batch),
                        inbound=True, peer=leader, fire_and_forget=True)
                except EndpointDown:
                    dropped += len(batch)
                    continue
            rpcs += 1
            entries += len(batch)
            nvers += sum(len(vs) for _, vs in batch)
            with self._watches_lock:
                inbox = self._inboxes.get(ep)
            if inbox is not None:
                inbox.deliver([(wid, blob_id, vs) for wid, vs in batch],
                              ready_at=done_at)
        with self._ctr_lock:
            self._watch_ctr["notify_rpcs"] += rpcs
            self._watch_ctr["notify_entries"] += entries
            self._watch_ctr["notify_versions"] += nvers
            self._watch_ctr["dropped_sends"] += dropped

    # ------------------------------------------------ GC: pins + read leases
    def pin(self, blob_id: str, version: int, client: Optional[str] = None,
            ttl: Optional[float] = None) -> str:
        """Pin ``(blob, version)``: GC keeps it until :meth:`unpin` or the
        lease's clock-based expiry.  Returns the lease id.

        Pin records replicate with the journal: a failover rebuilds the
        new leader's lease table from them (expiries are absolute clock
        instants, so they stay valid across the promotion), while a cold
        :meth:`recover_from_wal` still drops all leases — process death
        releases pins, leader death does not."""
        sh = self._shard_of(blob_id)
        self._charge(client, sh)
        with sh.lock:
            b = self._blob_in(sh, blob_id)
            if version <= 0 or version > b.published:
                raise VersionUnpublished(f"{blob_id} v{version} not published")
            self._check_not_retired(sh, blob_id, version)
            with self._pins_lock:
                lease_id = f"pin-{next(self._pin_ids):08d}"
                expires = None if ttl is None else self._clock.now() + ttl
                self._pins[lease_id] = PinLease(lease_id, blob_id, version,
                                                client, expires)
            self._journal(sh, {"op": "pin", "blob": blob_id, "v": version,
                               "lease": lease_id, "client": client,
                               "expires": expires})
            self._repl_flush(sh)
            return lease_id

    def unpin(self, lease_id: str, client: Optional[str] = None) -> None:
        """Release a pin lease (idempotent: unknown/expired ids are
        no-ops); the snapshot becomes retireable at the next GC plan."""
        with self._pins_lock:
            pin = self._pins.get(lease_id)
        if pin is None:
            self._charge(client)
            return
        sh = self._shard_of(pin.blob_id)
        self._charge(client, sh)
        with sh.lock:
            with self._pins_lock:
                if self._pins.pop(lease_id, None) is None:
                    return
            self._journal(sh, {"op": "unpin", "lease": lease_id})
            self._repl_flush(sh)

    def _live_pins(self, sh: LineageShard, blob_id: str) -> Set[int]:
        """Unexpired pinned versions, recorded on the *owner* blob of
        each pinned version (a pin through a branch pins the ancestor's
        snapshot).  Expired leases are pruned.  Caller holds the shard
        lock; only pins of this shard's lineage can resolve to
        ``blob_id``, so the owner walk stays in-shard."""
        now = self._clock.now()
        with self._pins_lock:
            expired = [lid for lid, p in self._pins.items()
                       if p.expires_at is not None and p.expires_at < now]
            for lid in expired:
                del self._pins[lid]
            candidates = [p for p in self._pins.values()
                          if p.blob_id in sh.blobs]
        out: Set[int] = set()
        for p in candidates:
            if self._owner_record(sh, p.blob_id, p.version).blob_id == blob_id:
                out.add(p.version)
        return out

    def pinned_versions(self, blob_id: str) -> FrozenSet[int]:
        """Versions currently protected by unexpired pin leases, keyed
        by *owner* blob (a pin taken through a branch shows up here on
        the ancestor that owns the pinned snapshot)."""
        sh = self._shard_of(blob_id)
        with sh.lock:
            return frozenset(self._live_pins(sh, blob_id))

    def pins(self) -> List[PinLease]:
        """All currently held (possibly expired) pin leases."""
        with self._pins_lock:
            return list(self._pins.values())

    def enter_read(self, blob_id: str, version: int,
                   client: Optional[str] = None) -> Tuple[int, int]:
        """Open a read lease on a published snapshot; returns the
        snapshot's ``(size, root_pages)`` atomically with admission.

        The lease makes the sweep's drain barrier possible: GC retires a
        version (after which ``enter_read`` answers ``RetiredVersion``)
        and then waits until every lease opened *before* the intent has
        been released — an in-flight read never races its pages being
        deleted.  Reads of kept versions are never blocked or drained;
        their safety comes from the mark phase.  Returning the root
        snapshot here means an admitted read needs no further
        retired-checked version-manager call: a retire-intent landing
        after admission cannot spuriously fail it (the drain barrier
        lets it complete).
        """
        sh = self._shard_of(blob_id)
        self._charge(client, sh)
        with sh.lock:
            b = self._blob_in(sh, blob_id)
            if version > b.published:
                raise VersionUnpublished(f"{blob_id} v{version} not published")
            if version == 0:
                return 0, 0
            self._check_not_retired(sh, blob_id, version)
            owner = self._owner_record(sh, blob_id, version).blob_id
            key = (owner, version)
            sh.active_reads[key] = sh.active_reads.get(key, 0) + 1
            return (self._size_of(sh, blob_id, version),
                    self._root_pages_of(sh, blob_id, version))

    def exit_read(self, blob_id: str, version: int,
                  client: Optional[str] = None) -> None:
        """Release a read lease opened by :meth:`enter_read`."""
        if version == 0:
            return
        sh = self._shard_of(blob_id)
        self._charge(client, sh)
        with sh.cond:
            owner = self._owner_record(sh, blob_id, version).blob_id
            key = (owner, version)
            n = sh.active_reads.get(key, 0) - 1
            if n <= 0:
                sh.active_reads.pop(key, None)
            else:
                sh.active_reads[key] = n
            sh.cond.notify_all()

    def wait_reads_drained(self, blob_id: str, versions: Iterable[int],
                           timeout: Optional[float] = None) -> None:
        """Block until no read lease on ``(blob, v in versions)`` remains.

        The sweep's drain barrier: called after retire-intent (so no new
        lease on those versions can be opened) and before any delete is
        issued.  Blocks through the clock, so it is virtual-time-correct
        under the simulator, and waits only on the blob's lineage shard.
        """
        keys = [(blob_id, v) for v in sorted(set(versions))]
        sh = self._shard_of(blob_id)
        deadline = None if timeout is None else self._clock.now() + timeout
        with sh.cond:
            while any(sh.active_reads.get(k, 0) > 0 for k in keys):
                remaining = None if deadline is None else deadline - self._clock.now()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"reads of {blob_id} did not drain")
                sh.cond.wait(remaining)

    # -------------------------------------------- GC: retention + retirement
    def set_retention(self, blob_id: str, keep_last: int,
                      client: Optional[str] = None) -> None:
        """Retention policy: GC keeps the newest ``keep_last`` published
        snapshots (0 = keep everything).  Journaled, so a recovered
        manager enforces the same policy."""
        if keep_last < 0:
            raise ValueError("keep_last must be >= 0")
        sh = self._shard_of(blob_id)
        self._charge(client, sh)
        with sh.lock:
            self._blob_in(sh, blob_id).keep_last = keep_last
            self._journal(sh, {"op": "retention", "blob": blob_id,
                               "keep_last": keep_last})
            self._repl_flush(sh)

    def gc_epoch(self, blob_id: str) -> int:
        """Monotone retirement epoch: bumped (and journaled) every time
        :meth:`plan_retirement` retires at least one version.  Cache
        layers key their eviction notifications off it (see
        :meth:`add_gc_listener`)."""
        sh = self._shard_of(blob_id)
        with sh.lock:
            return self._blob_in(sh, blob_id).gc_epoch

    def retired_versions(self, blob_id: str) -> FrozenSet[int]:
        """Versions under retire-intent on this blob (swept or not):
        reads/pins/branches of them answer :class:`RetiredVersion`."""
        sh = self._shard_of(blob_id)
        with sh.lock:
            return frozenset(self._blob_in(sh, blob_id).retired)

    def plan_retirement(
        self,
        blob_id: str,
        keep_extra: Optional[Iterable[int]] = None,
        explicit: bool = False,
        client: Optional[str] = None,
    ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Atomically decide and journal this blob's retirement set.

        Returns ``(kept, newly_retired)`` over the blob's *own* published
        versions (inherited versions ``<= base`` belong to the ancestor's
        plan).  Kept is the union of

        * the retention window (newest ``keep_last`` published; all of
          them when no policy is set and ``explicit`` is False),
        * ``keep_extra`` (the explicit keep set of the old GC API; with
          ``explicit=True`` it *replaces* the retention window),
        * unexpired pin leases,
        * branch roots: any version this blob *owns* that some blob was
          forked at — including forks taken through an intermediate
          branch at an inherited version,
        * the ``vp`` anchor of every assigned-but-incomplete update
          (an in-flight writer descends that tree for border nodes),
        * always the newest published version (new updates anchor on it).

        Every rule above is an intra-lineage fact (branches join their
        ancestor's shard), so the whole plan runs under ONE shard lock
        and scans only this lineage's blobs — a GC round never touches
        another lineage's critical section.

        Marking is the retire-*intent*: from this instant every
        ``enter_read``/``pin``/``branch`` of a retired version answers
        ``RetiredVersion``.  The intent is journaled before any sweep
        RPC goes out, so recovery can never resurrect a version whose
        pages might be partially deleted.
        """
        sh = self._shard_of(blob_id)
        self._charge(client, sh)
        with sh.lock:
            b = self._blob_in(sh, blob_id)
            published = set(range(b.base_version + 1, b.published + 1))
            if not published:
                return (), ()
            if explicit:
                keep: Set[int] = set(keep_extra or ())
            elif b.keep_last > 0:
                keep = set(range(b.published - b.keep_last + 1,
                                 b.published + 1))
                keep.update(keep_extra or ())
            else:
                keep = set(published)
            keep.add(b.published)
            keep.update(self._live_pins(sh, blob_id))
            for other in sh.blobs.values():
                # owner-normalized like pins: a fork point at an inherited
                # version (C = branch(B, 3) where v3 is owned by A, B's
                # ancestor) must be kept by v3's *owner*, not by the blob
                # named in parent[0]
                if (other.parent is not None and other.parent[1] > 0
                        and self._owner_record(
                            sh, other.parent[0], other.parent[1]).blob_id
                        == blob_id):
                    keep.add(other.parent[1])
                for u in range(other.published + 1, other.last_assigned + 1):
                    r = other.updates.get(u)
                    if (r is not None and not r.complete and r.vp is not None
                            and self._owner_record(sh, other.blob_id, r.vp).blob_id
                            == blob_id):
                        keep.add(r.vp)
            newly = sorted(published - keep - b.retired)
            kept = tuple(sorted(published - set(newly) - b.retired))
            epoch = b.gc_epoch
            retired_page_ids: List[str] = []
            if newly:
                b.retired.update(newly)
                b.gc_epoch += 1
                epoch = b.gc_epoch
                self._journal(sh, {"op": "retire", "blob": blob_id,
                                   "versions": newly, "epoch": epoch})
                self._repl_flush(sh)
                for v in newly:
                    rec = b.updates.get(v)
                    if rec is not None:
                        retired_page_ids.extend(pid for pid, *_ in rec.pd)
        if newly:
            # retire-intent is GC-visible state: make it durable on the
            # replicas before any sweep delete can go out (a failover
            # must never resurrect a version whose pages are half gone)
            self._repl_barrier(sh)
            # Epoch notification outside the lock: listeners (the shared
            # page cache) may take their own locks; the journal record
            # above is already durable, so a listener crash cannot lose
            # the intent.
            for fn in list(self._gc_listeners):
                fn(blob_id, tuple(newly), epoch, tuple(retired_page_ids))
        return kept, tuple(newly)

    def add_gc_listener(self, fn) -> None:
        """Subscribe ``fn(blob_id, versions, gc_epoch, page_ids)`` to
        retire-intent (gc_epoch bump) notifications — the cache-eviction
        hook: a retired version's pages leave the shared page cache at
        intent time, before any sweep delete goes out."""
        self._gc_listeners.append(fn)

    def sweep_pending(self, blob_id: str) -> List[UpdateRecord]:
        """Retired-but-not-yet-finalized updates, oldest first.  The
        sweep derives each one's candidate set from the journaled page
        descriptors and the deterministic tree shape — no store scan."""
        sh = self._shard_of(blob_id)
        with sh.lock:
            b = self._blob_in(sh, blob_id)
            return [b.updates[v] for v in sorted(b.retired - b.swept)
                    if v in b.updates]

    def finalize_sweep(self, blob_id: str, versions: Iterable[int],
                       client: Optional[str] = None) -> None:
        """Journal that the sweep of ``versions`` completed (all deletes
        acknowledged).  Unfinalized versions are re-swept next round —
        deletes are idempotent, so partial rounds are safe."""
        versions = sorted(set(versions))
        if not versions:
            return
        sh = self._shard_of(blob_id)
        self._charge(client, sh)
        with sh.lock:
            self._blob_in(sh, blob_id).swept.update(versions)
            self._journal(sh, {"op": "swept", "blob": blob_id,
                               "versions": versions})
            self._repl_flush(sh)
        self._repl_barrier(sh)

    def unfinalize_sweep(self, blob_id: str, versions: Iterable[int],
                         client: Optional[str] = None) -> None:
        """Journal that ``versions`` need re-sweeping despite a prior
        finalize: the restore-time resweep found work left (restore
        resurrects a finalized version's nodes/pages, and a re-delete
        can partially fail, e.g. a provider down during recovery).
        Pulling them out of the finalized set puts them back in
        :meth:`sweep_pending`, so ordinary live rounds retry the
        deletes instead of leaking the resurrected items until the
        next restart."""
        versions = set(versions)
        if not versions:
            return
        sh = self._shard_of(blob_id)
        self._charge(client, sh)
        with sh.lock:
            b = self._blob_in(sh, blob_id)
            versions = sorted(versions & b.swept)
            if not versions:
                return  # never finalized: already pending, nothing to journal
            b.swept.difference_update(versions)
            self._journal(sh, {"op": "unswept", "blob": blob_id,
                               "versions": versions})
            self._repl_flush(sh)
        self._repl_barrier(sh)

    def all_page_ids(self) -> Set[str]:
        """Every page id any assigned update (any blob, any version,
        published or in flight, retired or not) has ever journaled.
        The GC orphan scan treats pages outside this set — stored but
        never registered, e.g. a restriped optimistic append or a
        writer that died before version assignment — as collectable
        once they outlive the grace window."""
        out: Set[str] = set()
        for sh in self._all_shards():
            with sh.lock:
                for b in sh.blobs.values():
                    for rec in b.updates.values():
                        for pd in rec.pd:
                            out.add(pd[0])
        return out

    def page_locations(self) -> Dict[str, Tuple[str, Tuple[str, ...], int]]:
        """Durability inventory: every *live* journaled page's
        ``page_id -> (blob_id, providers, length)``.

        The scrub plane diffs this against what providers actually hold
        to find dead-provider gaps and missing copies; the lifecycle
        plane uses the blob id to apply per-blob demotion policy.  Pages
        of swept versions are excluded (their bytes are gone or going —
        repairing them would resurrect garbage), and a page journaled by
        several versions (copy-on-write sharing, dedup hits) reports the
        first descriptor seen — descriptors for one page are identical
        by construction.  Local control-plane bookkeeping, like
        :meth:`all_page_ids` (the GC's orphan scan twin).
        """
        out: Dict[str, Tuple[str, Tuple[str, ...], int]] = {}
        for sh in self._all_shards():
            with sh.lock:
                for bid in sorted(sh.blobs):
                    b = sh.blobs[bid]
                    for v in sorted(b.updates):
                        if v in b.swept:
                            continue
                        for pd in b.updates[v].pd:
                            pid, _rel, provs, length = pd
                            out.setdefault(
                                pid, (b.blob_id, tuple(provs), length))
        return out

    def mark_roots(self) -> Dict[str, List[Tuple[int, int]]]:
        """Every live snapshot the mark phase must walk: blob id ->
        [(version, root_pages)] over the blob's own published, non-retired
        versions.  Inherited versions appear under their owner blob."""
        out: Dict[str, List[Tuple[int, int]]] = {}
        for sh in self._all_shards():
            with sh.lock:
                for b in sh.blobs.values():
                    roots = [(v, b.updates[v].root_pages)
                             for v in range(b.base_version + 1, b.published + 1)
                             if v not in b.retired and v in b.updates]
                    if roots:
                        out[b.blob_id] = roots
        return out

    # ------------------------------------------------------- failure handling
    def find_stalled(self, timeout: float) -> List[Tuple[str, UpdateRecord]]:
        """Assigned-but-incomplete updates older than ``timeout`` seconds.

        These block their own blob's publication pipeline (in-order
        publishing is per blob — other blobs keep publishing); a
        recovery agent replays their metadata from the journaled page
        descriptors and calls :meth:`metadata_complete`.
        """
        now = self._clock.now()
        out = []
        for sh in self._all_shards():
            with sh.lock:
                for b in sh.blobs.values():
                    for v in range(b.published + 1, b.last_assigned + 1):
                        rec = b.updates.get(v)
                        if rec is not None and not rec.complete and now - rec.assigned_at > timeout:
                            out.append((b.blob_id, rec))
        return out

    def assign_info_for_recovery(self, blob_id: str, version: int) -> "AssignInfo":
        """Reconstruct the AssignInfo a dead writer was handed."""
        sh = self._shard_of(blob_id)
        with sh.lock:
            b = self._blob_in(sh, blob_id)
            rec = b.updates[version]
            vp = b.published
            recent = tuple(
                (r.version, r.p0, r.p1)
                for u in range(vp + 1, version)
                if (r := b.updates.get(u)) is not None
            )
            return AssignInfo(
                version=version, offset=rec.offset,
                prev_size=self._size_of(sh, blob_id, version - 1) if version > 1 else 0,
                new_size=rec.new_blob_size, root_pages=rec.root_pages,
                p0=rec.p0, p1=rec.p1,
                vp=vp if vp > 0 else None,
                vp_root_pages=self._root_pages_of(sh, blob_id, vp) if vp > 0 else 0,
                recent_updates=recent,
            )

    # ------------------------------------------------------------ WAL recovery
    @staticmethod
    def _apply_blob_op(b: BlobRecord, rec: dict, now: float) -> None:
        """Apply one journaled blob op to its record — THE replay rule,
        shared verbatim by cold WAL recovery and failover promotion (so
        a promoted follower rebuilds exactly the state a restarted
        manager would)."""
        op = rec["op"]
        if op == "assign":
            psz = b.psize
            p0, p1 = pages_spanned(rec["offset"], rec["size"], psz)
            b.updates[rec["v"]] = UpdateRecord(
                version=rec["v"], offset=rec["offset"], size=rec["size"],
                new_blob_size=rec["new_size"],
                root_pages=root_pages_for(rec["new_size"], psz),
                p0=p0, p1=p1, is_append=rec["append"], client=rec["client"],
                pd=tuple(tuple(x) for x in rec["pd"]),
                # stamp on the VM's own clock: the wall-time default
                # would make find_stalled never fire under a virtual
                # clock (now() - monotonic is hugely negative)
                assigned_at=now,
                vp=rec.get("vp"),
            )
            b.last_assigned = max(b.last_assigned, rec["v"])
        elif op == "pd":
            b.updates[rec["v"]].pd = tuple(tuple(x) for x in rec["pd"])
        elif op == "complete":
            b.updates[rec["v"]].complete = True
        elif op == "publish":
            b.published = rec["v"]
        elif op == "retention":
            b.keep_last = rec["keep_last"]
        elif op == "retire":
            b.retired.update(rec["versions"])
            b.gc_epoch = max(b.gc_epoch, rec.get("epoch", 0))
        elif op == "swept":
            b.swept.update(rec["versions"])
        elif op == "unswept":
            b.swept.difference_update(rec["versions"])

    def replay_lineage(
        self, records: Sequence[dict],
    ) -> Tuple[Dict[str, BlobRecord], Dict[str, PinLease],
               Dict[str, Tuple[str, int]], Dict[str, Dict[str, WatchLease]]]:
        """Rebuild one lineage's state from a journal prefix: the blob
        records, the still-unexpired pin leases, the assign idempotency
        keys and the watch-lease tables.  This is what failover runs on
        the promoted follower's journal; the follower-replay
        equivalence property test replays arbitrary prefixes through it
        and compares against the leader.  Records must be a *prefix* of
        one lineage's journal (the order its shard lock serialized).

        Watch rules: a ``watch`` record opens the lease at its
        ``from`` watermark; each ``notify`` record raises every lease
        of its blob registered before it to the journaled publication
        watermark — so a promoted leader's ``delivered_up_to`` is
        exactly what the old leader last journaled, and its first
        post-failover flush re-covers at most the un-journaled tail
        (the inbox watermark drops the overlap).  Expired leases are
        pruned once at the end (renewals may extend mid-journal)."""
        now = self._clock.now()
        blobs: Dict[str, BlobRecord] = {}
        pins: Dict[str, PinLease] = {}
        keys: Dict[str, Tuple[str, int]] = {}
        watches: Dict[str, Dict[str, WatchLease]] = {}
        for rec in records:
            op = rec["op"]
            if op == "create":
                bid = rec["blob"]
                blobs[bid] = BlobRecord(bid, rec["psize"], lineage_id=rec["lineage"])
            elif op == "branch":
                src = blobs[rec["src"]]
                blobs[rec["blob"]] = BlobRecord(
                    blob_id=rec["blob"], psize=src.psize,
                    parent=(rec["src"], rec["at"]), base_version=rec["at"],
                    last_assigned=rec["at"], published=rec["at"],
                    lineage_id=src.lineage_id,
                )
            elif op == "pin":
                exp = rec["expires"]
                if exp is None or exp > now:
                    pins[rec["lease"]] = PinLease(rec["lease"], rec["blob"],
                                                  rec["v"], rec.get("client"),
                                                  exp)
            elif op == "unpin":
                pins.pop(rec["lease"], None)
            elif op == "watch":
                watches.setdefault(rec["blob"], {})[rec["watch"]] = WatchLease(
                    rec["watch"], rec["blob"], rec.get("client"),
                    rec["endpoint"], rec["from"], rec["from"],
                    rec["expires"])
            elif op == "unwatch":
                watches.get(rec["blob"], {}).pop(rec["watch"], None)
            elif op == "watch_renew":
                lease = watches.get(rec["blob"], {}).get(rec["watch"])
                if lease is not None:
                    lease.expires_at = rec["expires"]
            elif op == "notify":
                for lease in watches.get(rec["blob"], {}).values():
                    if lease.delivered_up_to < rec["v"]:
                        lease.delivered_up_to = rec["v"]
            elif op == "failover":
                pass   # audit record: carries no state
            else:
                b = blobs[rec["blob"]]
                self._apply_blob_op(b, rec, now)
                if op == "assign" and rec.get("key") is not None:
                    keys[rec["key"]] = (rec["blob"], rec["v"])
        for table in watches.values():
            for wid in [w for w, lease in table.items()
                        if lease.expires_at is not None
                        and lease.expires_at < now]:
                del table[wid]
        return blobs, pins, keys, watches

    @classmethod
    def recover_from_wal(cls, wal_path: str, wire: Optional[Wire] = None, *,
                         replication: int = 0, lease_ttl: float = 0.25,
                         fsync_policy: str = "batch") -> "VersionManager":
        """Rebuild full version-manager state from the journal.

        ``create`` records root a lineage shard (the record's lineage
        id is the blob itself); ``branch`` records join their source's
        shard.  Every other record is routed to its lineage's shard —
        replay order only matters *within* a lineage, which is exactly
        the order each shard's lock serialized at journal time.  Pin
        (lease) and ``failover`` audit records are skipped: leases die
        with the process, and epochs restart at 1.

        With ``replication > 0`` the recovered manager also rebuilds
        each lineage's replica group, bulk-streaming the recovered
        journal to the fresh followers (wire-accounted) so they are
        caught up from the first verb.
        """
        vm = cls(wire=wire, replication=replication, lease_ttl=lease_ttl,
                 fsync_policy=fsync_policy)
        max_id = 0
        records_by_lineage: Dict[str, List[dict]] = {}

        def blob_rec(blob_id: str) -> BlobRecord:
            return vm._shards[vm._lineage_of[blob_id]].blobs[blob_id]

        with open(wal_path) as f:
            for line in f:
                rec = json.loads(line)
                op = rec["op"]
                if "lineage" in rec:
                    records_by_lineage.setdefault(rec["lineage"], []).append(rec)
                if op == "create":
                    bid = rec["blob"]
                    sh = LineageShard(bid, vm._clock)
                    sh.blobs[bid] = BlobRecord(bid, rec["psize"],
                                               lineage_id=bid)
                    vm._shards[bid] = sh
                    vm._lineage_of[bid] = bid
                    vm._blob_order.append(bid)
                    max_id = max(max_id, int(bid.split("-")[1]))
                elif op == "branch":
                    src = blob_rec(rec["src"])
                    lid = src.lineage_id
                    vm._shards[lid].blobs[rec["blob"]] = BlobRecord(
                        blob_id=rec["blob"], psize=src.psize,
                        parent=(rec["src"], rec["at"]), base_version=rec["at"],
                        last_assigned=rec["at"], published=rec["at"],
                        lineage_id=lid,
                    )
                    vm._lineage_of[rec["blob"]] = lid
                    vm._blob_order.append(rec["blob"])
                    max_id = max(max_id, int(rec["blob"].split("-")[1]))
                elif op in ("pin", "unpin", "failover",
                            "watch", "unwatch", "watch_renew", "notify"):
                    # soft state: a restarted manager drops pin AND
                    # watch leases (inboxes are process memory —
                    # clients re-watch after a cold restart)
                    pass
                else:
                    vm._apply_blob_op(blob_rec(rec["blob"]), rec, vm._clock.now())
        vm._ids = itertools.count(max_id + 1)
        vm._wal_path = wal_path
        vm._wal_file = open(wal_path, "a")
        if replication > 0:
            for lid in sorted(vm._shards):
                sh = vm._shards[lid]
                sh.repl = _ShardReplication(lid, replication, lease_ttl,
                                            vm._clock.now())
                for rec in records_by_lineage.get(lid, ()):
                    if rec["op"] == "assign" and rec.get("key") is not None:
                        sh.repl.assigned_keys[rec["key"]] = (rec["blob"], rec["v"])
                sh.repl.pending = list(records_by_lineage.get(lid, ()))
                with sh.lock:
                    vm._repl_flush(sh)
        return vm


@dataclass(frozen=True)
class AssignInfo:
    """Everything a writer receives from the version manager (§4.2).

    This is the full *border context* of the update: ``vp`` (the
    published anchor tree to descend), ``vp_root_pages``,
    ``recent_updates`` (ranges of every in-flight update between
    ``vp`` and ``version``) plus the update's own page extent
    ``(p0, p1, root_pages)`` — enough for the client to enumerate every
    border range BUILD_META will touch (``segment_tree.border_ranges``)
    and prefetch them in level-batched waves before the weave starts.
    """

    version: int
    offset: int
    prev_size: int
    new_size: int
    root_pages: int
    p0: int
    p1: int
    vp: Optional[int]                       # recently published snapshot
    vp_root_pages: int
    recent_updates: Tuple[Tuple[int, int, int], ...]  # (version, p0, p1), unpublished-at-assign
