"""Deployment facade: wire + version manager + DHT + providers in one box.

Mirrors the paper's §5 experimental deployments ("we deploy each the
version manager and the provider manager on two distinct dedicated
nodes, and we co-deploy a data provider and a metadata provider on the
other nodes").  Tests, benchmarks, the checkpoint layer and the data
pipeline all build one of these.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from repro_torch.core.blob import BlobClient
from repro_torch.core.cache import InvalidationSubscriber, PageCache
from repro_torch.core.dedup_index import DedupIndex
from repro_torch.core.dht import MetadataDHT
from repro_torch.core.provider import DataProvider, ProviderManager
from repro_torch.core.sim import Clock
from repro_torch.core.transport import EndpointDown, Wire
from repro_torch.core.version_manager import (
    VMGR_ENDPOINT,
    VersionManager,
    VersionUnpublished,
)
from repro_torch.store.file import FilePageStore
from repro_torch.store.memory import MemoryPageStore
from repro_torch.store.s3 import S3PageStore

# Default byte budget of the shared read-path page cache.  Sized so the
# paper-scale experiments (64 KiB pages, MB-scale hot sets) fit whole,
# while still exercising eviction in the space benchmarks; pass
# ``page_cache_bytes=0`` to disable caching entirely.
DEFAULT_PAGE_CACHE_BYTES = 64 * 1024 * 1024


class BlobSeerService:
    """One BlobSeer deployment (in-process, simulated wire)."""

    def __init__(
        self,
        n_providers: int = 4,
        n_meta_shards: int = 4,
        *,
        data_replication: int = 1,
        meta_replication: int = 1,
        placement: str = "ring",
        verify_digests: bool = False,
        wire: Optional[Wire] = None,
        wal_path: Optional[str] = None,
        spool_dir: Optional[str] = None,
        heartbeat_timeout: float = 5.0,
        io_workers: int = 0,
        clock: Optional[Clock] = None,
        page_cache_bytes: int = DEFAULT_PAGE_CACHE_BYTES,
        read_prefetch_pages: int = 0,
        dedup: bool = False,
        vm_replication: int = 0,
        vm_lease_ttl: float = 0.25,
        wal_fsync: str = "batch",
        n_cold_providers: int = 0,
        spool_fsync: str = "never",
    ) -> None:
        """``clock``: scheduling backend for every blocking point in the
        deployment (wall-clock threads by default; pass a
        ``repro.core.sim.Simulator`` for deterministic virtual time).
        Ignored when an explicit ``wire`` is supplied — the wire's
        clock wins, so a deployment never mixes time sources.

        ``page_cache_bytes``: byte budget of the shared read-path page
        cache (0 disables it).  ``read_prefetch_pages``: default
        sibling-page prefetch depth handed to every client this service
        creates (see :class:`~repro.core.blob.BlobClient`).

        ``dedup``: default for every client's write-burst dedup
        handshake.  The content-hash index itself is ALWAYS deployed
        (its counters report zero and its GC verbs self-disable while
        nothing was ever registered), so flipping the flag changes
        client behavior only — never the deployment topology.

        ``vm_replication``: follower replicas per version-manager
        lineage shard (0 = the single shared ``vmgr`` endpoint, the
        pre-HA behavior).  ``vm_lease_ttl``: leader lease duration —
        failover waits it out before promoting.  ``wal_fsync``: the
        manager WAL's fsync policy (``never``/``batch``/``always``).

        ``n_cold_providers``: S3-class cold-tier endpoints
        (``cold-NNNN``); they never take new-page placement, only
        lifecycle demotions (see :meth:`set_lifecycle` /
        ``core/durability.py``).  ``spool_fsync``: the page spool's
        fsync policy (``never``/``always``), mirroring ``wal_fsync``
        for the data plane when ``spool_dir`` is set."""
        if wire is not None:
            self.wire = wire
        elif clock is not None:
            self.wire = Wire(clock=clock)
        else:
            self.wire = Wire()
        self.clock = self.wire.clock
        self.vm = VersionManager(wire=self.wire, wal_path=wal_path,
                                 replication=vm_replication,
                                 lease_ttl=vm_lease_ttl,
                                 fsync_policy=wal_fsync)
        self.dht = MetadataDHT(self.wire, n_meta_shards, replication=meta_replication)
        self.page_cache = PageCache(page_cache_bytes, clock=self.clock)
        self.dedup_index = DedupIndex(self.wire)
        self.dedup = dedup
        self.pm = ProviderManager(
            self.wire,
            strategy=placement,
            replication=data_replication,
            heartbeat_timeout=heartbeat_timeout,
            page_cache=self.page_cache,
            dedup_index=self.dedup_index,
        )
        # GC/cache coherence: evict a retired version's pages at
        # retire-intent time (epoch bump), before any sweep delete.
        # Delivery is push-modelled: the retiring leader ships one
        # batched fire-and-forget invalidation event to the cache's
        # subscriber endpoint (see InvalidationSubscriber).
        self.cache_invalidation = InvalidationSubscriber(
            self.page_cache, self.wire)
        self.vm.add_gc_listener(self._on_retire_intent)
        self.read_prefetch_pages = read_prefetch_pages
        self.io_workers = io_workers
        self._spool_dir = spool_dir
        self._spool_fsync = spool_fsync
        self._verify = verify_digests
        # Per-blob lifecycle policy: blob_id -> demote-after age
        # (simulated seconds).  Pages older than the threshold are moved
        # to the cold tier by ``durability.lifecycle_round``; blobs with
        # a ``promote_reads`` threshold move cold pages back to the hot
        # tier once their read tally crosses it.
        self.lifecycles: Dict[str, float] = {}
        self.promote_reads: Dict[str, int] = {}
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()
        self._monitor_errors = 0   # retryable recovery failures (see rpc_report)
        self._monitor_fatal: Optional[BaseException] = None
        for i in range(n_providers):
            self.add_provider(f"prov-{i:04d}")
        for i in range(n_cold_providers):
            self.add_provider(f"cold-{i:04d}", tier="cold")

    # ------------------------------------------------------------- membership
    def add_provider(self, pid: str, tier: str = "hot") -> DataProvider:
        """A provider joins and registers with the provider manager.

        ``tier="cold"`` endpoints carry an S3-class object store (cheap
        durable capacity, per-request billing — see
        ``repro.store.s3``); they are excluded from new-page placement
        and filled only by lifecycle demotion.  Reads through them are
        fronted by the deployment's shared ``PageCache`` like any other
        endpoint, so only the first touch of a demoted page pays the
        cold path."""
        if tier == "cold":
            store: object = S3PageStore(bucket=pid)
        elif self._spool_dir:
            store = FilePageStore(f"{self._spool_dir}/{pid}",
                                  fsync=self._spool_fsync)
        else:
            store = MemoryPageStore()
        prov = DataProvider(pid=pid, wire=self.wire, store=store,
                            verify_digests=self._verify, tier=tier)
        self.pm.register(prov)
        return prov

    def join_provider(self, pid: str, tier: str = "hot"):
        """A provider joins the live ring: registered for new-page
        placement immediately, and the returned plan (run it with
        :meth:`run_migration`) transfers it exactly the already-stored
        pages the ring now assigns to it."""
        from repro_torch.core.membership import join_provider

        return join_provider(self, pid, tier=tier)

    def start_drain(self, pid: str):
        """Take a provider out of placement (it keeps serving reads)
        and return its transfer-out plan; call :meth:`finish_drain`
        once the plan has run to deregister it."""
        from repro_torch.core.membership import start_drain

        return start_drain(self, pid)

    def finish_drain(self, pid: str) -> int:
        """Straggler sweep + deregistration closing out a drain."""
        from repro_torch.core.membership import finish_drain

        return finish_drain(self, pid)

    def drain_provider(self, pid: str, *, budget_bytes: Optional[int] = None,
                       round_sleep: float = 0.0) -> Dict[str, int]:
        """Full provider drain: plan, budgeted transfer concurrent with
        client traffic, straggler sweep, deregistration — zero failed
        ops (see ``core/membership.py``)."""
        from repro_torch.core.membership import (
            DEFAULT_MIGRATION_BUDGET,
            drain_provider,
        )

        return drain_provider(
            self, pid, round_sleep=round_sleep,
            budget_bytes=(DEFAULT_MIGRATION_BUDGET if budget_bytes is None
                          else budget_bytes))

    def run_migration(self, plan, *, budget_bytes: Optional[int] = None,
                      round_sleep: float = 0.0) -> Dict[str, int]:
        """Drive a join/drain plan's budget-capped rounds."""
        from repro_torch.core.membership import (
            DEFAULT_MIGRATION_BUDGET,
            run_migration,
        )

        return run_migration(
            self, plan, round_sleep=round_sleep,
            budget_bytes=(DEFAULT_MIGRATION_BUDGET if budget_bytes is None
                          else budget_bytes))

    def add_meta_shard(self, shard_id: str,
                       budget_bytes: int = 1 << 20) -> None:
        """Grow the metadata DHT online: the shard joins the ring and
        its owed key ranges migrate over in budgeted rounds (ARES-style
        per-arc pointer flips — see ``core/dht.py``)."""
        self.dht.begin_join(shard_id)
        while not self.dht.migration_round(budget_bytes)["done"]:
            pass

    def drain_meta_shard(self, shard_id: str,
                         budget_bytes: int = 1 << 20) -> None:
        """Shrink the metadata DHT online: the shard's ranges transfer
        out arc by arc, then it deregisters empty."""
        self.dht.begin_drain(shard_id)
        while not self.dht.migration_round(budget_bytes)["done"]:
            pass

    def mitigate_flash_crowd(self, *, threshold: int = 32, extra: int = 1,
                             blob_id: Optional[str] = None):
        """One flash-crowd relief pass: widen every hot page's replica
        set onto its next ring owners (see ``core/membership.py``)."""
        from repro_torch.core.membership import mitigate_flash_crowd

        return mitigate_flash_crowd(self, threshold=threshold, extra=extra,
                                    blob_id=blob_id)

    def ring_report(self) -> Dict[str, object]:
        """Elastic-membership introspection: ring members on each
        plane, in-flight reconfiguration state, migration counters."""
        pm_ctr = self.pm.rpc_counters()
        return {
            "data_ring": sorted(self.pm.ring.nodes())
            if self.pm.ring is not None else [],
            "data_draining": sorted(self.pm._draining),
            "data_departed": sorted(self.pm._departed),
            "meta_ring": sorted(self.dht.ring.nodes()),
            "meta_reconfiguring": self.dht.reconfiguring,
            "migrated_pages": pm_ctr["migrated_pages"],
            "migrated_bytes": pm_ctr["migrated_bytes"],
            "migrated_payload_bytes": pm_ctr["migrated_payload_bytes"],
            "widened_pages": pm_ctr["widened_pages"],
            "promoted_pages": pm_ctr["promoted_pages"],
        }

    # ----------------------------------------------------- durability policy
    def set_blob_placement(self, blob_id: str, spec) -> None:
        """Select this blob's placement for future pages: ``"rep:N"``
        or ``"ec:K+M"`` (see ``repro.core.placement``)."""
        self.pm.set_blob_policy(blob_id, spec)

    def set_lifecycle(self, blob_id: str, demote_after: float,
                      promote_reads: Optional[int] = None) -> None:
        """Demote this blob's pages to the cold tier once they are
        ``demote_after`` simulated seconds old (applied by
        ``durability.lifecycle_round``).  ``promote_reads`` adds the
        reverse transition: a cold page read at least that many times
        since the last lifecycle pass moves back to the hot tier."""
        self.lifecycles[blob_id] = float(demote_after)
        if promote_reads is not None:
            self.promote_reads[blob_id] = int(promote_reads)

    def scrub(self, budget_bytes: Optional[int] = None,
              peer: str = "scrubber") -> Dict[str, int]:
        """One scrub/repair round (facade over
        :func:`repro.core.durability.scrub_round`)."""
        from repro_torch.core.durability import scrub_round

        if budget_bytes is None:
            return scrub_round(self, peer=peer)
        return scrub_round(self, budget_bytes=budget_bytes, peer=peer)

    def client(self, name: Optional[str] = None,
               prefetch_pages: Optional[int] = None) -> BlobClient:
        """A new client process.  ``prefetch_pages`` overrides the
        deployment's ``read_prefetch_pages`` default for this client.
        The service keeps no reference to it — clients (and their node
        caches) die with their owners; their metadata cache hits
        survive in the deployment counter ``dht_get_keys_cached``."""
        return BlobClient(
            self.vm, self.dht, self.pm, self.wire, name=name,
            io_workers=self.io_workers,
            prefetch_pages=(self.read_prefetch_pages
                            if prefetch_pages is None else prefetch_pages),
            dedup_index=self.dedup_index,
            dedup=self.dedup,
        )

    def _on_retire_intent(self, blob_id, versions, epoch, page_ids) -> None:
        """gc_epoch listener: drop a retired version's pages from the
        shared page cache the instant the intent lands.

        Deliberately conservative: a retired version's pd may include
        pages a kept snapshot still shares (the sweep defers those) —
        they are evicted anyway and cost one refetch if re-read.  The
        coherence invariant itself is carried by the second hook
        (``ProviderManager.delete_pages`` invalidates before any delete
        RPC); this one closes the intent-to-sweep window early and
        keeps the cache from holding data of versions that already
        answer ``RetiredVersion``.  Delivery goes through the
        wire-accounted push subscriber (one batched fire-and-forget
        invalidation event per intent — see
        :class:`~repro.core.cache.InvalidationSubscriber`)."""
        self.cache_invalidation(blob_id, versions, epoch, page_ids)

    # -------------------------------------------------------- failure injection
    def kill_provider(self, pid: str) -> None:
        """Down an endpoint (failure injection): every RPC to it raises
        :class:`~repro.core.transport.EndpointDown` until revived."""
        self.wire.set_down(pid, True)

    def revive_provider(self, pid: str) -> None:
        """Bring a downed endpoint back (and refresh its heartbeat so
        the next sweep does not immediately re-mark it dead)."""
        self.wire.set_down(pid, False)
        self.pm.get(pid).heartbeat()

    def make_straggler(self, pid: str, factor: float) -> None:
        """Make an endpoint ``factor``x slower on the simulated wire
        (replica racing/balancing then naturally deprioritizes it)."""
        self.wire.set_straggler(pid, factor)

    def vm_leader_endpoint(self, blob_id: str) -> str:
        """The version-manager endpoint currently serving this blob's
        lineage (``vmgr`` with replication off)."""
        return self.vm.leader_endpoint(blob_id)

    def kill_vm_leader(self, blob_id: str) -> str:
        """Down the CURRENT leader endpoint of the blob's lineage shard
        (failure injection for the HA control plane).  The next verb on
        the lineage waits out the lease and promotes a follower; other
        lineages are untouched.  Returns the endpoint killed."""
        ep = self.vm.leader_endpoint(blob_id)
        if ep == VMGR_ENDPOINT:
            raise RuntimeError(
                "vm_replication=0: no per-lineage leader to kill "
                "(build the service with vm_replication >= 1)")
        self.wire.set_down(ep, True)
        return ep

    # ---------------------------------------------------- background maintenance
    #: errors the recovery loop may safely retry on the next sweep: a
    #: downed endpoint, a blocking-verb timeout, or a version whose
    #: assignment raced retirement/recovery.  Anything else is a bug —
    #: retrying it forever would only hide it.
    MONITOR_RETRYABLE = (EndpointDown, TimeoutError, VersionUnpublished)

    def start_monitor(self, interval: float = 0.5, stall_timeout: float = 5.0) -> None:
        """Heartbeat sweep + stalled-writer recovery loop (beyond paper).

        Retryable failures (:attr:`MONITOR_RETRYABLE`) are counted in
        ``monitor_errors`` (see ``rpc_report``) and retried next sweep.
        An unexpected exception also counts, then stops the loop and is
        re-raised by the next :meth:`stop_monitor` — a permanently
        failing rebuild can no longer retry silently forever."""
        if self.clock.is_virtual:
            raise RuntimeError(
                "start_monitor spawns a real thread; under a virtual clock "
                "spawn a simulated maintenance task instead "
                "(see core/scenarios.py)"
            )

        def loop() -> None:
            agent = self.client("recovery-agent")
            while not self._monitor_stop.wait(interval):
                self.pm.check_heartbeats()
                for blob_id, rec in self.vm.find_stalled(stall_timeout):
                    try:
                        agent.rebuild_metadata(blob_id, rec.version)
                    except self.MONITOR_RETRYABLE:
                        self._monitor_errors += 1
                    except Exception as exc:
                        self._monitor_errors += 1
                        self._monitor_fatal = exc
                        return

        self._monitor = threading.Thread(target=loop, daemon=True)
        self._monitor.start()

    def stop_monitor(self) -> None:
        """Stop the background maintenance thread started by
        :meth:`start_monitor` (joins it; safe to call when stopped).
        Re-raises the unexpected exception that killed the loop, if
        any — the deferred surfacing point for monitor bugs."""
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
            self._monitor = None
        self._monitor_stop.clear()
        if self._monitor_fatal is not None:
            exc = self._monitor_fatal
            self._monitor_fatal = None
            raise exc

    def recover_stalled(self, stall_timeout: float = 0.0) -> int:
        """One-shot recovery sweep; returns number of updates recovered."""
        agent = self.client("recovery-agent")
        n = 0
        for blob_id, rec in self.vm.find_stalled(stall_timeout):
            agent.rebuild_metadata(blob_id, rec.version)
            n += 1
        return n

    # ------------------------------------------------------- full restart
    @classmethod
    def restore(
        cls,
        spool_dir: str,
        wal_path: str,
        n_providers: int,
        n_meta_shards: int = 4,
        resweep: bool = True,
        **kwargs,
    ) -> "BlobSeerService":
        """Cold-restart a deployment from durable state.

        Pages come back from the provider spool directories; the version
        manager replays its WAL; the (volatile) metadata DHT is rebuilt
        by replaying BUILD_META for every completed update in version
        order — possible because page descriptors are journaled at
        version-assignment time (see version_manager.assign_version).

        ``resweep=False`` skips the retirement re-apply pass (callers
        that want to schedule ``gc.resweep_after_restore`` themselves,
        e.g. after reviving providers that were down at restart).
        """
        svc = cls(
            n_providers=n_providers, n_meta_shards=n_meta_shards,
            spool_dir=spool_dir, **kwargs,
        )
        # recover with the same HA/durability config __init__ resolved
        # (vm_replication / vm_lease_ttl / wal_fsync kwargs): the
        # recovered manager rebuilds each lineage's replica group and
        # bulk-streams the journal to the fresh followers
        svc.vm = VersionManager.recover_from_wal(
            wal_path, wire=svc.wire,
            replication=svc.vm._replication,
            lease_ttl=svc.vm._lease_ttl,
            fsync_policy=svc.vm._fsync_policy,
        )
        # the recovered manager replaces the one __init__ subscribed to;
        # re-attach the cache-eviction hook so post-restore GC rounds
        # keep the page cache coherent
        svc.vm.add_gc_listener(svc._on_retire_intent)
        agent = svc.client("rebuild-agent")
        for blob_id in svc.vm.known_blobs():
            base, last = svc.vm.version_bounds(blob_id)
            for v in range(base + 1, last + 1):
                try:
                    rec = svc.vm.update_log(blob_id, v)
                except VersionUnpublished:
                    continue  # never assigned; anything else fails loudly
                if not rec.complete:
                    continue
                info = svc.vm.assign_info_for_recovery(blob_id, v)
                # replay strictly in order: border nodes resolve against
                # the just-rebuilt tree of v-1
                info = type(info)(
                    version=info.version, offset=info.offset,
                    prev_size=info.prev_size, new_size=info.new_size,
                    root_pages=info.root_pages, p0=info.p0, p1=info.p1,
                    vp=v - 1 if v > 1 else None,
                    vp_root_pages=(svc.vm.update_log(blob_id, v - 1).root_pages
                                   if v > 1 else 0),
                    recent_updates=(),
                )
                agent._build_and_complete(blob_id, info, rec.pd)
        # Re-apply retirement: the rebuild above resurrects retired
        # versions' metadata (snapshot v's border chaining needs v-1's
        # tree), so the WAL's retire records are re-enforced — swept
        # versions stay typed-unreadable and their garbage is deleted
        # again through the wire.
        if resweep:
            from repro_torch.core.gc import resweep_after_restore

            resweep_after_restore(svc)
        return svc

    # -------------------------------------------------------------- accounting
    def rpc_report(self) -> Dict[str, int]:
        """Per-operation RPC/round-trip counters for the whole deployment.

        ``wire_round_trips`` counts every RPC issued on the wire (a
        batched transfer counts once).  The ``dht_*`` entries break the
        metadata plane down: ``dht_get_keys`` is what a per-node read
        path would have paid in round trips, ``dht_get_rounds`` is the
        number of batched latency waves actually paid, and
        ``dht_get_shard_rpcs`` the per-shard requests those waves fanned
        out into.  ``provider_read_rounds``/``provider_read_pages`` are
        the data-plane analogue, and
        ``provider_write_rounds``/``provider_write_pages`` the
        write-side mirror (page-replica stores vs batched per-endpoint
        store round trips).

        ``vm_*`` exposes the version-manager control plane:
        ``vm_ops`` logical verbs, ``vm_round_trips`` control RPCs
        actually paid (a batched ``assign_versions_many`` /
        ``metadata_complete_many`` counts once — ``vm_ops /
        vm_round_trips`` is the write plane's amortization factor),
        ``vm_batched_ops`` the verbs that rode batches, plus per-verb
        batch counts.

        Cache-hit vs RPC accounting: requests served by the read-path
        caches never count as RPCs.  ``page_cache_*`` exposes the shared
        page cache's counters; ``node_cache_hits``/``_hit_bytes`` are
        the deployment-wide metadata-cache hits every client's
        :class:`~repro.core.cache.NodeCache` reports into
        ``dht_get_keys_cached`` (deterministic and monotone — the
        service deliberately keeps no client registry); and
        ``wire_local_hit_bytes`` is the byte volume page-cache hits
        kept off the wire (compare with ``storage_report()['wire_bytes']``).

        ``dedup_*`` exposes the content-hash index's handshake:
        ``dedup_lookup_rounds`` batched digest probes (≤1 per write
        burst), ``dedup_hits``/``dedup_hit_bytes`` pages (and payload
        bytes) that matched and never shipped, ``dedup_registered`` new
        entries, ``dedup_released``/``dedup_dropped`` the GC-side
        refcount traffic.

        Every counter family lives in one registry (see
        ``_counter_families``), so ``rpc_report`` and
        ``reset_rpc_counters`` can never drift apart — a family present
        in one is present in the other, which ``tests/test_dedup.py``
        asserts key-for-key.
        """
        report: Dict[str, int] = {}
        for prefix, get, _reset in self._counter_families():
            for k, v in get().items():
                report[f"{prefix}{k}"] = v
        # Derived entries (no reset of their own; zeroed via dht_*):
        cached_keys = report["dht_get_keys_cached"]
        report["node_cache_hits"] = cached_keys
        report["node_cache_hit_bytes"] = cached_keys * self.dht.node_nbytes
        return report

    def _counter_families(self):
        """The single registry of every RPC/cache counter family:
        ``(report_prefix, get_counters, reset_counters)`` per family.
        Late-bound through ``self`` so :meth:`restore`'s version-manager
        replacement is picked up automatically."""
        return [
            ("wire_", lambda: {
                "round_trips": self.wire.total_round_trips(),
                "local_hits": self.wire.total_local_hits(),
                "local_hit_bytes": self.wire.total_local_hit_bytes(),
            }, self.wire.reset_accounting),
            ("dht_", lambda: self.dht.rpc_counters(),
             lambda: self.dht.reset_rpc_counters()),
            ("vm_", lambda: self.vm.rpc_counters(),
             lambda: self.vm.reset_rpc_counters()),
            ("provider_", lambda: self.pm.rpc_counters(),
             lambda: self.pm.reset_counters()),
            ("page_cache_", lambda: self.page_cache.counters(),
             lambda: self.page_cache.reset_counters()),
            ("dedup_", lambda: self.dedup_index.rpc_counters(),
             lambda: self.dedup_index.reset_rpc_counters()),
            ("watch_", lambda: self.vm.watch_counters(),
             lambda: self.vm.reset_watch_counters()),
            ("cache_push_", lambda: self.cache_invalidation.counters(),
             lambda: self.cache_invalidation.reset_counters()),
            ("monitor_", lambda: {"errors": self._monitor_errors},
             lambda: setattr(self, "_monitor_errors", 0)),
        ]

    def reset_rpc_counters(self) -> None:
        """Zero every RPC/cache counter (cache *contents* are kept —
        a counter reset brackets a measurement, it must not change the
        wire schedule).  Per-client ``NodeCache`` counters are the
        clients' own; the deployment-level view they feed
        (``dht_get_keys_cached``) is reset here.  Iterates the same
        registry ``rpc_report`` reads, so no family can be reported but
        not reset (or vice versa)."""
        for _prefix, _get, reset in self._counter_families():
            reset()

    def storage_report(self) -> Dict[str, object]:
        """Deployment-wide space accounting: provider count, stored page
        replicas and bytes, metadata keys, and total bytes that crossed
        the wire (cache hits excluded — see ``rpc_report``)."""
        provs = self.pm.all_providers()
        return {
            "providers": len(provs),
            "pages": sum(p.page_count() for p in provs),
            "page_bytes": sum(p.stored_bytes() for p in provs),
            "metadata_nodes": self.dht.total_keys(),
            "wire_bytes": self.wire.total_bytes(),
        }
