"""Blob client: the paper's user-facing primitives.

CREATE / READ (Alg 1) / WRITE (Alg 2) / APPEND / GET_RECENT / GET_SIZE /
SYNC / BRANCH, against a deployment of {version manager, metadata DHT,
provider manager}.

Concurrency properties (paper §4.3) preserved:

* data pages are written with **no synchronization** between clients —
  every update creates new pages;
* metadata is built without locking: border nodes of concurrent
  unpublished updates are resolved from the version-manager-supplied
  registry info, everything else by descending a published tree;
* the only serialization points are the version-manager critical
  section (short, and per *lineage* — unrelated blobs never contend)
  and same-endpoint contention.

The write path is pipelined (see docs/write-path.md): page stores go
out as per-endpoint batches that overlap assignment, border prefetch
and metadata puts; the border set is prefetched as one level-batched
cohort; bursts (:meth:`BlobClient.append_many` /
:meth:`BlobClient.write_many`) amortize the version-manager round
trips through the batched writer verbs.

Unaligned ranges (the paper's "slightly more complex" §3 case) are fully
supported: a boundary page whose range is partially overwritten becomes
a *new* page whose content merges the previous snapshot's bytes with the
update's bytes.  Only this case ever waits on another writer (the
previous version's metadata must be complete to read the old content).
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import segment_tree as st
from repro_torch.core.cache import NodeCache
from repro_torch.core.dedup_index import DedupIndex
from repro_torch.core.dht import MetadataDHT
from repro_torch.core.pages import UpdateExtent, fresh_page_id, pages_spanned
from repro_torch.core.provider import ProviderManager
from repro_torch.core.transport import Wire
from repro_torch.core.version_manager import (
    AssignInfo,
    VersionManager,
    owner_fn_for_lineage,
)
from repro_torch.kernels.hostdigest import host_page_digest

# Backwards-compatible alias: the node cache grew up and moved to
# repro.core.cache (shared with the page cache and the accounting
# layer); existing imports keep working.
_NodeCache = NodeCache

_client_ids = itertools.count()
_client_ids_lock = threading.Lock()


class ReadError(RuntimeError):
    """A READ failed validation: unpublished version or out-of-bounds
    range.  (Retired snapshots raise the typed
    :class:`~repro.core.version_manager.RetiredVersion` instead.)"""


class WatchInbox:
    """A client's notification inbox: the delivery end of the
    subscription plane (see docs/watch.md).

    The version manager pushes coalesced publication events here as
    fire-and-forget wire batches addressed to ``self.endpoint``; the
    inbox queues them per watch lease and wakes blocked
    :meth:`wait_for` callers.  Under a virtual clock an event becomes
    *visible* only at its wire arrival instant (``ready_at``), so the
    push plane never beats the wire.

    The inbox also enforces the delivery contract locally: per lease it
    keeps a monotone watermark and drops anything at or below it — a
    failover re-flush (the promoted leader re-covering the un-journaled
    tail of deliveries) is deduplicated here, which is what makes
    "no gap" and "no duplicate" compose.  One inbox (one wire endpoint)
    can carry any number of leases: notify cost scales with endpoints,
    not leases.
    """

    def __init__(self, wire: Wire, name: str) -> None:
        self.wire = wire
        self.endpoint = f"inbox-{name}"
        self._clock = wire.clock
        self._cond = self._clock.condition()
        # per-lease pending events, each (version, ready_at); both
        # components are monotone within a queue
        self._queues: Dict[str, List[Tuple[int, float]]] = {}
        self._last: Dict[str, int] = {}      # newest version ever accepted
        self._consumed: Dict[str, int] = {}  # newest version drained by poll
        self._closed: set = set()
        self.delivered = 0            # versions accepted
        self.duplicates_dropped = 0   # re-deliveries the watermark caught

    def track(self, watch_id: str, from_version: int) -> None:
        """Open local state for a lease.  Catch-up deliveries may land
        *before* this (the manager flushes inside ``watch()``), so the
        watermark only ever moves up."""
        with self._cond:
            self._queues.setdefault(watch_id, [])
            self._last[watch_id] = max(self._last.get(watch_id, -1),
                                       from_version)
            self._consumed.setdefault(watch_id, from_version)
            self._closed.discard(watch_id)

    def forget(self, watch_id: str) -> None:
        """Drop a lease's queue and refuse its future deliveries
        (client-side half of ``unwatch``)."""
        with self._cond:
            self._queues.pop(watch_id, None)
            self._closed.add(watch_id)
            self._cond.notify_all()

    def deliver(self, entries: Sequence[Tuple[str, str, Tuple[int, ...]]],
                ready_at: float = 0.0) -> None:
        """Receive one notify batch: ``(watch_id, blob_id, versions)``
        entries.  Called by the version manager (possibly under its
        shard lock — this lock is leaf-level and never blocks)."""
        if not self._clock.is_virtual:
            ready_at = 0.0
        with self._cond:
            for wid, _blob_id, versions in entries:
                if wid in self._closed:
                    continue
                q = self._queues.setdefault(wid, [])
                last = self._last.get(wid, -1)
                for v in versions:
                    if v <= last:
                        self.duplicates_dropped += 1
                        continue
                    q.append((v, ready_at))
                    last = v
                    self.delivered += 1
                self._last[wid] = last
            self._cond.notify_all()

    def poll(self, watch_id: str) -> List[int]:
        """Drain and return the lease's arrived versions (ascending).
        Events still in flight on the wire (``ready_at`` in the future)
        stay queued."""
        now = self._clock.now()
        with self._cond:
            q = self._queues.get(watch_id)
            if not q:
                return []
            i = 0
            while i < len(q) and q[i][1] <= now:
                i += 1
            out = [v for v, _ in q[:i]]
            del q[:i]
            if out:
                self._consumed[watch_id] = max(
                    self._consumed.get(watch_id, -1), out[-1])
            return out

    def wait_for(self, watch_id: str, version: int,
                 timeout: Optional[float] = None) -> None:
        """Block (through the deployment clock) until a version
        ``>= version`` has arrived on the lease — delivered by push, or
        already drained by an earlier :meth:`poll`.  Raises
        ``TimeoutError`` on the deadline."""
        deadline = (None if timeout is None
                    else self._clock.now() + timeout)
        with self._cond:
            while True:
                now = self._clock.now()
                if self._consumed.get(watch_id, -1) >= version:
                    return
                q = self._queues.get(watch_id, ())
                arrival = None
                for v, at in q:
                    if v >= version:
                        arrival = at
                        break
                if arrival is not None and arrival <= now:
                    return
                # next wake: the event's wire arrival or the deadline
                wake = arrival
                if deadline is not None and (wake is None or deadline < wake):
                    wake = deadline
                if wake is not None and wake <= now:
                    raise TimeoutError(
                        f"wait_for {watch_id} v{version}")
                self._cond.wait(None if wake is None else wake - now)


class BlobClient:
    """One client process (paper §3.1: 'Clients may create blobs and
    read, write and append data to them')."""

    def __init__(
        self,
        vm: VersionManager,
        dht: MetadataDHT,
        pm: ProviderManager,
        wire: Wire,
        name: Optional[str] = None,
        io_workers: int = 0,
        prefetch_pages: int = 0,
        dedup_index: Optional["DedupIndex"] = None,
        dedup: bool = False,
    ) -> None:
        """``prefetch_pages``: how many sibling pages past a read's range
        to pull into the shared page cache on the same batched fetch
        (0 = off).  Sequential readers hide the next read's data-plane
        latency this way; the descriptors come from widening the same
        segment-tree descent the read already pays for.

        ``io_workers`` is accepted for backward compatibility and is a
        no-op: the thread-pool fan-out it once enabled is subsumed by
        the batched write plane (``ProviderManager.store_pages`` groups
        all page stores per endpoint into single round trips and
        pipelines them under a virtual clock), which models the paper's
        'in parallel' loops without real threads.

        ``dedup_index``: the deployment's content-hash page index (see
        :mod:`repro.core.dedup_index`); ``dedup`` sets this client's
        default for the batched write verbs' two-phase handshake (each
        call may override with its own ``dedup=`` keyword)."""
        self.vm = vm
        self.dht = NodeCache(dht)
        self.pm = pm
        self.wire = wire
        self.prefetch_pages = max(0, prefetch_pages)
        self.dedup_index = dedup_index
        self.dedup_default = bool(dedup) and dedup_index is not None
        if name is None:
            with _client_ids_lock:
                name = f"client-{next(_client_ids):04d}"
        self.name = name
        del io_workers  # no-op, see docstring
        self._lineage_cache: Dict[str, Tuple[Tuple[str, int], ...]] = {}
        # per-client request sequence: idempotency keys for assign verbs
        # (a re-driven request after a VM leader failover returns its
        # already-journaled version instead of double-assigning)
        self._req_seq = itertools.count(1)
        # notification inbox, created lazily on first watch (one wire
        # endpoint per client, any number of leases on it)
        self._watch_inbox: Optional[WatchInbox] = None

    def _assign_key(self) -> str:
        return f"{self.name}/{next(self._req_seq)}"

    # ------------------------------------------------------------- small utils
    def _await(self, barrier: float) -> None:
        """Sleep (in virtual time) to a pipelined store barrier.

        Fire-and-forget page stores / metadata puts return their
        completion instants; the writer must not signal
        ``metadata_complete`` before the latest of them — a snapshot
        may never publish before its bytes have arrived.  No-op on the
        wall backend (those transfers block inline).
        """
        clock = self.wire.clock
        if barrier > 0.0 and clock.is_virtual and barrier > clock.now():
            clock.sleep_until(barrier)

    def _owner_fn(self, blob_id: str):
        chain = self._lineage_cache.get(blob_id)
        if chain is None:
            chain = self.vm.lineage(blob_id)
            self._lineage_cache[blob_id] = chain
        return owner_fn_for_lineage(chain)

    # ---------------------------------------------------------------- CREATE
    def create(self, psize: int = 64 * 1024) -> str:
        """CREATE: a new empty blob (snapshot 0, size 0); returns its id."""
        return self.vm.create(psize, client=self.name)

    # ------------------------------------------------------------------ READ
    def read(self, blob_id: str, version: int, offset: int, size: int) -> bytes:
        """Algorithm 1. Fails if ``version`` unpublished or range OOB;
        raises :class:`~repro.core.version_manager.RetiredVersion` for
        snapshots retired by GC.

        The read holds a version-manager *read lease* for its duration:
        GC's sweep barrier drains leases on versions being retired
        before deleting anything, so an in-flight read never races its
        pages away.  Reads of kept versions are never blocked.
        """
        if not self.vm.is_published(blob_id, version):
            raise ReadError(f"{blob_id} v{version} not published")
        total, root_pages = self.vm.enter_read(blob_id, version, client=self.name)
        try:
            if offset < 0 or size < 0 or offset + size > total:
                raise ReadError(
                    f"range ({offset},{size}) out of bounds for v{version} (size {total})"
                )
            if size == 0:
                return b""
            psize = self.vm.psize_of(blob_id)
            p0, p1 = pages_spanned(offset, size, psize)
            # Sibling-page prefetch: widen the descent past p1 so the
            # NEXT sequential read's pages ride this read's batched
            # waves into the shared page cache.  The extra leaves cost
            # keys on the same level-synchronous rounds, not extra
            # latency waves.  Pointless without a cache to land in —
            # the widening is skipped then (no metadata-plane waste).
            p1_want = p1
            pc = self.pm.page_cache
            if self.prefetch_pages > 0 and pc is not None and pc.enabled:
                p1_want = min(p1 + self.prefetch_pages,
                              -(-total // psize))
            pd = st.read_meta(
                self.dht, self._owner_fn(blob_id), version,
                root_pages, p0, p1_want,
                peer=self.name,
            )
            return self._fetch_ranges(pd, offset, size, psize,
                                      prefetch_beyond=p1_want > p1)
        finally:
            self.vm.exit_read(blob_id, version, client=self.name)

    def _fetch_ranges(
        self,
        pd: Sequence[st.PageDescriptor],
        offset: int,
        size: int,
        psize: int,
        prefetch_beyond: bool = False,
    ) -> bytes:
        """Fetch the bytes of ``[offset, offset+size)`` from page replicas.

        All page reads go out as one ``fetch_pages`` call, which groups
        them per provider endpoint (one batched round trip each) instead
        of paying per-page latency — the data-plane mirror of the
        level-batched metadata descent.

        When the shared page cache is enabled, requests are normalized
        to *whole pages* and sliced locally, so the cache is
        page-granular: overlapping sub-range reads of one page share a
        single entry (no budget double-charging), and a prefetched page
        serves any later read of it — aligned or not.  The standard
        page-cache tradeoff applies: a small cold read moves its whole
        page over the wire once (psize bytes) to make every later read
        of that page free — workloads of tiny *non-repeating* random
        reads should run with ``page_cache_bytes=0``, which restores
        exact sub-range fetches (no extra bytes on the wire).
        With ``prefetch_beyond``, descriptors past the requested range
        (widened descent) become best-effort whole-page prefetches.
        """
        pc = self.pm.page_cache
        whole_pages = prefetch_beyond or (pc is not None and pc.enabled)
        buf = bytearray(size)
        requests: List[Tuple[Sequence[str], str, int, int]] = []
        prefetch: List[Tuple[Sequence[str], str, int, int]] = []
        spans: List[Tuple[int, int, int]] = []  # (lo, hi, chunk offset)
        for d in pd:
            page_start = d.page_index * psize
            lo = max(offset, page_start)
            hi = min(offset + size, page_start + d.length)
            if hi <= lo:
                if prefetch_beyond:
                    prefetch.append((d.providers, d.page_id, 0, d.length))
                continue
            if whole_pages:
                requests.append((d.providers, d.page_id, 0, d.length))
                spans.append((lo, hi, lo - page_start))
            else:
                requests.append((d.providers, d.page_id,
                                 lo - page_start, hi - lo))
                spans.append((lo, hi, 0))
        chunks = self.pm.fetch_pages(requests, peer=self.name,
                                     prefetch=prefetch)
        for (lo, hi, skip), chunk in zip(spans, chunks):
            buf[lo - offset : hi - offset] = chunk[skip : skip + (hi - lo)]
        return bytes(buf)

    # ------------------------------------------------------------- WRITE/APPEND
    def write(self, blob_id: str, buf: bytes, offset: int) -> int:
        """Algorithm 2 (+ unaligned boundary handling). Returns vw."""
        return self._update(blob_id, buf, offset=offset)

    def append(self, blob_id: str, buf: bytes) -> int:
        """APPEND: offset is assigned by the version manager."""
        return self._update(blob_id, buf, offset=None)

    def _update(self, blob_id: str, buf: bytes, offset: Optional[int]) -> int:
        """The four-phase pipelined write path (see docs/write-path.md).

        Phase 1 stores every fully covered page *before* version
        assignment (no synchronization; under a virtual clock the
        per-endpoint store batches go out fire-and-forget, so they
        overlap everything that follows).  Phase 2 is the version
        manager's short critical section.  Phase 3 stores boundary
        pages (the only phase that can wait on another writer).  Phase
        4 prefetches the whole border set in one level-batched cohort,
        weaves the metadata (Algorithm 4), then — after sleeping to the
        store barrier — publishes.
        """
        if len(buf) == 0:
            raise ValueError("empty update")
        psize = self.vm.psize_of(blob_id)
        size = len(buf)
        stored: Dict[int, Tuple[str, Tuple[str, ...], int]] = {}  # rel_page -> (pid, provs, length)

        # -- phase 1: store what we can BEFORE version assignment (no sync) --
        # WRITE knows its offset: every page fully covered by the range can
        # go out now.  APPEND optimistically assumes a page-aligned offset
        # (always true in the paper); if assignment reveals an unaligned
        # offset we re-stripe below.
        presumed_offset = offset if offset is not None else 0  # append: relative
        p0_pre, _ = pages_spanned(presumed_offset, size, psize)
        barrier = self._store_full_pages(buf, presumed_offset, psize,
                                         p0_pre, stored, blob_id=blob_id)
        pd_wire = tuple(
            (pid, rel, provs, ln) for rel, (pid, provs, ln) in sorted(stored.items())
        )

        # -- phase 2: version assignment (the only global serialization) --
        info = self.vm.assign_version(
            blob_id, offset, size, client=self.name, pd=pd_wire,
            key=self._assign_key(),
        )
        vw, off = info.version, info.offset

        if offset is None and off % psize != 0:
            # Optimistic append striping assumed an aligned offset (always
            # true in the paper's aligned world); restripe at the real one.
            # The optimistically stored pages become orphans (reclaimed by
            # the GC inventory pass).
            stored.clear()
            barrier = max(barrier, self._store_full_pages(
                buf, off, psize, info.p0, stored, blob_id=blob_id))

        # -- phase 3: boundary pages (merge with snapshot vw-1 content) --
        stored_boundary, b3 = self._store_boundary_pages(
            blob_id, buf, off, size, psize, info, stored
        )
        barrier = max(barrier, b3)

        pd_final = tuple(
            (pid, rel, provs, ln) for rel, (pid, provs, ln) in sorted(stored.items())
        )
        if stored_boundary or pd_final != pd_wire:
            self.vm.register_pd(blob_id, vw, pd_final, client=self.name)

        # -- phase 4: weave metadata (Algorithm 4), then publish --
        self._build_and_complete(blob_id, info, pd_final, store_barrier=barrier)
        return vw

    # ------------------------------------------------------- batched updates
    def append_many(self, blob_id: str, bufs: Sequence[bytes],
                    *,
                    digests: Optional[Sequence[Sequence[Tuple[int, int]]]] = None,
                    dedup: Optional[bool] = None) -> List[int]:
        """APPEND a burst of buffers in one batched write-plane pass.

        Semantically identical to ``[self.append(blob_id, b) for b in
        bufs]`` — one snapshot version per buffer, published in order —
        but the whole burst pays ONE ``assign_versions_many`` and ONE
        ``metadata_complete_many`` control round trip, and every
        buffer's page stores share the same per-endpoint batched waves.
        Intra-burst boundary merges (unaligned appends) are resolved
        from the burst's own buffers locally; only the first buffer can
        ever wait on a pre-burst writer.  Returns the assigned versions
        in buffer order.

        ``dedup``/``digests``: see :meth:`write_many`.
        """
        return self._update_many(blob_id, [(buf, None) for buf in bufs],
                                 digests=digests, dedup=dedup)

    def write_many(self, blob_id: str,
                   items: Sequence[Tuple[bytes, int]],
                   *,
                   digests: Optional[Sequence[Sequence[Tuple[int, int]]]] = None,
                   dedup: Optional[bool] = None) -> List[int]:
        """WRITE a batch of ``(buf, offset)`` updates in one pass.

        One snapshot version per item, assigned and published in list
        order, with the version-manager round trips amortized across
        the batch exactly like :meth:`append_many` (the checkpoint
        layer uses this for its dirty-page runs).  Offsets are
        validated against the batch's own running size — item *k* may
        extend the blob and item *k+1* may write into the extension.

        ``dedup`` (default: the client's ``dedup`` constructor flag)
        enables the two-phase dedup handshake on the burst's full
        pages: digests go to the content-hash index in one batched
        lookup, matched pages reuse the indexed descriptor and ship no
        bytes.  ``dedup=False`` is byte-for-byte the plain write plane.
        ``digests`` optionally supplies the fingerprints — item *k*'s
        entry lists ``(d0, d1)`` per *fully covered* page in page
        order, as computed by the ``page_digest`` kernel (the
        checkpoint layer passes its delta-scan digests through so
        nothing is hashed twice); without it the host twin
        ``hostdigest.host_page_digest`` fills in.
        """
        return self._update_many(blob_id, [(buf, off) for buf, off in items],
                                 digests=digests, dedup=dedup)

    def _update_many(self, blob_id: str,
                     items: Sequence[Tuple[bytes, Optional[int]]],
                     digests: Optional[Sequence[Sequence[Tuple[int, int]]]] = None,
                     dedup: Optional[bool] = None) -> List[int]:
        items = list(items)
        if not items:
            return []
        if any(len(buf) == 0 for buf, _off in items):
            raise ValueError("empty update")
        is_append = items[0][1] is None
        if any((off is None) != is_append for _buf, off in items):
            raise ValueError("mixed append/write batch (split it)")
        psize = self.vm.psize_of(blob_id)
        use_dedup = (self.dedup_default if dedup is None else bool(dedup)) \
            and self.dedup_index is not None
        if digests is not None and len(digests) != len(items):
            raise ValueError("digests must align with items")
        # Page-ids this burst acquired from / registered with the dedup
        # index; released if a re-stripe abandons the optimistic pages.
        acquired: List[str] = []
        stored: List[Dict[int, Tuple[str, Tuple[str, ...], int]]] = [
            {} for _ in items
        ]

        # -- phase 1: optimistic pre-store of every fully covered page --
        # Appends presume a page-aligned burst base (cumulative offsets
        # from 0); writes know their offsets exactly.
        cursor = 0
        plans: List[Tuple[int, List[Tuple[int, bytes]]]] = []
        for idx, (buf, off) in enumerate(items):
            p_off = cursor if is_append else off
            if is_append:
                cursor += len(buf)
            p0_pre, _ = pages_spanned(p_off, len(buf), psize)
            plans.append((idx, self._plan_full_pages(buf, p_off, psize, p0_pre)))
        barrier = self._store_planned(
            plans, stored, psize=psize, digests=digests,
            use_dedup=use_dedup, acquired=acquired, blob_id=blob_id)
        pd_wire = [
            tuple((pid, rel, provs, ln)
                  for rel, (pid, provs, ln) in sorted(s.items()))
            for s in stored
        ]

        # -- phase 2: ONE batched version assignment for the burst --
        infos = self.vm.assign_versions_many(
            [(blob_id, None if is_append else off, len(buf), pd_wire[idx])
             for idx, (buf, off) in enumerate(items)],
            client=self.name,
            keys=[self._assign_key() for _ in items],
        )

        if is_append and infos[0].offset % psize != 0:
            # Phase-2 re-stripe: the burst's presumed page-aligned base
            # was wrong — restripe every buffer at its real offset (the
            # page *phase* of all presumed offsets was off by the same
            # amount, so the whole burst restripes together).  Abandoned
            # optimistic pages become orphans (reclaimed by the GC
            # inventory pass) and their dedup references are dropped;
            # the re-striped pages carry new content phases, so any
            # caller-supplied digests no longer apply (the host twin
            # re-fingerprints).
            if use_dedup and acquired:
                self.dedup_index.unreference(acquired, peer=self.name)
                acquired = []
            plans = []
            for idx, (buf, _off) in enumerate(items):
                stored[idx].clear()
                plans.append((idx, self._plan_full_pages(
                    buf, infos[idx].offset, psize, infos[idx].p0)))
            barrier = max(barrier, self._store_planned(
                plans, stored, psize=psize, use_dedup=use_dedup,
                acquired=acquired, blob_id=blob_id))

        # -- phase 3: boundary pages, intra-batch merges resolved locally --
        prebatch_size = infos[0].prev_size
        prebatch_version = infos[0].version - 1

        def make_old_read(idx: int) -> Callable[[int, int], bytes]:
            def old_read(a: int, b: int) -> bytes:
                # Content of snapshot v_{idx}-1 over [a, b): pre-batch
                # bytes below the batch's starting size (the only remote
                # part — and the only wait, on the pre-batch writer),
                # overlaid with every earlier buffer in the batch (their
                # versions are exactly the snapshots between the batch
                # base and v_idx).
                out = bytearray(b - a)
                lo_remote = min(b, prebatch_size)
                if a < lo_remote and prebatch_version > 0:
                    self.vm.wait_metadata(blob_id, prebatch_version)
                    out[0:lo_remote - a] = self._read_unpublished(
                        blob_id, prebatch_version, a, lo_remote - a,
                        infos[idx])
                for j in range(idx):
                    jbuf = items[j][0]
                    joff = infos[j].offset
                    lo, hi = max(a, joff), min(b, joff + len(jbuf))
                    if hi > lo:
                        out[lo - a:hi - a] = jbuf[lo - joff:hi - joff]
                return bytes(out)
            return old_read

        versions: List[int] = []
        for idx, (buf, _off) in enumerate(items):
            info = infos[idx]
            stored_boundary, b3 = self._store_boundary_pages(
                blob_id, buf, info.offset, len(buf), psize, info,
                stored[idx], old_read=make_old_read(idx),
            )
            barrier = max(barrier, b3)
            pd_final = tuple(
                (pid, rel, provs, ln)
                for rel, (pid, provs, ln) in sorted(stored[idx].items())
            )
            if stored_boundary or pd_final != pd_wire[idx]:
                self.vm.register_pd(blob_id, info.version, pd_final,
                                    client=self.name)

            # -- phase 4a: weave each update's metadata (border ranges of
            # concurrent batch members resolve locally from AssignInfo) --
            self._build_and_complete(blob_id, info, pd_final, complete=False)
            versions.append(info.version)

        # -- phase 4b: store barrier, then ONE batched completion --
        self._await(barrier)
        self.vm.metadata_complete_many(
            [(blob_id, v) for v in versions], client=self.name)
        return versions

    # ------------------------------------------------------- update internals
    def _plan_full_pages(
        self, buf: bytes, off: int, psize: int, p0: int,
    ) -> List[Tuple[int, bytes]]:
        """``(rel_page, payload)`` for every page fully covered by the
        byte range ``[off, off+len(buf))`` (boundary pages are phase 3's
        job).  ``p0`` is the update's first touched page."""
        full_lo = -(-off // psize)                 # first fully covered page
        full_hi = (off + len(buf)) // psize        # one past last fully covered
        return [
            (k - p0, buf[k * psize - off:(k + 1) * psize - off])
            for k in range(full_lo, full_hi)
        ]

    def _store_planned(
        self,
        plans: Sequence[Tuple[int, List[Tuple[int, bytes]]]],
        stored: List[Dict[int, Tuple[str, Tuple[str, ...], int]]],
        *,
        psize: Optional[int] = None,
        digests: Optional[Sequence[Sequence[Tuple[int, int]]]] = None,
        use_dedup: bool = False,
        acquired: Optional[List[str]] = None,
        blob_id: Optional[str] = None,
    ) -> float:
        """Store many updates' planned pages in one grouped, pipelined
        ``store_pages`` call; returns the store barrier instant.

        With ``use_dedup`` the two-phase handshake runs first: one
        batched ``lookup_and_acquire`` over every planned page's
        fingerprint (caller-supplied ``digests`` where given, host
        digest otherwise — planned pages are always full ``psize``
        pages, so the two are interchangeable); hits reuse the indexed
        descriptor and ship no bytes, misses store normally and are
        then registered fire-and-forget.  Acquired/registered page-ids
        are appended to ``acquired`` so a re-stripe can drop them.
        """
        flat = [(idx, rel, payload)
                for idx, plan in plans for rel, payload in plan]
        if not flat:
            return 0.0

        if use_dedup:
            wants: List[Tuple[int, int, int]] = []
            for idx, plan in plans:
                dlist = digests[idx] if digests is not None else None
                if dlist is not None and len(dlist) != len(plan):
                    raise ValueError(
                        f"item {idx}: {len(dlist)} digests for "
                        f"{len(plan)} fully covered pages")
                for k, (_rel, payload) in enumerate(plan):
                    if dlist is not None:
                        d0, d1 = int(dlist[k][0]), int(dlist[k][1])
                    else:
                        d0, d1 = host_page_digest(payload, psize)
                    wants.append((d0, d1, len(payload)))
            matches = self.dedup_index.lookup_and_acquire(
                wants, peer=self.name)
            misses: List[int] = []
            for j, ((idx, rel, _payload), hit) in enumerate(zip(flat, matches)):
                if hit is None:
                    misses.append(j)
                else:
                    pid, provs, length = hit
                    stored[idx][rel] = (pid, tuple(provs), length)
                    if acquired is not None:
                        acquired.append(pid)
            if not misses:
                return 0.0
            keep_keys = [wants[j] for j in misses]
            flat = [flat[j] for j in misses]
        else:
            keep_keys = None

        # Per-blob placement: the policy picks the provider-group shape
        # and tags new page ids so their layout is self-describing
        # ("pg-...-ec6+2" pages fan into shards on the read path).
        policy = self.pm.policy_for(blob_id)
        page_ids = [fresh_page_id(tag=policy.tag) for _ in flat]
        groups = self.pm.allocate(len(flat), blob_id=blob_id,
                                  page_ids=page_ids)
        puts = [(groups[i], page_ids[i], payload)
                for i, (_idx, _rel, payload) in enumerate(flat)]
        locations, done_at = self.pm.store_pages(puts, peer=self.name)
        for (idx, rel, payload), (_g, pid, _p), provs in zip(flat, puts,
                                                             locations):
            stored[idx][rel] = (pid, tuple(provs), len(payload))
        if keep_keys is not None:
            reg = [(key, pid, tuple(provs), len(payload))
                   for key, (_g, pid, payload), provs
                   in zip(keep_keys, puts, locations)]
            self.dedup_index.register(reg, peer=self.name)
            if acquired is not None:
                acquired.extend(pid for _key, pid, _provs, _ln in reg)
        return done_at

    def _store_full_pages(
        self,
        buf: bytes,
        off: int,
        psize: int,
        p0: int,
        stored: Dict[int, Tuple[str, Tuple[str, ...], int]],
        blob_id: Optional[str] = None,
    ) -> float:
        """Store every fully covered page of one update (phase 1);
        returns the pipelined store barrier (0.0 on the wall backend)."""
        return self._store_planned(
            [(0, self._plan_full_pages(buf, off, psize, p0))], [stored],
            blob_id=blob_id)

    def _store_boundary_pages(
        self,
        blob_id: str,
        buf: bytes,
        off: int,
        size: int,
        psize: int,
        info: AssignInfo,
        stored: Dict[int, Tuple[str, Tuple[str, ...], int]],
        old_read: Optional[Callable[[int, int], bytes]] = None,
    ) -> Tuple[bool, float]:
        """Create merged pages for partially covered boundary pages.

        Returns ``(stored_any, barrier)``.  ``old_read(a, b)`` supplies
        the previous snapshot's bytes over ``[a, b)``; the default reads
        snapshot ``vw-1`` through the DHT after ``wait_metadata`` — the
        "only boundary pages ever wait on vw-1" contract: this is the
        single point in the write path that can block on another
        writer, and it blocks only when the boundary page actually
        needs bytes the update does not overwrite.  Batched updates
        pass an ``old_read`` that serves intra-batch ranges from the
        batch's own buffers (no wait at all).
        """
        vw = info.version
        end = off + size
        boundary: List[int] = []
        if off % psize != 0:
            boundary.append(off // psize)
        if end % psize != 0 and end // psize not in boundary:
            boundary.append(end // psize)
        if not boundary:
            return False, 0.0

        old_size = info.prev_size
        if old_read is None:
            def old_read(a: int, b: int) -> bytes:
                # merging needs snapshot vw-1 content: the one wait
                if vw - 1 > 0:
                    self.vm.wait_metadata(blob_id, vw - 1)
                    return self._read_unpublished(blob_id, vw - 1, a, b - a,
                                                  info)
                return b"\0" * (b - a)

        puts: List[Tuple[Sequence, str, bytes]] = []
        metas: List[Tuple[int, int]] = []
        policy = self.pm.policy_for(blob_id)
        for k in boundary:
            page_start = k * psize
            page_end_new = min((k + 1) * psize, info.new_size)
            length = page_end_new - page_start
            page = bytearray(length)
            # old content of this page from snapshot vw-1, fetched only
            # when some byte of it survives the overlay (a boundary page
            # whose old bytes are all overwritten never waits)
            old_hi = min(old_size, page_end_new)
            needs_old = (page_start < off and old_size > page_start) or \
                        (end < old_hi)
            if needs_old and old_hi > page_start:
                old = old_read(page_start, old_hi)
                page[0:len(old)] = old
            # overlay the new bytes
            lo = max(off, page_start)
            hi = min(end, page_end_new)
            page[lo - page_start:hi - page_start] = buf[lo - off:hi - off]
            bpid = fresh_page_id(tag=policy.tag)
            puts.append((self.pm.allocate(1, blob_id=blob_id,
                                          page_ids=[bpid])[0],
                         bpid, bytes(page)))
            metas.append((k, length))
        locations, done_at = self.pm.store_pages(puts, peer=self.name)
        for (_g, pid, _payload), provs, (k, length) in zip(puts, locations,
                                                           metas):
            stored[k - info.p0] = (pid, tuple(provs), length)
        return True, done_at

    def _read_unpublished(
        self, blob_id: str, version: int, offset: int, size: int, info: AssignInfo
    ) -> bytes:
        """Read from a snapshot whose metadata is complete but possibly
        not yet published (boundary merge against vw-1)."""
        psize = self.vm.psize_of(blob_id)
        rec = self.vm.update_log(blob_id, version)
        p0, p1 = pages_spanned(offset, size, psize)
        pd = st.read_meta(
            self.dht, self._owner_fn(blob_id), version, rec.root_pages, p0, p1,
            peer=self.name,
        )
        return self._fetch_ranges(pd, offset, size, psize)

    def _build_and_complete(self, blob_id: str, info: AssignInfo, pd_final,
                            store_barrier: float = 0.0,
                            complete: bool = True) -> None:
        """Phase 4: prefetch the border set, weave, publish.

        The :class:`AssignInfo` carries the full border context, so the
        entire border set (``st.border_ranges``) is resolved upfront as
        ONE level-batched ``resolve_many`` cohort — BUILD_META's
        per-level lookups then hit the resolver cache and the weave
        itself issues only its ``put_many`` node writes.  The writer
        sleeps to ``store_barrier`` (pipelined page stores) before
        signalling completion; with ``complete=False`` the caller
        batches the completion itself (``metadata_complete_many``).
        """
        leaves = [
            st.PageDescriptor(info.p0 + rel, pid, tuple(provs), ln)
            for (pid, rel, provs, ln) in pd_final
        ]
        border = st.BorderResolver(
            self.dht, self._owner_fn(blob_id), info.recent_updates,
            info.vp, info.vp_root_pages, peer=self.name,
        )
        border.prefetch(st.border_ranges(
            UpdateExtent(info.p0, info.p1, info.root_pages)))
        st.build_meta(
            self.dht, self._owner_fn(blob_id), info.version, info.root_pages,
            leaves, border, peer=self.name,
        )
        self._await(store_barrier)
        if complete:
            self.vm.metadata_complete(blob_id, info.version, client=self.name)

    # ------------------------------------------------- recovery (beyond paper)
    def rebuild_metadata(self, blob_id: str, version: int) -> None:
        """Replay BUILD_META for a writer that died after assignment.

        Page descriptors come from the version manager's WAL; the
        construction is deterministic, so replaying alongside a slow (not
        actually dead) writer is safe — both produce identical nodes and
        the DHT treats identical re-puts as replica re-sends.
        """
        info = self.vm.assign_info_for_recovery(blob_id, version)
        rec = self.vm.update_log(blob_id, version)
        if not rec.pd:
            raise RuntimeError(
                f"cannot recover {blob_id} v{version}: no page descriptors journaled"
            )
        self._build_and_complete(blob_id, info, rec.pd)

    # ------------------------------------------------------------- passthrough
    def get_recent(self, blob_id: str) -> int:
        """GET_RECENT: a recently published, still-live snapshot version
        (0 for an empty blob; retired versions are never handed out)."""
        return self.vm.get_recent(blob_id, client=self.name)

    def get_size(self, blob_id: str, version: int) -> int:
        """GET_SIZE of a published snapshot; raises
        :class:`~repro.core.version_manager.VersionUnpublished` /
        :class:`~repro.core.version_manager.RetiredVersion` otherwise."""
        return self.vm.get_size(blob_id, version, client=self.name)

    def sync(self, blob_id: str, version: int, timeout: Optional[float] = None) -> None:
        """Block (through the deployment clock) until ``version`` is
        published — read-your-writes for a writer that kept its vw."""
        self.vm.sync(blob_id, version, timeout=timeout, client=self.name)

    def branch(self, blob_id: str, version: int) -> str:
        """BRANCH: fork a new blob whose snapshots ``<= version`` are
        shared with the parent (zero copying — the paper's cheap
        branching); returns the new blob id."""
        bid = self.vm.branch(blob_id, version, client=self.name)
        self._lineage_cache.pop(bid, None)
        return bid

    # ----------------------------------------------------- GC: pins, retention
    def pin(self, blob_id: str, version: int, ttl: Optional[float] = None) -> str:
        """Pin a published snapshot against GC; returns the lease id.

        A pinned version is kept (and fully readable) across GC rounds
        until :meth:`unpin` or until the lease's clock-based ``ttl``
        expires — the checkpoint layer pins what it restores from.
        """
        return self.vm.pin(blob_id, version, client=self.name, ttl=ttl)

    def unpin(self, lease_id: str) -> None:
        """Release a pin lease taken with :meth:`pin` (idempotent)."""
        self.vm.unpin(lease_id, client=self.name)

    def set_retention(self, blob_id: str, keep_last: int) -> None:
        """Keep the newest ``keep_last`` published snapshots at GC time
        (plus pins, branch roots and in-flight anchors); 0 = keep all."""
        self.vm.set_retention(blob_id, keep_last, client=self.name)

    # -------------------------------------------- subscriptions: watch/notify
    @property
    def inbox(self) -> WatchInbox:
        """This client's notification inbox (created and registered
        with the version manager on first use)."""
        if self._watch_inbox is None:
            self._watch_inbox = WatchInbox(self.wire, self.name)
            self.vm.register_inbox(self._watch_inbox)
        return self._watch_inbox

    def watch(self, blob_id: str, from_version: int = 0,
              ttl: Optional[float] = None) -> str:
        """Lease a push subscription on ``blob_id``: publications past
        ``from_version`` are delivered to this client's :attr:`inbox`
        (already-published versions catch up immediately).  ``ttl``
        arms a renewable clock-based expiry (``None`` = until
        :meth:`unwatch`).  Returns the lease id — hand it to
        :meth:`poll_notifications` / ``inbox.wait_for``."""
        inbox = self.inbox
        wid = self.vm.watch(blob_id, from_version, endpoint=inbox.endpoint,
                            client=self.name, ttl=ttl)
        inbox.track(wid, from_version)
        return wid

    def unwatch(self, watch_id: str) -> None:
        """Cancel a watch lease (idempotent); nothing is delivered to
        it afterward."""
        self.vm.unwatch(watch_id, client=self.name)
        if self._watch_inbox is not None:
            self._watch_inbox.forget(watch_id)

    def renew_watch(self, watch_id: str, ttl: Optional[float]) -> None:
        """Extend a watch lease's expiry (``None`` = make permanent)."""
        self.vm.renew_watch(watch_id, ttl, client=self.name)

    def poll_notifications(self, watch_id: str) -> List[int]:
        """Drain the lease's arrived version notifications (ascending,
        monotone across calls, no duplicates)."""
        return self.inbox.poll(watch_id)

    def wait_for_version(self, blob_id: str, version: int,
                         timeout: Optional[float] = None) -> int:
        """Block until ``blob_id``'s snapshot ``version`` is published,
        by subscription instead of SYNC polling: takes a temporary
        watch from ``version - 1``, waits for the push, and releases
        the lease.  Returns ``version``; raises ``TimeoutError`` on the
        deadline."""
        wid = self.watch(blob_id, from_version=max(0, version - 1))
        try:
            self.inbox.wait_for(wid, version, timeout=timeout)
        finally:
            self.unwatch(wid)
        return version
