"""Content-hash page index: equal-content pages stored and shipped once.

The segment tree already shares *unchanged subtrees* between versions;
this index extends copy-on-write sharing to *equal-content* pages that
arrive through different paths — adjacent checkpoint steps, forked
fine-tune lineages, re-striped appends.  It lives beside the DHT as its
own endpoint and maps a 64-bit page fingerprint (two independent 32-bit
polynomial digests, see ``kernels/hostdigest.py``) plus the payload
length to the descriptor of the first stored copy, with a reference
count.

Write-path handshake (``BlobClient._store_planned``):

1. the client digests every full page of a burst (device kernel for
   checkpoints, host twin otherwise) and probes the index with ONE
   batched ``lookup_and_acquire`` RPC — the single blocking control
   round trip dedup adds per burst;
2. hits bump the refcount and reuse the existing descriptor — those
   pages never ship bytes;
3. misses are stored normally, then ``register``-ed fire-and-forget
   (refcount 1 = the storer's own descriptor reference).

Refcount lifecycle invariant: **refcount == number of outstanding
page-descriptor references**.  Every acquisition (a ``register`` by the
storer, a hit by a reuser) is matched by exactly one release — either
an ``unreference`` when a re-striped append abandons its optimistic
pages, or a GC ``release_many`` when the referencing version is swept
(idempotent per ``(blob, version, rel)`` so sweep retries never
double-decrement).  The sweep deletes a page's bytes only at refcount
zero AND after mark-phase liveness lapsed; a positive refcount after
release means another version still holds the page and the sweeper
finalizes without deleting.  Refcount zero alone is NOT sufficient:
copy-on-write subtree sharing keeps pages live with no pd reference at
all, so zero-refcount entries of still-live pages stay indexed and
matchable (a later lookup resurrects them to refcount 1 — that is what
keeps a restarted checkpointer's re-digested pages deduplicating)
until the mark path claims them through ``claim_dead``.  The index is
volatile (rebuilt empty on restore): mark-based liveness remains a
sufficient correctness backstop on its own, refcounts only ever *defer*
deletion, never cause one.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.core.transport import (
    DEDUP_LOOKUP_REQ_BYTES,
    DEDUP_REFRESH_REQ_BYTES,
    DEDUP_REGISTER_REQ_BYTES,
    DEDUP_RELEASE_REQ_BYTES,
    Wire,
)

# (digest0, digest1, payload_length) — length disambiguates tail pages
# whose zero-padding makes their digest equal a longer page's.
DigestKey = Tuple[int, int, int]
# (blob_id, version, rel) — one pd slot of one version; the idempotency
# unit for GC releases.
RefKey = Tuple[str, int, int]


@dataclass
class _Entry:
    page_id: str
    providers: Tuple[str, ...]
    length: int
    refcount: int


class DedupIndex:
    """Digest → page-descriptor index with wire-accounted verbs."""

    ENDPOINT = "dedup-idx"

    def __init__(self, wire: Wire) -> None:
        self.wire = wire
        self._lock = threading.Lock()
        self._by_digest: Dict[DigestKey, _Entry] = {}
        self._by_pid: Dict[str, DigestKey] = {}
        self._released: Set[RefKey] = set()
        # True once any page was ever registered; GC consults this to
        # skip release/guard RPCs entirely for dedup-free workloads so
        # their wire schedules stay byte-identical to the non-dedup
        # write plane.
        self.ever_registered = False
        self._counters: Dict[str, int] = {}
        self.reset_rpc_counters()

    # ----------------------------------------------------------- write path
    def lookup_and_acquire(
        self, wants: Sequence[DigestKey], peer: Optional[str] = None
    ) -> List[Optional[Tuple[str, Tuple[str, ...], int]]]:
        """Probe ``wants`` in ONE batched RPC; hits bump the refcount.

        Returns, aligned with ``wants``, the reusable descriptor
        ``(page_id, providers, length)`` or ``None`` per digest.  The
        bump happens inside the probe so a concurrent sweep can never
        observe the page unreferenced between match and use.
        """
        if not wants:
            return []
        self.wire.transfer_batch(
            self.ENDPOINT,
            [DEDUP_LOOKUP_REQ_BYTES] * len(wants),
            inbound=True,
            peer=peer,
        )
        out: List[Optional[Tuple[str, Tuple[str, ...], int]]] = []
        with self._lock:
            self._counters["lookup_rounds"] += 1
            self._counters["lookup_keys"] += len(wants)
            for key in wants:
                ent = self._by_digest.get(key)
                if ent is None:
                    out.append(None)
                else:
                    ent.refcount += 1
                    self._counters["hits"] += 1
                    self._counters["hit_bytes"] += ent.length
                    out.append((ent.page_id, ent.providers, ent.length))
        return out

    def register(
        self,
        items: Sequence[Tuple[DigestKey, str, Tuple[str, ...], int]],
        peer: Optional[str] = None,
    ) -> None:
        """Index freshly stored pages, fire-and-forget (never gates the
        writer).  Refcount starts at 1: the storer's own pd reference.
        If two writers raced the same content, first registration wins
        and the loser's copy stays unindexed (its own pd still owns it;
        GC's mark path collects it normally)."""
        if not items:
            return
        self.wire.transfer_batch(
            self.ENDPOINT,
            [DEDUP_REGISTER_REQ_BYTES] * len(items),
            inbound=True,
            peer=peer,
            fire_and_forget=True,
        )
        with self._lock:
            self._counters["register_rounds"] += 1
            self.ever_registered = True
            for key, pid, provs, length in items:
                if key in self._by_digest or pid in self._by_pid:
                    continue
                self._by_digest[key] = _Entry(pid, tuple(provs), length, 1)
                self._by_pid[pid] = key
                self._counters["registered"] += 1

    def refresh_providers(
        self,
        updates: Sequence[Tuple[str, Tuple[str, ...]]],
        peer: Optional[str] = None,
    ) -> int:
        """Batched provider-refresh: the repair plane's stale-descriptor
        fix.  ``updates`` holds ``(page_id, new_provider_tuple)`` pairs
        for pages whose bytes repair (or lifecycle demotion) moved; the
        entry's frozen ``providers`` tuple is replaced so later dedup
        hits hand out descriptors pointing at live endpoints instead of
        the dead one.  Fire-and-forget (repair never gates on the
        index; a reader holding a not-yet-refreshed descriptor still
        recovers through the provider manager's relocation overlay).
        Returns the number of entries actually updated.
        """
        if not updates:
            return 0
        self.wire.transfer_batch(
            self.ENDPOINT,
            [DEDUP_REFRESH_REQ_BYTES] * len(updates),
            inbound=True,
            peer=peer,
            fire_and_forget=True,
        )
        n = 0
        with self._lock:
            self._counters["refresh_rounds"] += 1
            for pid, provs in updates:
                key = self._by_pid.get(pid)
                if key is None:
                    continue
                self._by_digest[key].providers = tuple(provs)
                self._counters["refreshed"] += 1
                n += 1
        return n

    def unreference(
        self, page_ids: Sequence[str], peer: Optional[str] = None
    ) -> None:
        """Drop plain references (no version attached) — the re-striped
        append abandoning its optimistic pages.  Fire-and-forget; a
        refcount reaching zero only unindexes the entry (the bytes, if
        any were stored, become orphans for the inventory pass)."""
        if not page_ids:
            return
        self.wire.transfer_batch(
            self.ENDPOINT,
            [DEDUP_RELEASE_REQ_BYTES] * len(page_ids),
            inbound=True,
            peer=peer,
            fire_and_forget=True,
        )
        with self._lock:
            self._counters["release_rounds"] += 1
            for pid in page_ids:
                self._release_pid(pid, unindex_at_zero=True)

    def _release_pid(self, pid: str, *, unindex_at_zero: bool) -> Optional[int]:
        """Decrement under the lock.  Returns the new refcount, or None
        if the pid is not indexed.  ``unindex_at_zero`` is the plain
        client-side release (abandoned pages become orphans); the GC
        path keeps zero-refcount entries so :meth:`release_many` can
        rule on liveness first."""
        key = self._by_pid.get(pid)
        if key is None:
            return None
        ent = self._by_digest[key]
        ent.refcount -= 1
        self._counters["released"] += 1
        if unindex_at_zero and ent.refcount <= 0:
            del self._by_digest[key]
            del self._by_pid[pid]
            self._counters["dropped"] += 1
        return ent.refcount

    def _unindex(self, pid: str) -> None:
        key = self._by_pid.pop(pid, None)
        if key is not None:
            del self._by_digest[key]
            self._counters["dropped"] += 1

    # ------------------------------------------------------------------- GC
    def release_many(
        self,
        refs: Sequence[Tuple[RefKey, str]],
        live: Set[str],
        peer: Optional[str] = None,
    ) -> Tuple[Set[str], Set[str]]:
        """Release swept versions' page references; ONE blocking batch
        (the sweeper needs the refcount verdicts back).

        ``refs``: ``((blob, version, rel), page_id)`` per pd slot;
        idempotent per ref-key, so a sweep retried after a failed
        delete can never double-decrement.  All decrements apply first,
        then per-page verdicts are computed on the final refcount:

        * ``keep``  — refcount still positive: another version holds
          the page; the sweeper must NOT delete, and needs no deferral.
        * ``drop``  — refcount hit zero and the page is not pinned live
          by a kept version's subtree: the entry is removed under the
          lock (no later lookup can resurrect it) and the bytes are
          safe to delete now.

        A page whose refcount reached zero but that IS still live stays
        *indexed at refcount zero*: pd refcounts only count the
        versions that created/acquired the page, while copy-on-write
        subtree sharing keeps pages live with no pd reference at all —
        exactly the pages a restarted checkpointer re-digests, so their
        entries must stay matchable (a hit resurrects the entry to
        refcount 1).  Liveness-driven deletion of those entries belongs
        to the mark path, which must claim them through
        :meth:`claim_dead` first.  Pages in neither returned set fall
        through to the caller's mark-based path.
        """
        if not refs:
            return set(), set()
        self.wire.transfer_batch(
            self.ENDPOINT,
            [DEDUP_RELEASE_REQ_BYTES] * len(refs),
            inbound=True,
            peer=peer,
        )
        keep: Set[str] = set()
        drop: Set[str] = set()
        with self._lock:
            self._counters["release_rounds"] += 1
            touched: Dict[str, int] = {}
            for refkey, pid in refs:
                if refkey in self._released:
                    continue
                self._released.add(refkey)
                rc = self._release_pid(pid, unindex_at_zero=False)
                if rc is not None:
                    touched[pid] = rc
            for pid, rc in touched.items():
                if rc > 0:
                    keep.add(pid)
                elif pid not in live:
                    self._unindex(pid)
                    drop.add(pid)
                # rc == 0 and live: entry stays, matchable at rc 0; the
                # mark path defers the version until liveness lapses.
        return keep, drop

    def claim_dead(
        self, page_ids: Sequence[str], peer: Optional[str] = None
    ) -> Tuple[Set[str], Set[str]]:
        """Atomically claim mark-dead pages for deletion.

        Between a sweep's mark phase and its delete RPCs other tasks
        run (the virtual clock yields at every blocking transfer), so a
        zero-refcount entry the mark found dead may be *resurrected* by
        a concurrent lookup before the delete lands.  The sweeper
        therefore claims each candidate under the index lock first:

        * entry at refcount 0 (or missing) — claimed: removed from the
          index, no future lookup can hand it out, delete is safe;
        * entry at refcount > 0 — ``resurrected``: a writer acquired
          the page after the mark; the sweeper must skip the delete
          (the new holder's own release will retire the bytes later).

        Local decision on sweep-side state — rides the delete round it
        gates, so no wire charge of its own.
        """
        claimed: Set[str] = set()
        resurrected: Set[str] = set()
        with self._lock:
            for pid in page_ids:
                key = self._by_pid.get(pid)
                if key is None:
                    claimed.add(pid)
                elif self._by_digest[key].refcount > 0:
                    resurrected.add(pid)
                else:
                    self._unindex(pid)
                    claimed.add(pid)
        return claimed, resurrected

    def orphan_guard(
        self, page_ids: Sequence[str], peer: Optional[str] = None
    ) -> Set[str]:
        """Reconcile the orphan inventory against the index; returns the
        page-ids to KEEP.  An orphan candidate (stored but in no
        journaled pd) with refcount >= 2 has a hitter beyond its storer
        — typically a writer that acquired the page but has not
        published its descriptor yet — so its bytes must survive.  At
        refcount <= 1 the only reference is the storer's own, which the
        inventory just proved stale: the entry is dropped and the
        delete proceeds."""
        if not page_ids:
            return set()
        self.wire.transfer_batch(
            self.ENDPOINT,
            [DEDUP_LOOKUP_REQ_BYTES] * len(page_ids),
            inbound=True,
            peer=peer,
        )
        kept: Set[str] = set()
        with self._lock:
            self._counters["guard_rounds"] += 1
            for pid in page_ids:
                key = self._by_pid.get(pid)
                if key is None:
                    continue
                if self._by_digest[key].refcount >= 2:
                    kept.add(pid)
                else:
                    del self._by_digest[key]
                    del self._by_pid[pid]
                    self._counters["dropped"] += 1
        return kept

    def forget_pages(self, page_ids: Iterable[str]) -> None:
        """Unconditional local unindex, invoked by the provider manager
        alongside every page-delete RPC (no wire charge of its own — it
        rides the delete round).  Belt to the refcount braces: no index
        entry can outlive its bytes, so a later digest match can never
        resurrect a deleted page."""
        with self._lock:
            for pid in page_ids:
                key = self._by_pid.pop(pid, None)
                if key is not None:
                    del self._by_digest[key]
                    self._counters["dropped"] += 1

    # ------------------------------------------------------------ inspection
    def refcount(self, page_id: str) -> int:
        """Current refcount of an indexed page (0 if unindexed)."""
        with self._lock:
            key = self._by_pid.get(page_id)
            return self._by_digest[key].refcount if key is not None else 0

    def indexed_pages(self) -> Dict[str, int]:
        """Snapshot ``{page_id: refcount}`` — oracle hook for tests."""
        with self._lock:
            return {pid: self._by_digest[key].refcount
                    for pid, key in self._by_pid.items()}

    def rpc_counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def reset_rpc_counters(self) -> None:
        with self._lock:
            self._counters = {
                "lookup_rounds": 0,
                "lookup_keys": 0,
                "hits": 0,
                "hit_bytes": 0,
                "register_rounds": 0,
                "registered": 0,
                "release_rounds": 0,
                "released": 0,
                "guard_rounds": 0,
                "dropped": 0,
                "refresh_rounds": 0,
                "refreshed": 0,
            }
