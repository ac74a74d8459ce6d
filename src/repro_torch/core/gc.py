"""Distributed snapshot-retirement GC (beyond paper).

The paper's copy-on-write versioning never frees space ("versioning
efficiency ... reasonably acceptable overhead of storage space"); a
production deployment must retire old snapshots **without stopping
readers or writers**.  GC here is a distributed protocol that runs
entirely through the RPC plane — every mark fetch and every sweep
delete crosses the :class:`~repro.core.transport.Wire` and shows up in
``service.rpc_report()`` — and is safe concurrently with live clients:

1. **plan** (version manager, one control RPC per blob): atomically
   compute the retirement set from the retention policy (keep-last-K),
   pin leases, branch roots and in-flight writers' border anchors; mark
   retire-*intent* and journal it to the WAL.  From this instant
   readers/pinners/branchers of a retired version get a typed
   :class:`~repro.core.version_manager.RetiredVersion`.  With the
   sharded write plane every keep rule is an intra-lineage fact
   (branches share their ancestor's shard), so each blob's plan runs
   under its own lineage lock and scans only that lineage — a GC round
   never stalls writers of unrelated blobs.
2. **drain** (epoch barrier): wait until every read lease opened on a
   retired version *before* the intent has been released.  Reads of
   kept versions are never blocked — their safety comes from marking.
3. **mark**: walk the segment trees of every kept snapshot (all blobs,
   so branch lineages are covered) *level-synchronously* with batched
   ``get_many`` — at most ``depth + 1`` latency waves per tree, cost
   proportional to the live set, not to history length.
4. **sweep**: the candidate set of a retired version is derived with no
   I/O at all — its created tree nodes from the deterministic tree
   shape (``iter_created_nodes``) and its pages from the journaled page
   descriptors.  Candidates not reachable from any kept snapshot are
   deleted with batched wire verbs: ``MetadataDHT.delete_many`` (one
   round trip per touched shard) and ``ProviderManager.delete_pages``
   (one per touched endpoint).  Deletes are idempotent; versions whose
   deletes all succeeded are finalized in the WAL, the rest are
   re-swept next round.  When content-addressed dedup is in play the
   sweep first releases the retired versions' page references through
   the :class:`~repro.core.dedup_index.DedupIndex` — bytes are deleted
   only at refcount zero, so an equal-content page shared by another
   lineage survives its co-owners' retirement (see ``_sweep``).

Why concurrent readers/writers are safe:

* a reader of a kept version only touches nodes/pages reachable from a
  kept root — all marked live, never deleted;
* a reader of a retired version is either rejected at ``enter_read``
  (typed error) or drained before the first delete goes out;
* a writer's border descent anchors on a published version the version
  manager keeps alive while the update is in flight (``vp`` anchors),
  and the nodes it creates carry a version number newer than anything
  retired — never sweep candidates.

Cache coherence: the read-path page cache (``core/cache.py``) is
evicted twice per round — at retire-*intent* (the ``gc_epoch`` bump
fires the version manager's GC listeners with the retired versions'
page ids) and again inside ``ProviderManager.delete_pages`` before the
first delete RPC, which also dooms in-flight fetches of the doomed
pages.  A cached page therefore never outlives its sweep; GC itself
never reads through a cache (``mark_live`` walks ``svc.dht`` raw).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.core import segment_tree as st
from repro_torch.core.pages import UpdateExtent, iter_created_nodes, node_children
from repro_torch.core.placement import logical_pid
from repro_torch.core.transport import EndpointDown
from repro_torch.core.version_manager import VersionUnpublished, owner_fn_for_lineage


def mark_live(
    svc, peer: Optional[str] = None
) -> Tuple[Set[Tuple], Set[str], int, int]:
    """Batched mark phase: walk every kept snapshot's tree.

    Returns ``(live_node_keys, live_page_ids, rounds, keys_fetched)``.
    The walk is level-synchronous across *all* roots of *all* blobs at
    once: each wave fetches the whole frontier with one ``get_many``
    (one batched round trip per touched shard), so the entire mark
    costs at most ``max tree depth + 1`` latency waves.  Shared
    subtrees are visited once (the frontier is deduplicated on node
    keys), which is what makes the cost proportional to the live set.
    """
    owner_of: Dict[str, object] = {}
    frontier: Dict[Tuple, str] = {}  # node key -> root blob id (for owner fn)
    for blob_id, roots in sorted(svc.vm.mark_roots().items()):
        owner_of[blob_id] = owner_fn_for_lineage(svc.vm.lineage(blob_id))
        for version, root_pages in roots:
            key = (owner_of[blob_id](version), version, 0, root_pages)
            frontier.setdefault(key, blob_id)

    live_nodes: Set[Tuple] = set()
    live_pages: Set[str] = set()
    rounds = keys_fetched = 0
    while frontier:
        keys = sorted(frontier)
        nodes = svc.dht.get_many(keys, peer=peer)
        rounds += 1
        keys_fetched += len(keys)
        nxt: Dict[Tuple, str] = {}
        for key in keys:
            blob_id = frontier[key]
            node = nodes.get(key)
            if node is None:
                raise st.MetadataMissing(f"mark walk: missing node {key!r}")
            live_nodes.add(key)
            if isinstance(node, st.LeafNode):
                live_pages.add(node.page_id)
                continue
            _owner, _v, off, size = key
            (lo, ls), (ro, rs) = node_children(off, size)
            for child_v, c_off, c_size in ((node.vl, lo, ls), (node.vr, ro, rs)):
                if child_v is None:
                    continue
                ckey = (owner_of[blob_id](child_v), child_v, c_off, c_size)
                if ckey not in live_nodes:
                    nxt.setdefault(ckey, blob_id)
        frontier = nxt
    return live_nodes, live_pages, rounds, keys_fetched


def _sweep(
    svc,
    pending: Dict[str, List],
    live_nodes: Set[Tuple],
    live_pages: Set[str],
    peer: Optional[str],
    finalize: bool = True,
) -> Dict[str, int]:
    """Batched sweep of ``pending`` (blob id -> retired UpdateRecords).

    Candidate nodes/pages come from pure page math and the journaled
    page descriptors; everything not marked live is deleted through the
    wire, grouped per shard / per endpoint across all blobs at once.

    Page locations are the assign-time replica lists (leaf nodes are
    immutable, so nothing fresher exists).  A version with a replica on
    a dead/deregistered endpoint stays *pending* and is retried every
    round — deliberately: finalizing it would leak the replica if the
    endpoint comes back, and the retry costs one batched RPC attempt
    per downed endpoint per round.

    Dedup awareness: when the deployment's content-hash index has ever
    registered a page, every pending version's pd references are first
    released through it in ONE batched ``release_many`` (idempotent per
    ``(blob, version, rel)``).  A page whose refcount stays positive is
    still held by another version — not deleted, and *not* a reason to
    defer this version; a page whose refcount reached zero and is not
    pinned live is deleted now.  Everything else (unindexed pages,
    zero-but-live) falls through to the pre-dedup mark-based logic, so
    refcounts only ever *defer* deletions, never cause one the mark
    phase would forbid.
    """
    idx = getattr(svc, "dedup_index", None)
    use_idx = idx is not None and idx.ever_registered
    keep_pids: Set[str] = set()
    drop_pids: Set[str] = set()
    if use_idx:
        refs = [((blob_id, rec.version, rel), pid)
                for blob_id, recs in sorted(pending.items())
                for rec in recs
                for pid, rel, _provs, _length in rec.pd]
        if refs:
            keep_pids, drop_pids = idx.release_many(
                refs, live_pages, peer=peer)

    dead_nodes: List[Tuple] = []
    dead_pages: List[Tuple[Tuple[str, ...], str]] = []
    page_bytes: Dict[str, int] = {}
    node_version: Dict[Tuple, Tuple[str, int]] = {}
    page_version: Dict[str, Tuple[str, int]] = {}
    # versions with candidates still reachable from a *kept* snapshot:
    # those items become garbage only when their keeper retires, so the
    # version must stay pending (never finalize) until everything it
    # created is confirmed dead and deleted — otherwise shared pages
    # would leak forever once the version left sweep_pending
    has_live: Set[Tuple[str, int]] = set()
    for blob_id, recs in sorted(pending.items()):
        for rec in recs:
            ext = UpdateExtent(rec.p0, rec.p1, rec.root_pages)
            for off, size in iter_created_nodes(ext):
                key = (blob_id, rec.version, off, size)
                if key in live_nodes:
                    has_live.add((blob_id, rec.version))
                else:
                    dead_nodes.append(key)
                    node_version[key] = (blob_id, rec.version)
            for pid, _rel, provs, length in rec.pd:
                if pid in keep_pids:
                    # refcount still positive: another version's pd holds
                    # the page — this version is done with it
                    continue
                if pid in drop_pids:
                    if pid not in page_version:
                        dead_pages.append((tuple(provs), pid))
                        page_bytes[pid] = length
                        page_version[pid] = (blob_id, rec.version)
                    continue
                if pid in live_pages:
                    has_live.add((blob_id, rec.version))
                elif pid not in page_version:
                    if use_idx:
                        # mark-dead but possibly resurrected: a lookup
                        # may have re-acquired the page since the mark
                        # (zero-refcount entries stay matchable) — claim
                        # it under the index lock or leave it alone
                        _claimed, resurrected = idx.claim_dead((pid,))
                        if resurrected:
                            continue  # new holder's release owns deletion
                    dead_pages.append((tuple(provs), pid))
                    page_bytes[pid] = length
                    page_version[pid] = (blob_id, rec.version)

    swept_nodes, failed_keys = (
        svc.dht.delete_many(dead_nodes, peer=peer) if dead_nodes else (0, [])
    )
    freed_pages, freed_bytes, missed = (
        svc.pm.delete_pages(dead_pages, peer=peer) if dead_pages else (0, 0, [])
    )

    # Finalize only versions whose every candidate is dead AND whose
    # every delete was acknowledged; the rest stay pending and are
    # re-examined next round (deletes are idempotent, and still-live
    # candidates cost no RPC — they are just rechecked against the next
    # mark's live set).
    incomplete: Set[Tuple[str, int]] = set(has_live)
    for key in failed_keys:
        incomplete.add(node_version[key])
    for pid in missed:
        incomplete.add(page_version[pid])
    if finalize:
        for blob_id, recs in sorted(pending.items()):
            done = [rec.version for rec in recs
                    if (blob_id, rec.version) not in incomplete]
            svc.vm.finalize_sweep(blob_id, done, client=peer)
    else:
        # restore-time resweep: a version finalized pre-crash whose
        # re-deletes failed (or whose candidates restore made reachable
        # again) must leave the finalized set — ordinary rounds only
        # look at retired - swept, so without this the resurrected
        # nodes/pages would leak until the next restart's resweep.
        for blob_id, recs in sorted(pending.items()):
            redo = [rec.version for rec in recs
                    if (blob_id, rec.version) in incomplete]
            svc.vm.unfinalize_sweep(blob_id, redo, client=peer)

    return {
        "swept_nodes": swept_nodes,
        "swept_pages": freed_pages,
        "reclaimed_bytes": freed_bytes,
        "failed_deletes": len(failed_keys) + len(missed),
        "deferred_versions": len(has_live),
    }


def collect_orphans(
    svc, grace: float, peer: Optional[str] = None
) -> Dict[str, int]:
    """Reclaim pages no assigned update has ever journaled.

    A writer stores pages *before* version assignment (the paper's
    lock-free data path); if it restripes an optimistic append or dies
    before ``assign_version``, those pages are referenced by nothing —
    no version, no WAL record — and the pd-derived sweep can never see
    them.  This pass asks every alive provider for a wire-accounted
    inventory (one batched round trip each) and deletes listed pages
    that are not journaled anywhere and are older than ``grace`` on the
    deployment clock.  The grace window is what makes it safe against
    in-flight writers between ``store_page`` and ``assign_version``.

    With dedup deployed, the inventory also reconciles the content-hash
    index: doomed pages are run through ``orphan_guard`` first — a page
    some in-flight writer has acquired (refcount ≥ 2) survives, a page
    whose only reference is its storer's now-provably-stale one is
    unindexed and deleted.
    """
    referenced = svc.vm.all_page_ids()
    now = svc.wire.clock.now()
    doomed: List[Tuple[Tuple[str, ...], str]] = []
    for prov in svc.pm.alive_providers():
        try:
            listing = prov.list_pages(peer=peer)
        except EndpointDown:
            continue
        # Providers list *physical* ids: an EC shard ("...-ec6+2.s3") is
        # referenced iff its logical page is journaled, so membership is
        # checked on the logical id (plain pages map to themselves).
        doomed.extend(((prov.pid,), pid) for pid, stored_at in listing
                      if logical_pid(pid) not in referenced
                      and now - stored_at >= grace)
    idx = getattr(svc, "dedup_index", None)
    if doomed and idx is not None and idx.ever_registered:
        kept = idx.orphan_guard([logical_pid(pid) for _provs, pid in doomed],
                                peer=peer)
        if kept:
            doomed = [(provs, pid) for provs, pid in doomed
                      if logical_pid(pid) not in kept]
    if not doomed:
        return {"orphan_pages": 0, "orphan_bytes": 0}
    # delete through the provider manager so the sweep counters in
    # rpc_report() account for orphan reclamation too; a page missed
    # because its endpoint just went down is simply retried by the next
    # round's inventory (it is still unreferenced)
    freed_pages, freed_bytes, _missed = svc.pm.delete_pages(doomed, peer=peer)
    return {"orphan_pages": freed_pages, "orphan_bytes": freed_bytes}


def collect_garbage(
    svc,
    keep: Optional[Dict[str, Iterable[int]]] = None,
    *,
    client: str = "gc",
    orphan_grace: Optional[float] = 600.0,
) -> Dict[str, int]:
    """One GC round over the whole deployment; safe with live clients.

    ``keep`` (optional) maps blob id -> versions to keep *explicitly*:
    for those blobs every other published version is retired (pins,
    branch roots, in-flight anchors and the newest published snapshot
    are still kept on top).  Blobs not listed follow their retention
    policy (``set_retention``; no policy = keep everything).

    ``orphan_grace`` additionally reclaims never-journaled pages older
    than the grace window (see :func:`collect_orphans`); ``None``
    disables the inventory pass.

    Every mark/sweep operation crosses the wire — zero direct shard or
    provider-store mutations — and the whole round is deterministic
    under the simulated clock.  Returns round statistics.
    """
    keep = keep or {}
    vm = svc.vm
    retired_now = 0
    kept_total = 0
    for blob_id in vm.known_blobs():
        kept_v, newly = vm.plan_retirement(
            blob_id,
            keep_extra=keep.get(blob_id),
            explicit=blob_id in keep,
            client=client,
        )
        kept_total += len(kept_v)
        retired_now += len(newly)
        if newly:
            vm.wait_reads_drained(blob_id, newly)

    pending = {
        blob_id: recs
        for blob_id in vm.known_blobs()
        if (recs := vm.sweep_pending(blob_id))
    }

    live_nodes, live_pages, mark_rounds, mark_keys = mark_live(svc, peer=client)
    stats = _sweep(svc, pending, live_nodes, live_pages, peer=client)
    if orphan_grace is not None:
        stats.update(collect_orphans(svc, orphan_grace, peer=client))
    else:
        stats.update({"orphan_pages": 0, "orphan_bytes": 0})
    stats.update({
        "live_nodes": len(live_nodes),
        "live_pages": len(live_pages),
        "kept_versions": kept_total,
        "retired_versions": retired_now,
        "mark_rounds": mark_rounds,
        "mark_keys": mark_keys,
        "sweep_versions": sum(len(r) for r in pending.values()),
    })
    return stats


def resweep_after_restore(svc, client: str = "gc-restore") -> Dict[str, int]:
    """Re-apply retirement after a cold restart.

    ``BlobSeerService.restore`` rebuilds metadata for *every* completed
    update — retired ones included, because rebuilding snapshot ``v``
    descends ``v-1``'s just-rebuilt tree.  This pass then re-deletes
    everything the pre-crash sweeps had reclaimed (the WAL's ``retire``
    records are authoritative), so a swept version never comes back:
    its reads still answer ``RetiredVersion`` and its dead nodes/pages
    are removed again.  Idempotent, wire-accounted, same code path as a
    live sweep.  Versions whose re-deletes report failures are
    *un-finalized* (journaled), so ordinary live rounds keep retrying
    them instead of leaking until the next restart.
    """
    vm = svc.vm
    pending: Dict[str, List] = {}
    for blob_id in vm.known_blobs():
        retired = vm.retired_versions(blob_id)
        if not retired:
            continue
        recs = []
        for v in sorted(retired):
            try:
                recs.append(vm.update_log(blob_id, v))
            except VersionUnpublished:
                # retire record without an assign record: skip.  ONLY
                # this typed answer means "never assigned" — any other
                # exception here is real corruption and must propagate
                continue
        if recs:
            pending[blob_id] = recs
    if not pending:
        return {"swept_nodes": 0, "swept_pages": 0, "reclaimed_bytes": 0,
                "failed_deletes": 0}
    live_nodes, live_pages, _rounds, _keys = mark_live(svc, peer=client)
    return _sweep(svc, pending, live_nodes, live_pages, peer=client,
                  finalize=False)
