"""Self-healing durability plane: scrub, repair, and lifecycle tiering.

The paper defers "volatility and failures" to future work; the repo's
only recovery primitive so far was the manual ``rereplicate_from``.
This module adds the background maintenance plane a real deployment
runs continuously on the simulated clock:

* :func:`scrub_round` — one verification + repair pass.  Every
  provider re-digests its stored pages in place
  (``DataProvider.verify_pages``, the host twin of the ``page_digest``
  Pallas kernel) and reports corruption; the version manager's
  durability inventory (``vm.page_locations``) is diffed against what
  providers actually hold to find dead-provider gaps and missing
  copies.  Damage is repaired **over the wire** under a per-round byte
  budget: replicated pages re-copy from a surviving replica,
  erasure-coded pages read any ``k`` live shards, decode, and re-encode
  exactly the lost shards.  Pages with no recoverable copy are returned
  as ``losses`` — never an exception; a scrub must always finish its
  sweep.

* :func:`lifecycle_round` — per-blob age-based demotion to the cold
  tier (``BlobSeerService.set_lifecycle``): pages older than the blob's
  threshold move from hot providers to S3-class cold endpoints.

Both passes generalize the PR 4 cache-bypass rule: maintenance reads go
*directly* to providers, never through the shared ``PageCache``, so
repair traffic cannot evict the readers' hot set or pollute hit/miss
accounting.  Both move bytes without rewriting published (immutable)
descriptors — moves land in the provider manager's **relocation
overlay**, which the read path consults once a descriptor's replica
list is exhausted, and the dedup index is refreshed in one batched
``refresh_providers`` verb so content-hash hits stop handing out dead
endpoints.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.placement import (
    SHARD_HDR_BYTES,
    ec_decode,
    ec_encode,
    page_codec,
    shard_id,
)
from repro_torch.core.provider import PageIntegrityError
from repro_torch.core.transport import EndpointDown

# Anything a repair read can hit mid-flight: the endpoint died, the copy
# vanished, or the copy is corrupt despite the probe snapshot saying
# otherwise.  All transient from the scrubber's view — defer the page.
_REPAIR_ERRORS = (EndpointDown, KeyError, PageIntegrityError)

# Default per-round repair budget: enough for a handful of 64 KiB pages
# per pass — repair converges over rounds instead of bursting.
DEFAULT_SCRUB_BUDGET = 8 * 1024 * 1024


def _shard_bytes(length: int, k: int) -> int:
    return SHARD_HDR_BYTES + max(1, -(-length // k))


def _alive(svc, pid: str) -> bool:
    return not svc.wire.is_down(pid)


def _provider(svc, pid: str):
    try:
        return svc.pm.get(pid)
    except KeyError:
        return None


def _pick_target(svc, exclude: Set[str]):
    """Least-loaded alive hot provider outside ``exclude`` (repair
    target selection; pid tie-break keeps replays deterministic)."""
    pool = [p for p in svc.pm.placement_pool() if p.pid not in exclude]
    if not pool:
        return None
    return min(pool, key=lambda p: (p.page_count(), p.pid))


def _restore_copy(svc, prov, phys: str, payload: bytes, peer: str) -> None:
    """Overwrite-safe re-store: drop the (possibly corrupt) copy first —
    stores reject a same-id put with different bytes."""
    prov.delete_pages([phys], peer=peer)
    prov.put_pages([(phys, payload)], peer=peer)


def scrub_round(
    svc,
    *,
    budget_bytes: int = DEFAULT_SCRUB_BUDGET,
    peer: str = "scrubber",
) -> Dict[str, object]:
    """One scrub/repair pass over the whole deployment.

    Returns a stats dict: ``pages_checked`` (logical pages in the
    inventory), ``providers_probed``, ``corrupt_copies`` /
    ``missing_copies`` (physical damage found), ``damaged_pages``,
    ``repaired_pages`` / ``repaired_copies`` / ``repair_bytes`` (what
    this round fixed and what it cost the wire), ``deferred_pages``
    (damage left for the next round — budget exhausted or a transient
    failure mid-repair), and ``losses`` (logical page ids with no
    recoverable copy: fewer than ``k`` shards / zero replicas).

    ``budget_bytes`` caps the round's repair traffic (reads + writes);
    a repair whose estimate does not fit is deferred, so
    ``repair_bytes <= budget_bytes`` always holds.  Detection traffic
    (inventory listings, digest probes) is not budgeted — it is cheap
    and must run to completion for losses to be trustworthy.
    """
    inventory = svc.vm.page_locations()
    stats: Dict[str, object] = {
        "pages_checked": len(inventory),
        "providers_probed": 0,
        "corrupt_copies": 0,
        "missing_copies": 0,
        "damaged_pages": 0,
        "repaired_pages": 0,
        "repaired_copies": 0,
        "repair_bytes": 0,
        "deferred_pages": 0,
        "losses": [],
    }

    # ---- probe: what does each provider actually hold, and is it sane?
    present: Dict[str, Set[str]] = {}
    corrupt: Dict[str, Set[str]] = {}
    reachable: Set[str] = set()
    for prov in sorted(svc.pm.all_providers(), key=lambda p: p.pid):
        if svc.wire.is_down(prov.pid):
            continue
        try:
            listing = prov.list_pages(peer=peer)
            bad = prov.verify_pages(peer=peer)
        except EndpointDown:
            continue  # died between the is_down check and the probe
        present[prov.pid] = {pid for pid, _at in listing}
        corrupt[prov.pid] = set(bad)
        reachable.add(prov.pid)
        stats["providers_probed"] += 1

    def copy_state(holder: str, phys: str) -> str:
        """healthy | corrupt | missing | dead (holder unreachable)."""
        if holder not in reachable:
            return "dead"
        if phys in corrupt[holder]:
            return "corrupt"
        if phys not in present[holder]:
            return "missing"
        return "healthy"

    # ---- diff + repair, page by page, deterministic order
    spent = 0
    refreshed: List[Tuple[str, Tuple[str, ...]]] = []
    for pid in sorted(inventory):
        _blob, provs, length = inventory[pid]
        codec = page_codec(pid)
        try:
            if codec is None:
                result = _scrub_replicated(
                    svc, pid, provs, copy_state, stats, peer,
                    budget_bytes - spent)
            else:
                result = _scrub_ec(
                    svc, pid, codec, provs, length, copy_state, stats,
                    peer, budget_bytes - spent)
        except _REPAIR_ERRORS:
            # a provider died (or a copy changed) mid-repair: leave the
            # page for the next round
            stats["deferred_pages"] += 1
            continue
        if result is None:
            continue
        copies, nbytes, new_locs = result
        spent += nbytes
        stats["repair_bytes"] += nbytes
        if copies:
            stats["repaired_pages"] += 1
            stats["repaired_copies"] += copies
            svc.pm.note_repair(copies, nbytes)
        if new_locs is not None:
            refreshed.append((pid, new_locs))

    # ---- stale-descriptor hygiene: one batched dedup refresh
    if refreshed and getattr(svc.dedup_index, "ever_registered", False):
        svc.dedup_index.refresh_providers(refreshed, peer=peer)
    return stats


def _scrub_replicated(
    svc, pid: str, provs: Tuple[str, ...], copy_state, stats,
    peer: str, budget_left: int,
) -> Optional[Tuple[int, int, Optional[Tuple[str, ...]]]]:
    """Diff + repair one replicated page.  Returns
    ``(copies_restored, bytes_moved, new_locations_or_None)`` or None
    when the page is healthy/lost/deferred (stats updated in place)."""
    overlay = svc.pm.relocated(pid)
    holders = list(overlay) if overlay else list(dict.fromkeys(provs))
    states = {h: copy_state(h, pid) for h in holders}
    healthy = [h for h in holders if states[h] == "healthy"]
    damaged = [h for h in holders if states[h] != "healthy"]
    stats["corrupt_copies"] += sum(
        1 for h in damaged if states[h] == "corrupt")
    stats["missing_copies"] += sum(
        1 for h in damaged if states[h] in ("missing", "dead"))
    if not damaged:
        return None
    stats["damaged_pages"] += 1
    if not healthy:
        stats["losses"].append(pid)
        return None
    # read once (direct, cache-bypass), restore every damaged copy
    src = _provider(svc, healthy[0])
    if src is None:
        stats["deferred_pages"] += 1
        return None
    payload = src.get_page(pid, peer=peer)
    est = len(payload) * (1 + len(damaged))
    if est > budget_left:
        stats["deferred_pages"] += 1
        return None
    new_holders = list(healthy)
    copies = 0
    for h in damaged:
        prov = _provider(svc, h)
        if prov is not None and h in {p.pid for p in svc.pm.alive_providers()}:
            # live holder lost/corrupted the copy: restore it in place
            _restore_copy(svc, prov, pid, payload, peer)
            new_holders.append(h)
        else:
            target = _pick_target(svc, exclude=set(new_holders))
            if target is None:
                continue
            target.put_pages([(pid, payload)], peer=peer)
            new_holders.append(target.pid)
        copies += 1
    if copies == 0:
        stats["deferred_pages"] += 1
        return None
    moved = tuple(new_holders)
    changed = set(moved) != set(dict.fromkeys(provs))
    if changed or overlay:
        svc.pm.record_relocation(pid, moved)
    nbytes = len(payload) * (1 + copies)
    return copies, nbytes, (moved if changed else None)


def _scrub_ec(
    svc, pid: str, codec: Tuple[int, int], provs: Tuple[str, ...],
    length: int, copy_state, stats, peer: str, budget_left: int,
) -> Optional[Tuple[int, int, Optional[Tuple[str, ...]]]]:
    """Diff + repair one erasure-coded page (k data + m parity shards)."""
    k, m = codec
    homes: List[Optional[str]] = [
        provs[j] if j < len(provs) else None for j in range(k + m)]
    serving: Dict[int, str] = {}
    damaged: Dict[int, Optional[str]] = {}
    for j in range(k + m):
        sid = shard_id(pid, j)
        overlay = svc.pm.relocated(sid)
        holder = overlay[0] if overlay else homes[j]
        state = copy_state(holder, sid) if holder else "missing"
        if state == "healthy":
            serving[j] = holder
        else:
            damaged[j] = holder
            if state == "corrupt":
                stats["corrupt_copies"] += 1
            else:
                stats["missing_copies"] += 1
    if not damaged:
        return None
    stats["damaged_pages"] += 1
    if len(serving) < k:
        stats["losses"].append(pid)
        return None
    slen = _shard_bytes(length, k)
    est = k * slen + len(damaged) * slen
    if est > budget_left:
        stats["deferred_pages"] += 1
        return None
    # read any k live shards (direct, cache-bypass), decode, re-encode
    got: List[Tuple[int, bytes]] = []
    read_bytes = 0
    for j in sorted(serving):
        if len(got) >= k:
            break
        prov = _provider(svc, serving[j])
        if prov is None:
            continue
        try:
            raw = prov.get_page(shard_id(pid, j), peer=peer)
        except _REPAIR_ERRORS:
            continue
        got.append((j, raw))
        read_bytes += len(raw)
    if len(got) < k:
        stats["deferred_pages"] += 1
        return None
    payload = ec_decode(got, k, m)
    fresh = ec_encode(payload, k, m)
    new_homes = list(homes)
    for j in serving:
        new_homes[j] = serving[j]
    copies = 0
    written = 0
    alive_pids = {p.pid for p in svc.pm.alive_providers()}
    for j in sorted(damaged):
        sid = shard_id(pid, j)
        holder = damaged[j]
        prov = _provider(svc, holder) if holder else None
        if prov is not None and holder in alive_pids:
            _restore_copy(svc, prov, sid, fresh[j], peer)
            target_pid = holder
        else:
            # shards must stay on distinct providers or parity is void
            exclude = {h for h in new_homes if h} - {holder or ""}
            target = _pick_target(svc, exclude=exclude)
            if target is None:
                continue
            target.put_pages([(sid, fresh[j])], peer=peer)
            target_pid = target.pid
        written += len(fresh[j])
        copies += 1
        new_homes[j] = target_pid
        if target_pid != homes[j]:
            svc.pm.record_relocation(sid, (target_pid,))
    if copies == 0:
        stats["deferred_pages"] += 1
        return None
    moved = tuple(h for h in new_homes if h is not None)
    changed = len(moved) == k + m and list(moved) != list(provs[:k + m])
    return copies, read_bytes + written, (moved if changed else None)


def lifecycle_round(
    svc,
    *,
    budget_bytes: Optional[int] = None,
    peer: str = "lifecycle",
) -> Dict[str, int]:
    """One lifecycle pass: demote aged pages to the cold tier.

    For every blob with a registered lifecycle
    (``BlobSeerService.set_lifecycle``), each physical copy older than
    the blob's ``demote_after`` threshold moves from its hot provider
    to the least-loaded cold endpoint: read direct, put cold, delete
    hot, record the move in the relocation overlay (published
    descriptors are immutable — reads find the cold copy through
    ``ProviderManager.locate`` after the descriptor's replicas miss).
    EC shards demote individually; replicated pages converge to ONE
    cold copy (cold durability is the object store's own).

    The reverse transition (ROADMAP item 1 follow-up): for blobs with a
    ``promote_reads`` threshold (``set_lifecycle(..., promote_reads=N)``)
    a cold page whose served-read tally (``ProviderManager.read_tallies``)
    reached ``N`` moves back to a hot ring owner — repeated access
    un-demotes, so a working set that turns hot again stops paying the
    cold path on every read.  Returns ``{"demoted", "demoted_bytes",
    "promoted", "promoted_bytes", "deferred"}``.
    """
    stats = {"demoted": 0, "demoted_bytes": 0,
             "promoted": 0, "promoted_bytes": 0, "deferred": 0}
    if not svc.lifecycles:
        return stats
    cold_pool = sorted(
        (p for p in svc.pm.all_providers()
         if getattr(p, "tier", "hot") == "cold"
         and not svc.wire.is_down(p.pid)),
        key=lambda p: p.pid)
    if not cold_pool:
        return stats
    blob_of: Dict[str, str] = {}
    for pid, (blob, _provs, _length) in svc.vm.page_locations().items():
        if blob in svc.lifecycles:
            blob_of[pid] = blob
    if not blob_of:
        return stats
    now = svc.clock.now()
    spent = 0
    refreshed: List[Tuple[str, Tuple[str, ...]]] = []
    from repro_torch.core.placement import logical_pid

    for prov in sorted(svc.pm.all_providers(), key=lambda p: p.pid):
        if getattr(prov, "tier", "hot") != "hot" or svc.wire.is_down(prov.pid):
            continue
        try:
            listing = prov.list_pages(peer=peer)
        except EndpointDown:
            continue
        for phys, stored_at in sorted(listing):
            logical = logical_pid(phys)
            blob = blob_of.get(logical)
            if blob is None or now - stored_at < svc.lifecycles[blob]:
                continue
            payload = prov.store.get(phys)
            if payload is None:
                continue
            if budget_bytes is not None and spent + 2 * len(payload) > budget_bytes:
                stats["deferred"] += 1
                continue
            cold = min(cold_pool, key=lambda p: (p.page_count(), p.pid))
            try:
                # demotion is a wire move: read out of the hot endpoint,
                # write into the cold one, then drop the hot copy
                data = prov.get_page(phys, peer=peer)
                cold.put_pages([(phys, data)], peer=peer)
                prov.delete_pages([phys], peer=peer)
            except EndpointDown:
                stats["deferred"] += 1
                continue
            svc.pm.record_relocation(phys, (cold.pid,))
            if phys == logical:  # replicated page: refresh dedup descriptor
                refreshed.append((logical, (cold.pid,)))
            nbytes = 2 * len(data)
            spent += nbytes
            stats["demoted"] += 1
            stats["demoted_bytes"] += nbytes
            svc.pm.note_repair(0, nbytes)

    # ---- cold -> hot promotion on repeated access
    promote_thresholds = getattr(svc, "promote_reads", {})
    if promote_thresholds:
        tallies = svc.pm.read_tallies()
        for cold in cold_pool:
            try:
                listing = cold.list_pages(peer=peer)
            except EndpointDown:
                continue
            for phys, _stored_at in sorted(listing):
                logical = logical_pid(phys)
                blob = blob_of.get(logical)
                threshold = promote_thresholds.get(blob) if blob else None
                if threshold is None or tallies.get(logical, 0) < threshold:
                    continue
                payload = cold.store.get(phys)
                if payload is None:
                    continue
                if budget_bytes is not None and \
                        spent + 2 * len(payload) > budget_bytes:
                    stats["deferred"] += 1
                    continue
                if svc.pm.ring is not None:
                    owners = svc.pm.ring_owners(
                        svc.pm.place_key(logical), 1)
                    target = _provider(svc, owners[0]) if owners else None
                else:
                    target = _pick_target(svc, exclude=set())
                if target is None:
                    stats["deferred"] += 1
                    continue
                try:
                    # promotion mirrors demotion: read cold, write hot,
                    # drop the cold copy, flip the overlay pointer
                    data = cold.get_page(phys, peer=peer)
                    target.put_pages([(phys, data)], peer=peer)
                    cold.delete_pages([phys], peer=peer)
                except EndpointDown:
                    stats["deferred"] += 1
                    continue
                svc.pm.record_relocation(phys, (target.pid,))
                if phys == logical:
                    refreshed.append((logical, (target.pid,)))
                nbytes = 2 * len(data)
                spent += nbytes
                stats["promoted"] += 1
                stats["promoted_bytes"] += nbytes
                svc.pm.note_promotion(1, nbytes)
        # the threshold is "reads since the last lifecycle pass": start
        # the next observation window now, or a once-hot page would
        # re-promote forever on a stale tally
        svc.pm.reset_read_tallies()

    if refreshed and getattr(svc.dedup_index, "ever_registered", False):
        svc.dedup_index.refresh_providers(
            list(dict.fromkeys(refreshed)), peer=peer)
    return stats
