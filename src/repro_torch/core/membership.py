"""Elastic membership: online provider join/drain and flash-crowd relief.

The paper's deployments are static — "we deploy ... on the other
nodes" (§5) fixes the fleet before the first write.  This module makes
the data-provider fleet elastic on top of the consistent-hash ring
(:class:`~repro.core.placement.HashRing`, wired into
``ProviderManager``):

* **Join** (:func:`join_provider` + :func:`build_join_plan`): the new
  member enters the ring immediately (new pages place onto it from the
  next allocation), then receives exactly the already-stored pages
  whose ring owner set it now contains — nothing else moves, so the
  transfer volume stays at the consistent-hash minimum (~pages/n).

* **Drain** (:func:`start_drain` / :func:`finish_drain`): the member
  leaves the placement pool at once (``ProviderManager.mark_draining``)
  but keeps serving reads; every live copy it holds is pushed to that
  page's next ring owner, a final straggler sweep re-lists the store,
  and only then does the member deregister (``finish_drain`` marks it
  ``_departed`` so later GC sweeps know its copies died clean) — zero
  failed ops end to end.

Both directions run as **budget-capped rounds**
(:func:`migration_round` / :func:`run_migration`) concurrently with
client reads and writes: the old holder serves a page until its move
lands, and the per-page "configuration pointer flip" is the relocation
overlay entry (``ProviderManager.record_relocation``) the read path
already consults — the ARES fragmented-transfer scheme
(arXiv:2201.13292) applied to the data plane, where descriptors rather
than the ring route reads.  Every move is wire-accounted (payload read
+ payload write + ``MIGRATE_PAGE_CMD_BYTES`` framing) and refreshes the
dedup index so content-hash hits never hand out a drained endpoint.

:func:`mitigate_flash_crowd` is the load-side twin: when the per-page
read tallies (``ProviderManager.read_tallies``) show a hot page, its
replica set widens onto the next ring owners
(``ProviderManager.widen_page``) so the replica load balancer can
spread the crowd.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.placement import (
    logical_pid,
    page_codec,
    shard_id,
    split_shard,
    stable_hash,
)
from repro_torch.core.transport import MIGRATE_PAGE_CMD_BYTES, EndpointDown

#: Default per-round byte budget: a handful of 64 KiB pages per round,
#: so rebalancing converges over rounds instead of bursting and
#: starving client traffic (mirrors durability.DEFAULT_SCRUB_BUDGET).
DEFAULT_MIGRATION_BUDGET = 8 * 1024 * 1024


@dataclass(frozen=True)
class Move:
    """One planned page-copy transfer.

    ``phys`` is the store id that moves (the logical page id for
    replicated pages, a positional ``.sN`` shard id for EC pages);
    ``src`` the holder that loses the copy once it lands (``""`` when
    the move only widens the holder set); ``read_from`` the holders the
    payload may be read out of, busiest-last; ``new_holders`` the full
    holder tuple recorded in the relocation overlay after the move.
    """

    logical: str
    phys: str
    src: str
    dst: str
    read_from: Tuple[str, ...]
    new_holders: Tuple[str, ...]


def _plan_order(svc, move: Move) -> Tuple[int, str]:
    """Deterministic plan order: ring position first (arcs transfer in
    ring order, like the DHT's), physical id as tie-break."""
    return stable_hash(svc.pm.place_key(move.logical)), move.phys


def _holders(svc, phys: str, journaled: Sequence[str]) -> List[str]:
    overlay = svc.pm.relocated(phys)
    return list(overlay) if overlay else list(dict.fromkeys(journaled))


def _cold_pids(svc) -> set:
    return {p.pid for p in svc.pm.all_providers()
            if getattr(p, "tier", "hot") == "cold"}


def _shard_holder(svc, lpid: str, j: int,
                  journaled: Sequence[str]) -> Optional[str]:
    sid = shard_id(lpid, j)
    overlay = svc.pm.relocated(sid)
    if overlay:
        return overlay[0]
    return journaled[j] if j < len(journaled) else None


def build_join_plan(svc, joining: str) -> List[Move]:
    """Every already-stored live page the ring now assigns to
    ``joining``: exactly the consistent-hash minimum transfer set."""
    cold = _cold_pids(svc)
    moves: List[Move] = []
    for lpid, (_blob, provs, _length) in sorted(
            svc.vm.page_locations().items()):
        codec = page_codec(lpid)
        width = len(dict.fromkeys(provs)) if codec is None else sum(codec)
        desired = svc.pm.ring_owners(svc.pm.place_key(lpid), width)
        if joining not in desired:
            continue
        if codec is None:
            holders = _holders(svc, lpid, provs)
            if joining in holders or set(holders) & cold:
                continue  # already landed / lifecycle owns cold pages
            lost = [h for h in holders if h not in desired]
            src = lost[0] if lost else ""
            new_holders = tuple(h for h in holders if h != src) + (joining,)
            moves.append(Move(lpid, lpid, src, joining,
                              tuple(holders), new_holders))
        else:
            j = desired.index(joining)
            holder = _shard_holder(svc, lpid, j, provs)
            if holder is None or holder == joining or holder in cold:
                continue
            moves.append(Move(lpid, shard_id(lpid, j), holder, joining,
                              (holder,), (joining,)))
    moves.sort(key=lambda m: _plan_order(svc, m))
    return moves


def build_drain_plan(svc, draining: str) -> List[Move]:
    """Every live copy the draining member still holds, paired with the
    ring owner that takes it over.  ``mark_draining`` must already have
    run — the ring no longer offers the draining member, so
    ``ring_owners`` resolves each page's next home directly."""
    inventory = svc.vm.page_locations()
    prov = svc.pm.get(draining)
    listing = prov.list_pages(peer="migrator")
    moves: List[Move] = []
    for phys, _at in sorted(listing):
        lpid = logical_pid(phys)
        rec = inventory.get(lpid)
        if rec is None:
            continue  # garbage pending sweep: dies with the member
        _blob, provs, _length = rec
        codec = page_codec(lpid)
        width = len(dict.fromkeys(provs)) if codec is None else sum(codec)
        desired = svc.pm.ring_owners(svc.pm.place_key(lpid), width)
        if codec is None:
            holders = _holders(svc, lpid, provs)
            if draining not in holders:
                continue  # an overlay move already superseded this copy
            keep = [h for h in holders if h != draining]
            dst = next((d for d in desired if d not in keep), None)
            if dst is None:
                pool = sorted(
                    (p for p in svc.pm.placement_pool()
                     if p.pid not in keep),
                    key=lambda p: (p.page_count(), p.pid))
                dst = pool[0].pid if pool else None
            if dst is None:
                continue  # nowhere to go; straggler sweep retries
            moves.append(Move(lpid, phys, draining, dst,
                              tuple(holders), tuple(keep) + (dst,)))
        else:
            split = split_shard(phys)
            if split is None:
                continue
            j = split[1]
            if _shard_holder(svc, lpid, j, provs) != draining:
                continue
            exclude = {h for jj in range(width)
                       for h in (_shard_holder(svc, lpid, jj, provs),)
                       if h is not None and jj != j}
            dst = next((d for d in desired if d not in exclude), None)
            if dst is None:
                continue
            moves.append(Move(lpid, phys, draining, dst,
                              (draining,), (dst,)))
    moves.sort(key=lambda m: _plan_order(svc, m))
    return moves


def migration_round(
    svc,
    plan: List[Move],
    *,
    budget_bytes: int = DEFAULT_MIGRATION_BUDGET,
    peer: str = "migrator",
) -> Dict[str, int]:
    """Execute moves off the front of ``plan`` (mutated in place) until
    the byte budget is spent.

    Each move: read the payload from a live holder (the old owner keeps
    serving clients throughout), write it to the new owner with
    ``MIGRATE_PAGE_CMD_BYTES`` framing, flip the page's configuration
    pointer (``record_relocation``), then delete the superseded copy.
    A move whose holders are all unreachable is deferred to the back of
    the plan.  At least one move executes per round even when it alone
    exceeds the budget, so progress is guaranteed.  Returns round
    stats; ``plan`` empty means the transfer phase is complete.
    """
    stats = {"moves": 0, "bytes": 0, "payload_bytes": 0, "deferred": 0,
             "remaining": 0}
    spent = 0
    deferred: List[Move] = []
    refreshed: List[Tuple[str, Tuple[str, ...]]] = []
    while plan:
        move = plan[0]
        payload = None
        for holder in move.read_from:
            try:
                payload = svc.pm.get(holder).get_page(move.phys, peer=peer)
                break
            except (EndpointDown, KeyError):
                continue
        if payload is None:
            plan.pop(0)
            deferred.append(move)
            stats["deferred"] += 1
            continue
        cost = 2 * len(payload) + MIGRATE_PAGE_CMD_BYTES
        if spent and spent + cost > budget_bytes:
            break
        plan.pop(0)
        try:
            dst = svc.pm.get(move.dst)
            svc.wire.transfer(move.dst, MIGRATE_PAGE_CMD_BYTES,
                              inbound=True, peer=peer, async_peer=True)
            if not dst.has_page(move.phys):
                dst.put_pages([(move.phys, payload)], peer=peer)
        except (EndpointDown, KeyError):
            deferred.append(move)
            stats["deferred"] += 1
            continue
        svc.pm.record_relocation(move.phys, move.new_holders)
        if move.src:
            try:
                svc.pm.get(move.src).delete_pages([move.phys], peer=peer)
            except (EndpointDown, KeyError):
                pass  # descriptor still lists src; GC sweeps it later
        if move.phys == move.logical:
            refreshed.append((move.logical, move.new_holders))
        spent += cost
        stats["moves"] += 1
        stats["bytes"] += cost
        stats["payload_bytes"] += len(payload)
        svc.pm.note_migration(1, cost, payload_bytes=len(payload))
    plan.extend(deferred)
    stats["remaining"] = len(plan)
    if refreshed and getattr(svc.dedup_index, "ever_registered", False):
        svc.dedup_index.refresh_providers(
            list(dict.fromkeys(refreshed)), peer=peer)
    return stats


def run_migration(
    svc,
    plan: List[Move],
    *,
    budget_bytes: int = DEFAULT_MIGRATION_BUDGET,
    round_sleep: float = 0.0,
    max_rounds: int = 10_000,
    peer: str = "migrator",
) -> Dict[str, int]:
    """Drive :func:`migration_round` until the plan drains (or only
    unreachable-holder moves remain).  ``round_sleep`` yields simulated
    time between rounds so client traffic interleaves with the
    transfer."""
    total = {"moves": 0, "bytes": 0, "payload_bytes": 0, "rounds": 0,
             "deferred": 0}
    for _ in range(max_rounds):
        if not plan:
            break
        stats = migration_round(svc, plan, budget_bytes=budget_bytes,
                                peer=peer)
        total["rounds"] += 1
        total["moves"] += stats["moves"]
        total["bytes"] += stats["bytes"]
        total["payload_bytes"] += stats["payload_bytes"]
        if stats["moves"] == 0 and stats["remaining"]:
            # every remaining move is deferred (holders unreachable);
            # leave them for a later call rather than spinning
            total["deferred"] = stats["remaining"]
            break
        if round_sleep and plan:
            svc.clock.sleep(round_sleep)
    return total


# --------------------------------------------------------------- orchestration
def join_provider(svc, pid: str, tier: str = "hot") -> List[Move]:
    """Register a new member and return its rebalance plan (run it with
    :func:`run_migration`).  The member starts taking *new* pages the
    moment this returns; the plan moves the already-stored pages the
    ring now assigns to it."""
    svc.add_provider(pid, tier=tier)
    svc.pm.announce_join(pid)
    if tier != "hot" or svc.pm.ring is None:
        return []  # cold members take no ring placement, nothing to move
    return build_join_plan(svc, pid)


def start_drain(svc, pid: str) -> List[Move]:
    """Take ``pid`` out of placement (it keeps serving reads) and
    return the transfer-out plan.  Refused when the remaining hot fleet
    could no longer hold ``replication`` distinct copies — the same
    floor the metadata ring enforces on ``begin_drain``."""
    prov = svc.pm.get(pid)   # KeyError for unknown members, like the DHT
    if getattr(prov, "tier", "hot") == "hot":
        hot = [p.pid for p in svc.pm.all_providers()
               if getattr(p, "tier", "hot") == "hot"
               and p.pid not in svc.pm._draining]
        remaining = len([h for h in hot if h != pid])
        if remaining < svc.pm.replication:
            raise RuntimeError(
                f"draining {pid} would leave {remaining} hot providers, "
                f"fewer than the {svc.pm.replication}-way replication "
                f"floor")
    svc.pm.mark_draining(pid)
    return build_drain_plan(svc, pid)


def finish_drain(svc, pid: str, *, peer: str = "migrator",
                 max_sweeps: int = 16) -> int:
    """Straggler sweep + deregistration: re-plan until the member holds
    no live copy (writes that raced the main transfer), then mark it
    departed.  Returns the number of straggler moves."""
    stragglers = 0
    for _ in range(max_sweeps):
        plan = build_drain_plan(svc, pid)
        if not plan:
            svc.pm.finish_drain(pid)
            return stragglers
        done = run_migration(svc, plan, peer=peer)
        stragglers += done["moves"]
        if done["moves"] == 0:
            break
    raise RuntimeError(
        f"drain of {pid} cannot complete: live copies remain with no "
        f"reachable source or destination")


def drain_provider(svc, pid: str, *,
                   budget_bytes: int = DEFAULT_MIGRATION_BUDGET,
                   round_sleep: float = 0.0,
                   peer: str = "migrator") -> Dict[str, int]:
    """Full drain in one call: plan, budgeted transfer, straggler
    sweep, deregister."""
    plan = start_drain(svc, pid)
    total = run_migration(svc, plan, budget_bytes=budget_bytes,
                          round_sleep=round_sleep, peer=peer)
    total["stragglers"] = finish_drain(svc, pid, peer=peer)
    return total


# ----------------------------------------------------------------- flash crowd
def mitigate_flash_crowd(
    svc,
    *,
    threshold: int = 32,
    extra: int = 1,
    blob_id: Optional[str] = None,
    peer: str = "balancer",
) -> List[Tuple[str, Tuple[str, ...]]]:
    """Widen the replica set of every page whose served-read tally
    crossed ``threshold`` (see ``ProviderManager.hot_pages``) onto its
    next ``extra`` ring owners.  ``blob_id`` scopes the pass to one
    blob's pages.  Returns ``(page_id, new_holders)`` per widened page.
    Call periodically (scenario/monitor cadence); the tallies reset so
    each interval's crowd is judged on its own."""
    hot = svc.pm.hot_pages(threshold)
    if not hot:
        return []
    inventory = svc.vm.page_locations()
    widened: List[Tuple[str, Tuple[str, ...]]] = []
    for lpid, _count in hot:
        rec = inventory.get(lpid)
        if rec is None or page_codec(lpid) is not None:
            continue  # EC pages already spread shard load k+m wide
        if blob_id is not None and rec[0] != blob_id:
            continue
        holders = _holders(svc, lpid, rec[1])
        got = svc.pm.widen_page(lpid, holders, extra=extra, peer=peer)
        if got:
            widened.append((lpid, got))
    if widened:
        # widened copies are real holders: refresh the dedup index so a
        # later content hit hands out the full (spread) replica set,
        # not the pre-crowd tuple (same fix as the migration path)
        svc.dedup_index.refresh_providers(list(widened), peer=peer)
    svc.pm.reset_read_tallies()
    return widened
