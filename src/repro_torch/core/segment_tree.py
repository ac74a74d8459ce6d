"""The distributed versioned segment tree (paper §4).

Each snapshot version ``v`` of a blob has a *virtual* binary segment
tree over the page range ``[0, root_pages(v))``.  A node is keyed by
``(owner_blob, version, offset, size)`` (offset/size in pages); inner
nodes store the versions of their two children (``vl``, ``vr``), leaves
store the page id and its replica providers.  Trees of successive
snapshots share every subtree whose range does not intersect the update
that produced the newer snapshot — the "weaving" of new metadata with
old metadata that gives copy-on-write versioning.

This module implements, faithfully:

* ``read_meta``  — Algorithm 3 (READ_META): descend from the snapshot
  root, explore children intersecting the requested range, collect page
  descriptors from the leaves.
* ``build_meta`` — Algorithm 4 (BUILD_META): build the new tree
  bottom-up from the freshly written leaves, wiring border children
  (subtrees outside the update range) to the versions resolved by a
  :class:`BorderResolver`.
* ``BorderResolver`` — §4.2's two-source border lookup: ranges touched
  by *concurrent, not-yet-published* updates are resolved from the
  version manager's in-flight registry (handed to the writer at version
  assignment), everything else by descending the latest *published*
  snapshot's tree with ``GET_NODE``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.dht import MetadataDHT
from repro_torch.core.pages import (
    UpdateExtent,
    intersects,
    iter_created_nodes,
    node_children,
    node_parent,
)

# A node key in the DHT: (owner_blob_id, version, page_offset, page_size).
NodeKey = Tuple[str, int, int, int]

# Resolves a version number to the blob id that owns its tree nodes.
# Branch lineage: versions <= branch point belong to the ancestor blob.
OwnerFn = Callable[[int], str]


@dataclass(frozen=True)
class InnerNode:
    """Inner tree node: versions of the left/right children.

    ``None`` marks a child range that has never been written (it lies
    beyond the blob's size inside the power-of-two root range); READ
    never descends there because reads are bounds-checked upfront.
    """

    vl: Optional[int]
    vr: Optional[int]


@dataclass(frozen=True)
class LeafNode:
    """Leaf: one page. ``providers`` lists the replica endpoints."""

    page_id: str
    providers: Tuple[str, ...]
    length: int  # actual stored bytes (the blob's last page may be short)


@dataclass(frozen=True)
class PageDescriptor:
    """Element of the PD set of Algorithms 1/2."""

    page_index: int  # absolute page number within the blob
    page_id: str
    providers: Tuple[str, ...]
    length: int


class MetadataMissing(RuntimeError):
    """A tree node expected to exist was not found in the DHT."""


def _get_many(dht, keys: List[NodeKey], peer: Optional[str]):
    """Batched node fetch; falls back to per-key gets for plain dicts
    or other stores without a ``get_many``."""
    getter = getattr(dht, "get_many", None)
    if getter is None:
        return {key: dht.get(key, peer=peer) for key in keys}
    return getter(keys, peer=peer)


# ---------------------------------------------------------------------------
# Algorithm 3 — READ_META
# ---------------------------------------------------------------------------


def read_meta(
    dht: MetadataDHT,
    owner_of: OwnerFn,
    version: int,
    root_pages: int,
    p0: int,
    p1: int,
    peer: Optional[str] = None,
) -> List[PageDescriptor]:
    """Collect page descriptors covering pages ``[p0, p1)`` of a snapshot.

    Faithful to Algorithm 3 (explore exactly the subtrees whose range
    intersects the requested range), but traversed *level-synchronously*:
    the whole frontier of one tree level is fetched with a single
    ``get_many`` (one batched round trip per touched shard), so a read
    costs at most ``depth + 1`` latency waves instead of one serial DHT
    round trip per visited node.  Every update creates its own root, so
    the snapshot root is node ``(version, 0, root_pages)``.
    """
    if p0 >= p1:
        return []
    out: List[PageDescriptor] = []
    frontier: List[Tuple[int, int, int]] = [(version, 0, root_pages)]
    while frontier:
        keys = [(owner_of(v), v, off, size) for v, off, size in frontier]
        nodes = _get_many(dht, keys, peer)
        nxt: List[Tuple[int, int, int]] = []
        for (v, off, size), key in zip(frontier, keys):
            node = nodes.get(key)
            if node is None:
                raise MetadataMissing(f"node v={v} range=({off},{size})")
            if isinstance(node, LeafNode):
                out.append(PageDescriptor(off, node.page_id, node.providers,
                                          node.length))
                continue
            (lo, ls), (ro, rs) = node_children(off, size)
            if node.vl is not None and intersects(lo, lo + ls, p0, p1):
                nxt.append((node.vl, lo, ls))
            if node.vr is not None and intersects(ro, ro + rs, p0, p1):
                nxt.append((node.vr, ro, rs))
        frontier = nxt
    out.sort(key=lambda d: d.page_index)
    return out


# ---------------------------------------------------------------------------
# §4.2 — border-set resolution
# ---------------------------------------------------------------------------


def border_ranges(extent: UpdateExtent) -> List[Tuple[int, int]]:
    """Every border range BUILD_META will ask a resolver for, upfront.

    An update creates exactly the tree nodes whose range intersects its
    page extent (``pages.iter_created_nodes``); the *border set* is the
    sibling range of every created node whose sibling the update does
    NOT create.  Both facts are pure tree-shape math on
    ``(p0, p1, root_pages)`` — no DHT traffic — which is why the
    version manager's :class:`~repro.core.version_manager.AssignInfo`
    is enough context for a writer to call
    :meth:`BorderResolver.prefetch` on this set *before* the weave
    starts: all levels' border descents then run as ONE level-batched
    ``resolve_many`` cohort (≤ depth waves total) instead of one cohort
    per tree level, and ``build_meta``'s own lookups become pure cache
    hits.
    """
    out: List[Tuple[int, int]] = []
    for off, size in iter_created_nodes(extent):
        if size >= extent.root_pages:
            continue  # the root has no sibling
        p_off, p_size, is_left = node_parent(off, size)
        (lo, ls), (ro, rs) = node_children(p_off, p_size)
        sib = (ro, rs) if is_left else (lo, ls)
        if not extent.creates_node(*sib):
            out.append(sib)
    return list(dict.fromkeys(out))


_DESCEND = object()  # sentinel: border range needs a published-tree descent


class BorderResolver:
    """Resolve the snapshot version owning any range outside the update.

    ``recent_updates``: every update with version in ``(vp, vw)``
    — published or not by now — as ``(version, p0, p1)``, newest first.
    This is exactly the information the version manager registers at
    version-assignment time (paper §4.2: the VM "will build the partial
    set of border nodes and provide it to the writer"); ranges touched
    by it resolve locally with zero DHT traffic, which is also what
    makes burst writers (``BlobClient.append_many``) weave against
    their own in-flight versions for free.

    ``vp``/``vp_root_pages``: a recently published snapshot used to
    resolve all remaining border ranges by descending its tree.
    Descents are level-batched and shared across the cohort
    (:meth:`resolve_many`); the pipelined write path calls
    :meth:`prefetch` with :func:`border_ranges` so the whole update's
    border set costs ≤ tree-depth batched waves, resolved before
    BUILD_META starts.  Results are cached for the resolver's lifetime
    (one update), so repeated lookups are free.
    """

    def __init__(
        self,
        dht: MetadataDHT,
        owner_of: OwnerFn,
        recent_updates: Sequence[Tuple[int, int, int]],
        vp: Optional[int],
        vp_root_pages: int,
        peer: Optional[str] = None,
    ) -> None:
        self.dht = dht
        self.owner_of = owner_of
        self.recent = sorted(recent_updates, key=lambda r: -r[0])
        self.vp = vp
        self.vp_root_pages = vp_root_pages
        self.peer = peer
        self._cache: Dict[Tuple[int, int], Optional[int]] = {}

    def resolve(self, off: int, size: int) -> Optional[int]:
        """Version of the node covering pages ``[off, off+size)``.

        Highest version < vw whose update range intersects the node
        range; ``None`` if the range was never written.
        """
        return self.resolve_many([(off, size)])[(off, size)]

    def prefetch(self, ranges: Sequence[Tuple[int, int]]) -> None:
        """Warm the resolver for every range BUILD_META will need.

        ``ranges`` is normally :func:`border_ranges` of the update's
        extent — computable from the :class:`AssignInfo` alone, before
        any page store or metadata put.  All published-tree descents
        run as one level-batched :meth:`resolve_many` cohort (shared
        ``get_many`` waves, ≤ tree depth rounds for the *entire* border
        set), after which ``build_meta``'s per-level lookups are pure
        cache hits — the weave pays zero border round trips of its own.
        """
        if ranges:
            self.resolve_many(ranges)

    def resolve_many(
        self, ranges: Sequence[Tuple[int, int]]
    ) -> Dict[Tuple[int, int], Optional[int]]:
        """Resolve many border ranges with shared batched descents.

        All ranges that need the published tree descend it together,
        level-synchronously: at each step the distinct nodes the whole
        cohort needs are fetched with one ``get_many`` (targets sitting
        on the same node share a single key), so one BUILD_META level's
        border set costs at most ``depth`` batched rounds — not one
        serial descent per border node.
        """
        out: Dict[Tuple[int, int], Optional[int]] = {}
        # position of each still-descending target in the published tree
        pos: Dict[Tuple[int, int], Tuple[int, int, int]] = {}
        for key in dict.fromkeys(ranges):
            if key in self._cache:
                out[key] = self._cache[key]
                continue
            off, size = key
            v = self._resolve_local(off, size)
            if v is not _DESCEND:
                self._cache[key] = v
                out[key] = v
                continue
            pos[key] = (self.vp, 0, self.vp_root_pages)

        while pos:
            done = [k for k, (v, o, s) in pos.items() if (o, s) == k]
            for k in done:
                v = pos.pop(k)[0]
                self._cache[k] = v
                out[k] = v
            if not pos:
                break
            keys = list(dict.fromkeys(
                (self.owner_of(v), v, o, s) for v, o, s in pos.values()
            ))
            nodes = _get_many(self.dht, keys, self.peer)
            for target, (v, o, s) in list(pos.items()):
                node = nodes.get((self.owner_of(v), v, o, s))
                if node is None:
                    raise MetadataMissing(f"border descent v={v} range=({o},{s})")
                if isinstance(node, LeafNode):
                    raise MetadataMissing(
                        f"border descent hit leaf above target range {target}"
                    )
                off, size = target
                (lo, ls), (ro, rs) = node_children(o, s)
                if off >= lo and off + size <= lo + ls:
                    v, o, s = node.vl, lo, ls
                elif off >= ro and off + size <= ro + rs:
                    v, o, s = node.vr, ro, rs
                else:
                    raise MetadataMissing(
                        f"range ({off},{size}) not aligned under ({o},{s})"
                    )
                if v is None:
                    del pos[target]
                    self._cache[target] = None
                    out[target] = None
                else:
                    pos[target] = (v, o, s)
        return out

    def _resolve_local(self, off: int, size: int):
        """Resolve without DHT traffic; ``_DESCEND`` if the published
        tree must be consulted."""
        # 1. concurrent / recent updates (registry info, no DHT traffic)
        for u, q0, q1 in self.recent:
            if intersects(off, off + size, q0, q1):
                return u
        # 2. descend the published tree
        if self.vp is None:
            return None
        if off + size > self.vp_root_pages:
            # Beyond the published root and not touched by any recent
            # update: never written.
            return None
        return _DESCEND


# ---------------------------------------------------------------------------
# Algorithm 4 — BUILD_META
# ---------------------------------------------------------------------------


def build_meta(
    dht: MetadataDHT,
    owner_of: OwnerFn,
    vw: int,
    root_pages: int,
    leaves: Sequence[PageDescriptor],
    border: BorderResolver,
    peer: Optional[str] = None,
) -> int:
    """Build + store the tree for snapshot ``vw``; returns #nodes written.

    Bottom-up construction per Algorithm 4: start from the new leaves,
    create each parent once, wiring the child on the update side to
    ``vw`` and the other child to the version resolved by ``border``.
    Each level first *collects* every unresolved border range and hands
    them to ``border.resolve_many`` as one cohort (shared batched
    descents), instead of one serial descent per border node; a caller
    that already ran ``border.prefetch(border_ranges(extent))`` (the
    pipelined write path — see ``BlobClient._update``) pays zero border
    round trips here, because every per-level cohort hits the
    resolver's cache.  All nodes are then written to the DHT in one
    ``put_many`` (the paper writes them in parallel; under a virtual
    clock the per-shard batches genuinely overlap).
    """
    if not leaves:
        raise ValueError("update with no pages")
    blob = owner_of(vw)
    nodes: Dict[Tuple[int, int], object] = {}
    for d in leaves:
        nodes[(d.page_index, 1)] = LeafNode(d.page_id, tuple(d.providers), d.length)

    frontier = sorted(nodes.keys())
    while frontier:
        # Plan this level: which parents to create, which of their
        # children the update supplies (the rest are border ranges).
        plans: Dict[Tuple[int, int], List[bool]] = {}  # pkey -> [has_l, has_r]
        for off, size in frontier:
            if size >= root_pages:
                continue  # reached the root
            if off % (2 * size) == 0:
                p_off, p_size, pos_left = off, 2 * size, True
            else:
                p_off, p_size, pos_left = off - size, 2 * size, False
            plan = plans.setdefault((p_off, p_size), [False, False])
            plan[0 if pos_left else 1] = True

        need: List[Tuple[int, int]] = []
        for (p_off, p_size), (has_l, has_r) in plans.items():
            (lo, ls), (ro, rs) = node_children(p_off, p_size)
            if has_l and not has_r:
                need.append((ro, rs))
            elif has_r and not has_l:
                need.append((lo, ls))
        resolved = border.resolve_many(need)

        nxt: List[Tuple[int, int]] = []
        for pkey in sorted(plans):
            has_l, has_r = plans[pkey]
            (lo, ls), (ro, rs) = node_children(*pkey)
            nodes[pkey] = InnerNode(
                vl=vw if has_l else resolved[(lo, ls)],
                vr=vw if has_r else resolved[(ro, rs)],
            )
            nxt.append(pkey)
        frontier = nxt

    if (0, root_pages) not in nodes:
        raise AssertionError("BUILD_META did not reach the root")

    # "write N to the metadata provider" for all nodes in parallel
    # (Alg 4 line 34): batched per home shard.
    dht.put_many(
        [((blob, vw, off, size), node) for (off, size), node in nodes.items()],
        peer=peer,
    )
    return len(nodes)
