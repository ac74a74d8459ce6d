"""Page math for BlobSeer blobs.

A blob is striped into fixed-size *pages* of ``psize`` bytes (a power of
two, paper §3).  Page ``k`` owns the byte range
``[k * psize, (k + 1) * psize)``.  The metadata segment tree (see
``segment_tree.py``) works in *page units*: a leaf covers exactly one
page, an inner node covers a power-of-two page range.

This module holds the pure range algebra shared by the client, the
version manager and the metadata tree: byte<->page conversion, range
intersection, and the deterministic tree-shape rule that lets any actor
predict which tree nodes an update creates from ``(range, root_pages)``
alone (used by the version manager to hand out border sets for
concurrent, unpublished writers — paper §4.2).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Iterator, Tuple

# ---------------------------------------------------------------------------
# Basic helpers
# ---------------------------------------------------------------------------


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (>=1)."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def pages_spanned(offset: int, size: int, psize: int) -> Tuple[int, int]:
    """Half-open page interval ``[p0, p1)`` touched by byte range."""
    if size == 0:
        p0 = offset // psize
        return (p0, p0)
    return (offset // psize, -(-(offset + size) // psize))


def root_pages_for(size_bytes: int, psize: int) -> int:
    """Page span of the segment-tree root for a blob of ``size_bytes``.

    The root always covers a power-of-two number of pages (paper §4.1
    assumes psize is a power of two and the tree is binary).
    """
    if size_bytes <= 0:
        return 1
    return next_pow2(-(-size_bytes // psize))


def intersects(a0: int, a1: int, b0: int, b1: int) -> bool:
    """Do half-open intervals [a0,a1) and [b0,b1) intersect?"""
    return a0 < b1 and b0 < a1


# ---------------------------------------------------------------------------
# Page range of an update + deterministic tree shape
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class UpdateExtent:
    """Everything the tree shape of one update is determined by.

    ``p0, p1``     half-open page interval the update's *new pages* cover
    ``root_pages`` page span of the update's tree root (power of two)

    The set of tree nodes *created* by an update is exactly: every node
    of the binary tree over ``[0, root_pages)`` whose page range
    intersects ``[p0, p1)`` (paper §4.2 — "the smallest (possibly
    incomplete) binary tree such that its leaves are exactly the leaves
    covering the pages of range that is written").
    """

    p0: int
    p1: int
    root_pages: int

    def creates_node(self, offset: int, size: int) -> bool:
        """Does this update create tree node ``(offset, size)`` (pages)?"""
        if offset + size > self.root_pages:
            return False
        return intersects(offset, offset + size, self.p0, self.p1)

    def intersects_pages(self, offset: int, size: int) -> bool:
        return intersects(offset, offset + size, self.p0, self.p1)


def node_parent(offset: int, size: int) -> Tuple[int, int, bool]:
    """Parent of tree node ``(offset, size)``.

    Returns ``(parent_offset, parent_size, is_left_child)`` following
    Algorithm 4 of the paper: a node is the LEFT child of its parent iff
    ``offset % (2 * size) == 0``.
    """
    if offset % (2 * size) == 0:
        return offset, 2 * size, True
    return offset - size, 2 * size, False


def node_children(offset: int, size: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Children ranges of an inner node: left half, right half."""
    half = size // 2
    return (offset, half), (offset + half, half)


def iter_created_nodes(extent: UpdateExtent) -> Iterator[Tuple[int, int]]:
    """All (offset, size) nodes an update creates, leaves first.

    Mirrors the bottom-up construction of Algorithm 4 (BUILD_META) and
    is used by the version manager to compute partial border sets for
    concurrent writers without touching the DHT.
    """
    seen = set()
    frontier = [(p, 1) for p in range(extent.p0, extent.p1)]
    for node in frontier:
        seen.add(node)
        yield node
    while frontier:
        nxt = []
        for off, size in frontier:
            if size >= extent.root_pages:
                continue
            poff, psize_, _ = node_parent(off, size)
            if (poff, psize_) not in seen:
                seen.add((poff, psize_))
                nxt.append((poff, psize_))
                yield (poff, psize_)
        frontier = nxt


# ---------------------------------------------------------------------------
# Globally unique page ids (paper §3.3 line 5: "pid <- unique page id")
# ---------------------------------------------------------------------------

_pid_counter = itertools.count()
_pid_lock = threading.Lock()
_PID_NAMESPACE = "pg"


def fresh_page_id(tag: str = "") -> str:
    """Globally unique page id.

    A monotone counter + namespace is enough inside one process; a real
    deployment would prefix the client's node id (the paper only
    requires global uniqueness, not structure).

    ``tag`` makes the id self-describing for non-default placements
    (e.g. ``"ec6+2"`` marks an erasure-coded page; see
    ``repro.core.placement``): every metadata layer carries the id
    opaquely, only the provider manager interprets the suffix.
    """
    with _pid_lock:
        n = next(_pid_counter)
    base = f"{_PID_NAMESPACE}-{n:012x}"
    return f"{base}-{tag}" if tag else base
