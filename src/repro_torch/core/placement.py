"""Page placement policies: N-way replication and Reed-Solomon erasure
coding.

The paper buys availability with plain replication and never costs it:
``rep:3`` pays 3x the logical bytes for tolerance of 2 losses.  A
Reed-Solomon code ``ec:k+m`` stripes each page into ``k`` data shards
plus ``m`` parity shards on ``k+m`` *distinct* providers and tolerates
any ``m`` losses at ``(k+m)/k`` overhead — 1.33x for the default
``ec:6+2`` versus 3x for the replication twin (SNIPPETS.md §1-2's
trade-off).  Policies are selected **per blob**
(``BlobSeerService.set_blob_placement``) and ride the existing
descriptor format unchanged:

* An erasure-coded page's id is self-describing: ``fresh_page_id`` tags
  it ``pg-<hex>-ec6+2``, so every layer (DHT descriptors, WAL records,
  dedup index, GC sweep) carries plain ``(pid, providers, length)``
  tuples and only the provider manager interprets the codec.
* Shard ``j`` of page ``pid`` is stored under the physical id
  ``f"{pid}.s{j}"`` on ``descriptor.providers[j]`` — the provider group
  is *positional* for EC pages.
* Each shard carries a small header (:data:`SHARD_HDR_BYTES`) encoding
  the code geometry and the page's logical length, so a decoder needs
  nothing but ``k`` surviving shards.

The arithmetic is GF(256) (polynomial 0x11d) with log/exp tables and a
**Cauchy** generator matrix: ``G = [I_k ; C]`` where
``C[i][j] = 1 / (x_i ^ y_j)`` over distinct ``x_i = k + i`` (parity
rows) and ``y_j = j`` (data columns).  Every k-row subset of ``G`` is
invertible (Cauchy minors are nonzero), so *any* ``k`` surviving shards
reconstruct the page — a plain Vandermonde block under an identity does
not have this property in GF(256).  Encode/decode are numpy-vectorized
table lookups; matrix inversion is a tiny (<= k x k) Gaussian
elimination in pure Python.
"""

from __future__ import annotations

import bisect
import hashlib
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

# --------------------------------------------------------------- GF(256)
_GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1, the classic RS field

_GF_EXP = np.zeros(512, dtype=np.uint8)
_GF_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _GF_EXP[_i] = _x
    _GF_LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _GF_POLY
for _i in range(255, 512):
    _GF_EXP[_i] = _GF_EXP[_i - 255]


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_GF_EXP[int(_GF_LOG[a]) + int(_GF_LOG[b])])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of 0")
    return int(_GF_EXP[255 - int(_GF_LOG[a])])


def _gf_mul_vec(c: int, v: np.ndarray) -> np.ndarray:
    """Scalar x vector product in GF(256), vectorized via the log table."""
    if c == 0:
        return np.zeros_like(v)
    if c == 1:
        return v.copy()
    logs = _GF_LOG[v.astype(np.int32)] + int(_GF_LOG[c])
    out = _GF_EXP[logs]
    return np.where(v == 0, 0, out).astype(np.uint8)


def _cauchy_rows(k: int, m: int) -> List[List[int]]:
    """The m parity rows C[i][j] = inv(x_i ^ y_j), x_i = k+i, y_j = j."""
    return [[gf_inv((k + i) ^ j) for j in range(k)] for i in range(m)]


def _generator(k: int, m: int) -> List[List[int]]:
    """(k+m) x k generator [I_k ; C]: row r is shard r's data coefficients."""
    rows = [[1 if c == r else 0 for c in range(k)] for r in range(k)]
    rows.extend(_cauchy_rows(k, m))
    return rows


def _gf_solve(rows: List[List[int]], k: int) -> List[List[int]]:
    """Invert a k x k GF(256) matrix by Gaussian elimination (k <= 16)."""
    aug = [list(rows[i]) + [1 if j == i else 0 for j in range(k)]
           for i in range(k)]
    for col in range(k):
        piv = next((r for r in range(col, k) if aug[r][col] != 0), None)
        if piv is None:
            raise ValueError("singular shard matrix")  # unreachable: Cauchy
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = gf_inv(aug[col][col])
        aug[col] = [gf_mul(inv, v) for v in aug[col]]
        for r in range(k):
            if r != col and aug[r][col]:
                f = aug[r][col]
                aug[r] = [a ^ gf_mul(f, b) for a, b in zip(aug[r], aug[col])]
    return [row[k:] for row in aug]


# ------------------------------------------------------------ shard format
SHARD_MAGIC = b"ECS1"
SHARD_HDR_BYTES = 16  # magic(4) + k(1) + m(1) + index(1) + pad(1) + L(8 LE)


def _shard_header(k: int, m: int, index: int, length: int) -> bytes:
    return (SHARD_MAGIC + bytes([k, m, index, 0])
            + length.to_bytes(8, "little"))


def parse_shard_header(shard: bytes) -> Tuple[int, int, int, int]:
    """Return ``(k, m, index, logical_length)``; raises on a bad header."""
    if len(shard) < SHARD_HDR_BYTES or shard[:4] != SHARD_MAGIC:
        raise ValueError("not an EC shard")
    k, m, index = shard[4], shard[5], shard[6]
    length = int.from_bytes(shard[8:16], "little")
    return k, m, index, length


def ec_encode(payload: bytes, k: int, m: int) -> List[bytes]:
    """Encode ``payload`` into ``k + m`` self-describing shards."""
    L = len(payload)
    slen = max(1, -(-L // k))  # ceil; >=1 so empty-ish pages still shard
    buf = np.zeros(k * slen, dtype=np.uint8)
    buf[:L] = np.frombuffer(payload, dtype=np.uint8)
    data = buf.reshape(k, slen)
    shards: List[bytes] = []
    for j in range(k):
        shards.append(_shard_header(k, m, j, L) + data[j].tobytes())
    for i, row in enumerate(_cauchy_rows(k, m)):
        acc = np.zeros(slen, dtype=np.uint8)
        for j, coef in enumerate(row):
            acc ^= _gf_mul_vec(coef, data[j])
        shards.append(_shard_header(k, m, k + i, L) + acc.tobytes())
    return shards


def ec_decode(shards: Sequence[Tuple[int, bytes]], k: int, m: int) -> bytes:
    """Reconstruct the page from any ``k`` of its shards.

    ``shards`` holds ``(shard_index, shard_bytes)`` pairs (header
    included).  Raises :class:`ValueError` when fewer than ``k``
    distinct shards are supplied or a header disagrees.
    """
    by_index = {}
    length = None
    for idx, raw in shards:
        hk, hm, hidx, hlen = parse_shard_header(raw)
        if (hk, hm) != (k, m) or hidx != idx:
            raise ValueError(f"shard header mismatch for index {idx}")
        if length is None:
            length = hlen
        elif length != hlen:
            raise ValueError("shards disagree on logical length")
        by_index.setdefault(idx, raw[SHARD_HDR_BYTES:])
    if length is None or len(by_index) < k:
        raise ValueError(
            f"need {k} shards to decode, have {len(by_index)}")
    use = sorted(by_index)[:k]
    slen = max(1, -(-length // k))
    bodies = [np.frombuffer(by_index[i], dtype=np.uint8)[:slen] for i in use]
    if all(i < k for i in use) and use == list(range(k)):
        out = np.concatenate(bodies)
        return out.tobytes()[:length]
    G = _generator(k, m)
    inv = _gf_solve([G[i] for i in use], k)
    data = []
    for r in range(k):
        acc = np.zeros(slen, dtype=np.uint8)
        for c in range(k):
            acc ^= _gf_mul_vec(inv[r][c], bodies[c])
        data.append(acc)
    return np.concatenate(data).tobytes()[:length]


def ec_shard_for(payload: bytes, k: int, m: int, index: int) -> bytes:
    """Re-encode a single shard (repair path: rebuild just the lost one)."""
    return ec_encode(payload, k, m)[index]


# ----------------------------------------------------------- page-id codec
_EC_TAG_RE = re.compile(r"-ec(\d+)\+(\d+)$")
_SHARD_RE = re.compile(r"^(.*)\.s(\d+)$")


def ec_tag(k: int, m: int) -> str:
    return f"ec{k}+{m}"


def page_codec(page_id: str) -> Optional[Tuple[int, int]]:
    """``(k, m)`` when ``page_id`` is erasure-coded, else ``None``."""
    mt = _EC_TAG_RE.search(page_id)
    if mt is None:
        return None
    return int(mt.group(1)), int(mt.group(2))


def shard_id(page_id: str, index: int) -> str:
    """Physical store id of shard ``index`` of an EC page."""
    return f"{page_id}.s{index}"


def split_shard(phys_id: str) -> Optional[Tuple[str, int]]:
    """``(logical_page_id, shard_index)`` for a shard id, else ``None``."""
    mt = _SHARD_RE.match(phys_id)
    if mt is None or page_codec(mt.group(1)) is None:
        return None
    return mt.group(1), int(mt.group(2))


def logical_pid(phys_id: str) -> str:
    """Map a physical store id back to its logical page id (identity for
    replicated pages)."""
    split = split_shard(phys_id)
    return phys_id if split is None else split[0]


# ---------------------------------------------------------------- policies
@dataclass(frozen=True)
class PlacementPolicy:
    """How one blob's pages map onto provider endpoints."""

    def width(self, default_replication: int) -> int:
        raise NotImplementedError

    @property
    def tag(self) -> str:
        return ""


@dataclass(frozen=True)
class ReplicationPolicy(PlacementPolicy):
    """N full copies on distinct providers (the paper's model).
    ``n = 0`` means "the deployment default"."""

    n: int = 0

    def width(self, default_replication: int) -> int:
        return self.n if self.n > 0 else default_replication


@dataclass(frozen=True)
class ErasureCodedPolicy(PlacementPolicy):
    """``k`` data + ``m`` parity shards on ``k + m`` distinct providers."""

    k: int = 6
    m: int = 2

    def __post_init__(self) -> None:
        if not (1 <= self.k and 1 <= self.m and self.k + self.m <= 255):
            raise ValueError(f"bad EC geometry k={self.k} m={self.m}")

    def width(self, default_replication: int) -> int:
        return self.k + self.m

    @property
    def tag(self) -> str:
        return ec_tag(self.k, self.m)


def parse_policy(spec) -> PlacementPolicy:
    """``"rep:3"`` / ``"ec:6+2"`` / an already-built policy object."""
    if isinstance(spec, PlacementPolicy):
        return spec
    if not isinstance(spec, str):
        raise ValueError(f"bad placement spec: {spec!r}")
    kind, _, arg = spec.partition(":")
    if kind == "rep":
        return ReplicationPolicy(int(arg) if arg else 0)
    if kind == "ec":
        mt = re.fullmatch(r"(\d+)\+(\d+)", arg)
        if mt is None:
            raise ValueError(f"bad EC spec: {spec!r} (want 'ec:K+M')")
        return ErasureCodedPolicy(int(mt.group(1)), int(mt.group(2)))
    raise ValueError(f"unknown placement spec: {spec!r}")


# ------------------------------------------------------------ hash ring
#: virtual nodes per ring member.  High enough that 8 members spread a
#: few hundred keys within the balance bounds the DHT tests assert, low
#: enough that ring rebuilds stay O(members * vnodes * log) cheap.
DEFAULT_VNODES = 64

_RING_SPACE = 1 << 64


def stable_hash(key: str) -> int:
    """64-bit position of ``key`` on the ring.

    Process-independent by construction (``hash()`` is randomized per
    interpreter run): the same ring state + key always maps to the same
    owners, which is what makes placement replayable across same-seed
    runs and recomputable by any node without a directory lookup.
    """
    digest = hashlib.blake2b(key.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big")


class HashRing:
    """Consistent-hash ring with virtual nodes (membership plane).

    Placement is a pure function of (ring members, key): every member
    is hashed onto the 64-bit ring at :data:`DEFAULT_VNODES` points,
    and a key's owner group is the first ``width`` *distinct* members
    found walking clockwise from the key's hash.  Adding or removing
    one member therefore remaps only the arcs that member gains or
    loses — the consistent-hashing minimal-movement property the
    rebalance gate (``BENCH_ring.json``) measures.

    The ring is membership state only — it holds node *ids*, never
    sockets or stores — so two rings with the same members are
    interchangeable, and a reconfiguration can diff an old ring
    against a new one arc by arc (see ``MetadataDHT``'s ARES-style
    per-range pointer flips).
    """

    def __init__(self, nodes: Iterable[str] = (), *,
                 vnodes: int = DEFAULT_VNODES) -> None:
        self.vnodes = vnodes
        self._nodes: Set[str] = set()
        self._points: List[int] = []          # sorted vnode positions
        self._owner_at: Dict[int, str] = {}   # position -> member id
        for node in nodes:
            self.add(node)

    # -- membership --------------------------------------------------------
    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for i in range(self.vnodes):
            pos = stable_hash(f"{node}#{i}")
            # vanishing-probability collision: keep the lexically first
            # owner so both colliders resolve identically everywhere
            cur = self._owner_at.get(pos)
            if cur is not None:
                if node < cur:
                    self._owner_at[pos] = node
                continue
            self._owner_at[pos] = node
            bisect.insort(self._points, pos)

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        for i in range(self.vnodes):
            pos = stable_hash(f"{node}#{i}")
            if self._owner_at.get(pos) != node:
                continue
            del self._owner_at[pos]
            idx = bisect.bisect_left(self._points, pos)
            if idx < len(self._points) and self._points[idx] == pos:
                self._points.pop(idx)

    def nodes(self) -> Set[str]:
        return set(self._nodes)

    def __contains__(self, node: str) -> bool:
        return node in self._nodes

    def __len__(self) -> int:
        return len(self._nodes)

    # -- placement ---------------------------------------------------------
    def owners(self, key: str, width: int,
               eligible: Optional[Set[str]] = None) -> List[str]:
        """The ``width`` distinct members owning ``key``, clockwise from
        its hash.  ``eligible`` (when given) filters the walk — a downed
        member is skipped deterministically, so the group for a key is a
        pure function of (ring, key, eligible set).  Returns fewer than
        ``width`` when the ring has fewer distinct eligible members."""
        return self.owners_at(stable_hash(key), width, eligible)

    def owners_at(self, pos: int, width: int,
                  eligible: Optional[Set[str]] = None) -> List[str]:
        if not self._points or width <= 0:
            return []
        out: List[str] = []
        start = bisect.bisect_right(self._points, pos % _RING_SPACE)
        n = len(self._points)
        for step in range(n):
            node = self._owner_at[self._points[(start + step) % n]]
            if node in out:
                continue
            if eligible is not None and node not in eligible:
                continue
            out.append(node)
            if len(out) >= width:
                break
        return out

    # -- reconfiguration geometry ------------------------------------------
    def arc_starts(self) -> List[int]:
        """Sorted vnode positions — the ring's native arc boundaries.
        Arc ``i`` is the clockwise interval ``(points[i-1], points[i]]``
        (wrapping), whose keys are owned starting at ``points[i]``'s
        successor walk."""
        return list(self._points)

    @staticmethod
    def merged_arcs(old: "HashRing", new: "HashRing") -> List[int]:
        """Union of both rings' arc boundaries: within one merged arc the
        owner group is constant under BOTH configurations, which is the
        granularity the ARES-style per-range configuration pointer flips
        at."""
        return sorted(set(old._points) | set(new._points))

    @staticmethod
    def arc_index(arcs: List[int], pos: int) -> int:
        """Index of the merged arc containing ring position ``pos``:
        keys in arc ``i`` satisfy ``arcs[i-1] < pos <= arcs[i]`` (arc 0
        wraps past the last boundary)."""
        if not arcs:
            return 0
        return bisect.bisect_left(arcs, pos % _RING_SPACE) % len(arcs)
