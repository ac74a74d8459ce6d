"""BlobSeer core: the paper's contribution, grown toward production.

Versioned, page-striped blob storage with distributed segment-tree
metadata over a DHT, total-order snapshot publication, and cheap
branching — per Nicolae, Antoniu & Bougé (2009) — plus the
beyond-paper subsystems this repo has added on top: a batched
metadata/data request plane, a deterministic virtual-time concurrency
harness (:class:`Simulator`), concurrent-safe distributed GC with
typed :class:`RetiredVersion` answers, and an immutability-aware
read-path cache hierarchy (:class:`NodeCache`/:class:`PageCache`).
See ARCHITECTURE.md for the deep dives and README.md for the map.
"""

from repro_torch.core.blob import BlobClient, ReadError
from repro_torch.core.cache import NodeCache, PageCache
from repro_torch.core.dedup_index import DedupIndex
from repro_torch.core.service import BlobSeerService
from repro_torch.core.sim import Clock, SimDeadlock, Simulator, WallClock
from repro_torch.core.transport import Wire, EndpointDown
from repro_torch.core.version_manager import (
    LineageShard,
    RetiredVersion,
    VersionManager,
    VersionUnpublished,
    WriteBeyondEnd,
)

__all__ = [
    "BlobClient",
    "BlobSeerService",
    "Clock",
    "DedupIndex",
    "EndpointDown",
    "LineageShard",
    "NodeCache",
    "PageCache",
    "ReadError",
    "RetiredVersion",
    "SimDeadlock",
    "Simulator",
    "VersionManager",
    "VersionUnpublished",
    "WallClock",
    "Wire",
    "WriteBeyondEnd",
]


def collect_garbage(svc, keep=None, **kwargs):
    """Distributed snapshot-retirement GC (see repro.core.gc)."""
    from repro_torch.core.gc import collect_garbage as _gc

    return _gc(svc, keep, **kwargs)
