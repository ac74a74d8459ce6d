"""S3-class object store for the cold tier.

The shape mirrors a bucket/prefix blob backend fronted by a local cache
(the ``zodb-s3blobs`` pattern ROADMAP item 1 names): pages live under
``s3://<bucket>/<prefix>/<pid>``, every operation is a billable request,
and reads are slow-but-durable capacity — the deployment's shared
:class:`~repro.core.cache.PageCache` absorbs repeat reads exactly as it
does for hot providers, so only the first touch of a demoted page pays
the cold path.

The implementation is an in-memory dict (this repo simulates the wire;
latency/bandwidth are charged by ``transport.Wire`` at the provider
endpoint like every other backend).  What distinguishes it from
:class:`~repro.store.memory.MemoryPageStore` is the request-counter
ledger (``op_counts``) — the billing surface a real S3 backend meters —
and key layout.  It satisfies the same page-store interface every
provider backend does: ``put/get/has/delete/iter_pids/__len__/
total_bytes``.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, Optional


class S3PageStore:
    def __init__(self, bucket: str, prefix: str = "pages") -> None:
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self._objects: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self.op_counts: Dict[str, int] = {
            "put": 0, "get": 0, "head": 0, "delete": 0, "list": 0,
        }

    def _key(self, pid: str) -> str:
        return f"{self.prefix}/{pid}"

    def url(self, pid: str) -> str:
        return f"s3://{self.bucket}/{self._key(pid)}"

    def put(self, pid: str, payload: bytes) -> None:
        with self._lock:
            self.op_counts["put"] += 1
            key = self._key(pid)
            # object stores are last-writer-wins; immutability comes from
            # pid uniqueness upstream, so a re-put must match
            prev = self._objects.get(key)
            if prev is not None and prev != payload:
                raise ValueError(
                    f"page {pid} re-stored with different content")
            self._objects[key] = payload

    def get(self, pid: str) -> Optional[bytes]:
        with self._lock:
            self.op_counts["get"] += 1
            return self._objects.get(self._key(pid))

    def has(self, pid: str) -> bool:
        with self._lock:
            self.op_counts["head"] += 1
            return self._key(pid) in self._objects

    def delete(self, pid: str) -> None:
        with self._lock:
            self.op_counts["delete"] += 1
            self._objects.pop(self._key(pid), None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._objects)

    def iter_pids(self) -> Iterator[str]:
        with self._lock:
            self.op_counts["list"] += 1
            skip = len(self.prefix) + 1
            return iter([k[skip:] for k in self._objects])

    def total_bytes(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._objects.values())
