"""In-RAM page store (default for providers).

Pages are immutable once stored (BlobSeer never overwrites a page), so a
plain dict with a lock is enough; readers take no lock after the
reference is fetched.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, Optional


class MemoryPageStore:
    def __init__(self) -> None:
        self._pages: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, pid: str, payload: bytes) -> None:
        with self._lock:
            # Page ids are globally unique; a duplicate put is a replica
            # re-send and must carry identical content.
            prev = self._pages.get(pid)
            if prev is not None and prev is not payload and prev != payload:
                raise ValueError(f"page {pid} re-stored with different content")
            self._pages[pid] = payload

    def get(self, pid: str) -> Optional[bytes]:
        with self._lock:
            return self._pages.get(pid)

    def has(self, pid: str) -> bool:
        with self._lock:
            return pid in self._pages

    def delete(self, pid: str) -> None:
        with self._lock:
            self._pages.pop(pid, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._pages)

    def iter_pids(self) -> Iterator[str]:
        with self._lock:
            return iter(list(self._pages.keys()))

    def total_bytes(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._pages.values())
