"""File-backed page store.

One file per page under a spool directory — the layout a real deployment
would use for NVMe spill.  Pages are immutable, so writes use
write-to-temp + rename for crash atomicity (a torn page write is never
visible, matching the paper's never-overwrite invariant).
"""

from __future__ import annotations

import os
import threading
from typing import Iterator, Optional


class FilePageStore:
    """``fsync`` policy mirrors the VM WAL's: ``"never"`` (default —
    rename-atomic but a power cut may lose the page) or ``"always"``
    (fsync the file before the rename and the directory after it, so a
    renamed page is durable, not just atomic)."""

    FSYNC_POLICIES = ("never", "always")

    def __init__(self, root: str, fsync: str = "never") -> None:
        if fsync not in self.FSYNC_POLICIES:
            raise ValueError(
                f"fsync policy {fsync!r} not in {self.FSYNC_POLICIES}")
        self.root = root
        self.fsync = fsync
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, pid: str) -> str:
        # two-level fanout so directories stay small at scale
        return os.path.join(self.root, pid[-2:], pid)

    def put(self, pid: str, payload: bytes) -> None:
        path = self._path(pid)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if os.path.exists(path):
            return  # immutable: identical by pid-uniqueness
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(payload)
                if self.fsync == "always":
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            # never leak the temp file: a failed write must leave the
            # spool exactly as it was
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        if self.fsync == "always":
            # the rename itself is only durable once the directory is
            dfd = os.open(os.path.dirname(path), os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)

    def get(self, pid: str) -> Optional[bytes]:
        try:
            with open(self._path(pid), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def has(self, pid: str) -> bool:
        return os.path.exists(self._path(pid))

    def delete(self, pid: str) -> None:
        try:
            os.remove(self._path(pid))
        except FileNotFoundError:
            pass

    def __len__(self) -> int:
        n = 0
        for _, _, files in os.walk(self.root):
            n += sum(1 for f in files if not f.endswith(".tmp"))
        return n

    def iter_pids(self) -> Iterator[str]:
        for _, _, files in os.walk(self.root):
            for f in files:
                if not f.endswith(".tmp"):
                    yield f

    def total_bytes(self) -> int:
        total = 0
        for d, _, files in os.walk(self.root):
            for f in files:
                if not f.endswith(".tmp"):
                    total += os.path.getsize(os.path.join(d, f))
        return total
