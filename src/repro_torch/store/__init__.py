"""Physical page stores backing data providers."""

from repro_torch.store.memory import MemoryPageStore
from repro_torch.store.file import FilePageStore
from repro_torch.store.s3 import S3PageStore

__all__ = ["MemoryPageStore", "FilePageStore", "S3PageStore"]
