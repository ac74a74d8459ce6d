"""Training-data pipeline over a BlobSeer blob — the paper's own usage
scenario (§2.2), applied to tokens instead of pictures:

* ingestion processes APPEND tokenized documents to a corpus blob
  concurrently (multiple writers, no synchronization — the paper's
  headline property);
* training readers pin a *published* snapshot version and read disjoint
  ranges of it ("a set of workers READ disjoint parts of the blob"),
  while ingestion keeps appending to later versions;
* the reader cursor (version, offset) is tiny and lives inside the
  checkpoint manifest, so a restarted job resumes bit-identically.

The stream is raw little-endian int32 tokens; documents are delimited
in-band by the tokenizer's EOS.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.blob import BlobClient

_ITEM = 4  # bytes per int32 token


class CorpusWriter:
    """Appends tokenized documents to the corpus blob."""

    def __init__(self, client: BlobClient, blob_id: Optional[str] = None,
                 psize: int = 64 * 1024) -> None:
        self.client = client
        self.blob_id = blob_id if blob_id is not None else client.create(psize=psize)

    def append_tokens(self, tokens: np.ndarray) -> int:
        """Append an int32 token array; returns the published-when version."""
        arr = np.ascontiguousarray(tokens, dtype=np.int32)
        return self.client.append(self.blob_id, arr.tobytes())

    def n_tokens(self, version: Optional[int] = None) -> int:
        if version is None:
            version = self.client.get_recent(self.blob_id)
        if version == 0:
            return 0
        return self.client.get_size(self.blob_id, version) // _ITEM


@dataclass
class ReaderState:
    version: int      # pinned snapshot
    position: int     # next token index for THIS shard
    shard: int
    n_shards: int


class ShardedReader:
    """Deterministic next-token batches from a pinned snapshot.

    Shard ``i`` of ``n`` owns token indices ``[i*W, (i+1)*W)`` then
    ``[i*W + n*W, ...)`` etc. with window ``W = batch*(seq+1)`` — disjoint
    ranges per shard, exactly the paper's concurrent-readers pattern.
    When the pinned snapshot is exhausted the reader re-pins the most
    recent published version (data may have grown since) or wraps.
    """

    def __init__(
        self,
        client: BlobClient,
        blob_id: str,
        batch: int,
        seq_len: int,
        shard: int = 0,
        n_shards: int = 1,
        state: Optional[Dict] = None,
    ) -> None:
        self.client = client
        self.blob_id = blob_id
        self.batch = batch
        self.seq_len = seq_len
        if state is not None:
            self.state = ReaderState(**state)
        else:
            version = client.get_recent(blob_id)
            self.state = ReaderState(version=version, position=shard * self._window(),
                                     shard=shard, n_shards=n_shards)

    def _window(self) -> int:
        return self.batch * (self.seq_len + 1)

    def state_dict(self) -> Dict:
        return dict(version=self.state.version, position=self.state.position,
                    shard=self.state.shard, n_shards=self.state.n_shards)

    def _snapshot_tokens(self) -> int:
        if self.state.version == 0:
            return 0
        return self.client.get_size(self.blob_id, self.state.version) // _ITEM

    def repin(self) -> None:
        """Advance to the latest published snapshot (ingestion caught up)."""
        v = self.client.get_recent(self.blob_id)
        if v > self.state.version:
            self.state.version = v

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, labels) both (batch, seq_len) int32. Deterministic."""
        W = self._window()
        total = self._snapshot_tokens()
        if self.state.position + W > total:
            self.repin()
            total = self._snapshot_tokens()
            if self.state.position + W > total:
                # wrap: restart this shard's walk over the snapshot
                self.state.position = self.state.shard * W
                if self.state.position + W > total:
                    raise RuntimeError(
                        f"corpus too small: need {W} tokens/shard, have {total}"
                    )
        raw = self.client.read(
            self.blob_id, self.state.version, self.state.position * _ITEM, W * _ITEM
        )
        flat = np.frombuffer(raw, dtype=np.int32).reshape(self.batch, self.seq_len + 1)
        self.state.position += W * self.state.n_shards
        return flat[:, :-1].copy(), flat[:, 1:].copy()

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next_batch()
