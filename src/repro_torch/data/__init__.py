"""Data utilities of the port: the byte tokenizer and the blob-backed
corpus pipeline (``pipeline.py``, a copy of the reference's)."""

from repro_torch.data.pipeline import CorpusWriter, ShardedReader
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer", "CorpusWriter", "ShardedReader"]
