"""Data utilities of the port (the byte tokenizer; the blob-backed
corpus pipeline is not ported yet)."""

from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer"]
