"""Incremental BlobSeer checkpoints of the port's training state."""

from repro_torch.checkpoint.blobckpt import BlobCheckpointer, CheckpointStats

__all__ = ["BlobCheckpointer", "CheckpointStats"]
