"""Public kernel API of the port, dispatched by the tensor's device.

A tensor on the CPU goes to the plain PyTorch version in ``ref``; a CUDA
tensor goes to the hand-written kernel, which launches or raises.  There
is no switch and no fallback: the card always runs the kernel.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import delta_mask as _dm
from repro_torch.kernels import linear_scan as _ls
from repro_torch.kernels import page_digest as _pd
from repro_torch.kernels import ref as _ref

_KERNELS = {"linear_scan": _ls, "page_digest": _pd, "delta_mask": _dm}


def linear_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t over (B, T, D), with h_{-1} = 0."""
    if a.device.type == "cpu":
        return _ref.ref_linear_scan(a, x)
    return _ls.linear_scan_cuda(a, x)


# ---------------------------------------------------------------------------
# digest / delta
# ---------------------------------------------------------------------------


def leaf_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's raw bytes as a flat uint8 tensor on its device (a view
    when ``t`` is contiguous)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def as_page_words(t: torch.Tensor, page_bytes: int) -> torch.Tensor:
    """A tensor's bytes as (n_pages, words) int32 holding uint32 words.

    The digest domain of the reference (``ops.as_page_words``): bytes
    zero-padded to whole ``page_bytes`` pages, read as little-endian
    32-bit words (the byte order of the CPU and of the card), each page
    zero-padded to a multiple of ``DIGEST_BLOCK_WORDS`` words.
    """
    if page_bytes <= 0 or page_bytes % 4:
        raise ValueError(f"page_bytes must be a positive multiple of 4, got {page_bytes}")
    b = leaf_bytes(t)
    pad = (-b.numel()) % page_bytes
    if pad:
        b = F.pad(b, (0, pad))
    words = b.view(torch.int32).reshape(-1, page_bytes // 4)
    word_pad = _pd.padded_page_words(page_bytes) - words.shape[1]
    if word_pad:
        words = F.pad(words, (0, word_pad))
    return words


def page_digest(t: torch.Tensor, page_bytes: int = 64 * 1024) -> torch.Tensor:
    """(n_pages, 2) int32 digests (uint32 bits) of ``t``'s bytes, on its device."""
    if t.device.type == "cpu":
        return _ref.ref_page_digest(as_page_words(t, page_bytes))
    return _pd.page_digest_cuda(leaf_bytes(t), page_bytes)


def delta_mask(new_digest: torch.Tensor, old_digest: torch.Tensor) -> torch.Tensor:
    """(n,) bool: pages whose digest changed since the last checkpoint."""
    if new_digest.device.type == "cpu":
        return _ref.ref_delta_mask(new_digest, old_digest)
    return _dm.delta_mask_cuda(new_digest, old_digest)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
