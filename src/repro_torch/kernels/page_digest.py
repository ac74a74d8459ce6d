"""CUDA kernel for the per-page polynomial digest of a leaf's bytes.

Replaces ``repro/kernels/page_digest.py::page_digest_pallas``.  The
kernel (``csrc/page_digest.cu``) runs one thread block per page, reads
the leaf in place with 16-byte loads and treats every byte past the leaf
as zero, so it needs no padded copy; it is bound by HBM traffic at the
leaf's padded bytes.  Its plain version is
``repro_torch.kernels.ref.ref_page_digest`` over ``ops.as_page_words``.
The digest constants come from ``hostdigest``, as the blob client's do.

``launches`` counts the kernel's launches, and nothing else; a run reads
it to show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.hostdigest import DIGEST_BLOCK_WORDS, DIGEST_MULTS, DIGEST_SALT

launches = 0
_MAX_PAGES = 2**31 - 1

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("page_digest").page_digest_u8
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def padded_page_words(page_bytes: int) -> int:
    """Words of one page in the digest domain: page_bytes / 4 rounded up
    to a whole digest block (``ops.as_page_words``)."""
    words = page_bytes // 4
    return words + (-words) % DIGEST_BLOCK_WORDS


def _check(data: torch.Tensor, page_bytes: int) -> None:
    if data.dtype != torch.uint8 or data.ndim != 1:
        raise TypeError(f"page_digest: a flat uint8 tensor of the leaf's bytes, "
                        f"got {data.dtype} of shape {tuple(data.shape)}")
    if not data.is_contiguous():
        raise ValueError("page_digest: the bytes must be contiguous")
    if data.device.type != "cuda":
        raise ValueError(f"page_digest: the kernel takes a CUDA tensor, got {data.device}")
    if page_bytes <= 0 or page_bytes % 4:
        raise ValueError(f"page_digest: page_bytes must be a positive multiple of 4, "
                         f"got {page_bytes}")
    if -(-data.numel() // page_bytes) > _MAX_PAGES:
        raise ValueError(f"page_digest: more than {_MAX_PAGES} pages")


def page_digest_cuda(data: torch.Tensor, page_bytes: int) -> torch.Tensor:
    """data: flat uint8 CUDA tensor -> (ceil(len / page_bytes), 2) int32
    digests (the uint32 bits), the last page zero-padded."""
    global launches
    _check(data, page_bytes)
    n_pages = -(-data.numel() // page_bytes)
    out = torch.empty((n_pages, 2), dtype=torch.int32, device=data.device)
    if n_pages == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(data.data_ptr(), data.numel(), page_bytes, padded_page_words(page_bytes),
                 DIGEST_MULTS[0], DIGEST_MULTS[1], DIGEST_SALT,
                 out.data_ptr(), n_pages, stream)
    if err != 0:
        raise RuntimeError(f"page_digest: kernel launch failed with CUDA error {err}")
    launches += 1
    return out
