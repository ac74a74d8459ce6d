"""Plain PyTorch versions of the port's kernels.

Each ``ref_*`` function is the semantic ground truth for its kernel:
``chip_smoke.py`` holds the CUDA kernel against it on the card, and it is
what ``ops`` runs for a tensor on the CPU.  The tests hold it against the
JAX package's oracle of the same name.  ``ref_attention`` is also the
dense attention of ``models.layers`` on every device, as
``repro.kernels.ref.ref_attention`` is in the reference; its flash kernel
is not ported yet.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels.hostdigest import DIGEST_SALT, digest_weights

_M32 = 0xFFFFFFFF
# words per slice of the plain digest: bounds its int64 temporaries
_DIGEST_SLICE_WORDS = 1 << 24


def _u32_bits_as_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


@functools.lru_cache(maxsize=8)
def _digest_weight_halves(n_words: int, device: torch.device):
    w = torch.from_numpy(digest_weights(n_words).astype("int64")).to(device)
    return w & 0xFFFF, w >> 16


def ref_page_digest(pages: torch.Tensor) -> torch.Tensor:
    """Per-page polynomial digest, the plain version of ``page_digest``.

    ``pages``: (n_pages, n_words) words, int32 or int64, read as their
    low 32 bits (the uint32 words of ``ops.as_page_words``).  Returns
    (n_pages, 2) int32 holding the uint32 digests
    ``digest[p, m] = sum_i (x[p,i] + SALT) * A_m^(n_words-1-i) mod 2^32``.

    torch has no full uint32 arithmetic on the CPU, so the sum runs in
    int64 on values kept below 2^32: each product takes the weight in
    16-bit halves, ``x*w = x*w_lo + ((x*w_hi) mod 2^16) << 16 (mod 2^32)``,
    whose parts stay below 2^49, and a page's sum of n_words terms below
    2^32 each stays below 2^63 for any page under 2^31 words.
    """
    if pages.ndim != 2:
        raise ValueError(f"pages must be (n_pages, n_words), got {tuple(pages.shape)}")
    n_pages, n_words = pages.shape
    w_lo, w_hi = _digest_weight_halves(n_words, pages.device)
    out = torch.empty((n_pages, 2), dtype=torch.int64, device=pages.device)
    rows = max(1, _DIGEST_SLICE_WORDS // max(n_words, 1))
    for lo in range(0, n_pages, rows):
        x = ((pages[lo:lo + rows].to(torch.int64) & _M32) + DIGEST_SALT) & _M32
        for m in range(2):
            prod = (x * w_lo[m] + (((x * w_hi[m]) & 0xFFFF) << 16)) & _M32
            out[lo:lo + rows, m] = prod.sum(dim=1) & _M32
    return _u32_bits_as_i32(out)


def ref_delta_mask(new_digest: torch.Tensor, old_digest: torch.Tensor) -> torch.Tensor:
    """(n_pages,) bool: True where a page's digest row changed."""
    return torch.any(new_digest != old_digest, dim=-1)


def ref_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Reference GQA attention, in float32, output in q's dtype.

    q: (B, Hq, Tq, D);  k, v: (B, Hkv, Tk, D);  Hq % Hkv == 0.
    ``q_offset``: absolute position of the first query row.  ``window``:
    keys more than ``window - 1`` positions behind a query are masked.
    """
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qg = (q.float() * (D ** -0.5)).reshape(B, Hkv, group, Tq, D)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = q_offset + torch.arange(Tq, device=q.device)[:, None]
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, Hq, Tq, D).to(q.dtype)


def ref_linear_scan(
    a: torch.Tensor, x: torch.Tensor, h0: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Diagonal linear recurrence ``h_t = a_t * h_{t-1} + x_t``.

    a, x: (B, T, D).  Returns h: (B, T, D) in x's dtype.  ``h0``: (B, D)
    state before step 0 (zero when omitted).  A sequential loop over T:
    each step is one multiply and one add, rounded separately, which is
    the arithmetic the CUDA kernel repeats.
    """
    if a.shape != x.shape or a.ndim != 3:
        raise ValueError(f"a and x must be (B, T, D) of one shape: {a.shape}, {x.shape}")
    h = torch.empty_like(x)
    carry = torch.zeros_like(x[:, 0]) if h0 is None else h0.to(x.dtype)
    for t in range(x.shape[1]):
        carry = a[:, t] * carry + x[:, t]
        h[:, t] = carry
    return h
