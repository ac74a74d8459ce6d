"""Plain PyTorch versions of the port's kernels.

Each ``ref_*`` function is the semantic ground truth for its kernel:
``chip_smoke.py`` holds the CUDA kernel against it on the card, and it is
what ``ops`` runs for a tensor on the CPU.  The tests hold it against the
JAX package's oracle of the same name.  ``ref_attention`` is also the
dense attention of ``models.layers`` on every device, as
``repro.kernels.ref.ref_attention`` is in the reference;
``ref_flash_attention`` is the plain version of the flash kernel, the
reference's blockwise (online-softmax) attention, and
``ref_flash_attention_backward`` the plain version of its backward kernel:
the gradients the reference's ``jax.grad`` takes through that attention.
``ref_flash_attention_partials`` and ``ref_merge_attention`` are the plain
versions of the bf16 kernel's split path: each key range's output and row
log-sum-exp, and their merge.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple, Union

import torch

from repro_torch.kernels.hostdigest import DIGEST_SALT, digest_weights

_M32 = 0xFFFFFFFF
# a split range of the keys is a whole number of these chunks (eight of the
# bf16 kernel's 64-key tiles, four of its 128-key ones)
SPLIT_KEYS = 512
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


def ref_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    softcap: Optional[float] = None,
    chunk: int = 1024,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Online-softmax GQA attention over ``chunk``-key slices, in float32.

    The plain version of ``flash_attention``, ported from the reference's
    ``models/layers.py::_blockwise_attention``: q is scaled by
    ``D ** -0.5`` in float32 before the dot, masked scores are ``-1e30``
    and their probabilities are zeroed after the exp, a row with no live
    key (``l == 0``) comes out as zeros, and the output is in q's dtype.
    Memory is O(Tq * chunk) per head.  Shapes as ``ref_attention``.

    Each slice updates only the rows that can see one of its keys, as the
    kernel skips dead tiles: for any other row the reference's update is
    ``p = 0`` and ``alpha = exp(0) = 1``, which leaves m, l and the
    accumulator exactly as they were.

    With ``return_lse`` it also returns each row's log-sum-exp of its
    live scores, ``m + log(l)``, float32 (B, Hq, Tq): ``-inf`` for a row
    with no live key.  The backward recomputes the probabilities from it.
    """
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qf = (q.float() * (D ** -0.5)).reshape(B, Hkv, group, Tq, D)
    qpos = q_offset + torch.arange(Tq, device=q.device)
    m = torch.full((B, Hkv, group, Tq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, group, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, group, Tq, D), dtype=torch.float32, device=q.device)
    for j0 in range(0, Tk, chunk):
        j1 = min(j0 + chunk, Tk)
        r0 = max(0, j0 - q_offset) if causal else 0                  # qpos >= j0
        r1 = Tq if window is None else min(Tq, j1 - 1 + window - q_offset)
        if r0 >= r1:
            continue
        kj = k[:, :, j0:j1].float()
        vj = v[:, :, j0:j1].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf[..., r0:r1, :], kj)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kpos = torch.arange(j0, j1, device=q.device)
        rpos = qpos[r0:r1, None]
        mask = torch.ones((r1 - r0, j1 - j0), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= rpos
        if window is not None:
            mask &= kpos[None, :] > rpos - window
        s = s.masked_fill(~mask, -1e30)
        m_old = m[..., r0:r1]
        m_new = torch.maximum(m_old, s.amax(-1))
        p = torch.exp(s - m_new[..., None]).masked_fill(~mask, 0.0)
        alpha = torch.exp(m_old - m_new)
        l[..., r0:r1] = l[..., r0:r1] * alpha + p.sum(-1)
        acc[..., r0:r1, :] = (acc[..., r0:r1, :] * alpha[..., None]
                              + torch.einsum("bhgqk,bhkd->bhgqd", p, vj))
        m[..., r0:r1] = m_new
    dead = l == 0.0
    out = (acc / torch.where(dead, torch.ones_like(l), l)[..., None]).reshape(B, Hq, Tq, D)
    out = out.to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(dead, torch.full_like(m, float("-inf")), m + torch.log(l))
    return out, lse.reshape(B, Hq, Tq)


def key_span(Tq: int, Tk: int, *, causal: bool, window: Optional[int],
             q_offset: int) -> Tuple[int, int]:
    """[lo, hi): the keys that some row can see (the first row's window
    start, rounded down to a whole ``SPLIT_KEYS`` chunk, to the last row's
    causal end); lo == hi when no row sees a key."""
    lo = max(0, q_offset - window + 1) if window is not None else 0
    hi = min(Tk, q_offset + Tq) if causal else Tk
    lo = lo // SPLIT_KEYS * SPLIT_KEYS
    return lo, max(lo, hi)


def split_ranges(Tq: int, Tk: int, splits: int, *, causal: bool, window: Optional[int],
                 q_offset: int) -> List[Tuple[int, int]]:
    """The key ranges [start, end) of a call split ``splits`` ways: the n
    whole ``SPLIT_KEYS`` chunks of the live key span (``key_span``) go to
    the ranges in order, range s taking chunks floor(s n / S) to
    floor((s + 1) n / S), and the last range runs on to Tk.  Every range
    holds at least one chunk, so ``splits`` may not exceed n.  One range is
    the whole of the keys."""
    if splits == 1:
        return [(0, Tk)]
    lo, hi = key_span(Tq, Tk, causal=causal, window=window, q_offset=q_offset)
    n = (hi - lo) // SPLIT_KEYS
    if not 1 <= splits <= n:
        raise ValueError(f"{splits} key ranges of whole {SPLIT_KEYS}-key chunks: the live "
                         f"keys [{lo}, {hi}) hold {n}")
    starts = [lo + SPLIT_KEYS * (s * n // splits) for s in range(splits)]
    return list(zip(starts, starts[1:] + [Tk]))


def ref_flash_attention_partials(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    splits: int,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    softcap: Optional[float] = None,
    chunk: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each key range's attention, the plain version of the split kernel's
    partials: for the ranges of ``split_ranges``, o_s (B, Hq, S, Tq, D)
    and lse_s (B, Hq, S, Tq), both float32: ``ref_flash_attention`` over
    the range's keys alone (at their own positions), so a row that sees
    no key of a range has zeros and lse -inf there."""
    outs, lses = [], []
    for a, b in split_ranges(q.shape[2], k.shape[2], splits, causal=causal, window=window,
                             q_offset=q_offset):
        o, lse = ref_flash_attention(q.float(), k[:, :, a:b].float(), v[:, :, a:b].float(),
                                     causal=causal, window=window, q_offset=q_offset - a,
                                     softcap=softcap, chunk=chunk, return_lse=True)
        outs.append(o)
        lses.append(lse)
    return torch.stack(outs, 2), torch.stack(lses, 2)


def ref_merge_attention(o_s: torch.Tensor,
                        lse_s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge of key ranges' outputs, the plain version of the merge
    kernel: lse = logsumexp_s lse_s and o = sum_s exp(lse_s - lse) o_s,
    float32, from o_s (B, Hq, S, Tq, D) and lse_s (B, Hq, S, Tq).  A row
    with no live key in any range comes out as zeros and lse -inf."""
    lse = torch.logsumexp(lse_s.float(), dim=2)
    ref = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    w = torch.exp(lse_s.float() - ref[:, :, None])
    return (w[..., None] * o_s.float()).sum(2), lse


def ref_flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    softcap: Optional[float] = None,
    chunk: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of ``ref_flash_attention``'s output, the
    plain version of ``flash_attention_bwd``.

    ``o`` and ``lse`` are the forward's output and row log-sum-exp
    (``return_lse``), ``do`` the output's gradient.  Over ``chunk``-key
    slices in float32, each slice only for the rows that can see one of
    its keys:

        P  = exp(S - lse)        (0 where masked, and on a row with no live key)
        dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(dO * O))
        dS *= 1 - (S / c)^2      (softcap c: S = c tanh(s / c))
        dQ = D^-0.5 dS K,  dK = D^-0.5 dS^T Q

    with dK and dV summed over the query heads of each kv head.  The
    gradients come out in the inputs' dtypes, as the reference's
    ``jax.grad`` of ``_blockwise_attention`` gives them.
    """
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = D ** -0.5
    qf = q.float().reshape(B, Hkv, group, Tq, D)
    qs = qf * scale
    dof = do.float().reshape(B, Hkv, group, Tq, D)
    delta = (dof * o.float().reshape(B, Hkv, group, Tq, D)).sum(-1)
    lse = lse.reshape(B, Hkv, group, Tq)
    live_row = torch.isfinite(lse)
    lse = torch.where(live_row, lse, torch.zeros_like(lse))
    qpos = q_offset + torch.arange(Tq, device=q.device)
    dq = torch.zeros((B, Hkv, group, Tq, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Hkv, Tk, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, Hkv, Tk, D), dtype=torch.float32, device=q.device)
    for j0 in range(0, Tk, chunk):
        j1 = min(j0 + chunk, Tk)
        r0 = max(0, j0 - q_offset) if causal else 0                  # qpos >= j0
        r1 = Tq if window is None else min(Tq, j1 - 1 + window - q_offset)
        if r0 >= r1:
            continue
        kj = k[:, :, j0:j1].float()
        vj = v[:, :, j0:j1].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qs[..., r0:r1, :], kj)
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s = softcap * t
        kpos = torch.arange(j0, j1, device=q.device)
        rpos = qpos[r0:r1, None]
        mask = torch.ones((r1 - r0, j1 - j0), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= rpos
        if window is not None:
            mask &= kpos[None, :] > rpos - window
        mask = mask & live_row[..., r0:r1, None]
        p = torch.exp(s - lse[..., r0:r1, None]).masked_fill(~mask, 0.0)
        do_r = dof[..., r0:r1, :]
        dv[:, :, j0:j1] += torch.einsum("bhgqk,bhgqd->bhkd", p, do_r)
        ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", do_r, vj) - delta[..., r0:r1, None])
        if softcap is not None:
            ds = ds * (1.0 - t * t)
        dq[..., r0:r1, :] += torch.einsum("bhgqk,bhkd->bhgqd", ds, kj) * scale
        dk[:, :, j0:j1] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qf[..., r0:r1, :]) * scale
    return dq.reshape(B, Hq, Tq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
