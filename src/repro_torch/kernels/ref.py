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

from typing import Optional

import torch


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
