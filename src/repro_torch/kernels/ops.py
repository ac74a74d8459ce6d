"""Public kernel API of the port, dispatched by the tensor's device.

A tensor on the CPU goes to the plain PyTorch version in ``ref``; a CUDA
tensor goes to the hand-written kernel, which launches or raises.  There
is no switch and no fallback: the card always runs the kernel.  Under a
mesh the scan runs on each rank's local slices (its time axis whole);
attention is reached with local tensors (``models.layers``), and a
DTensor handed to the other kernels raises.

A fake tensor (``FakeTensorMode``, the dry run of ``launch/dryrun.py``)
goes to the custom ops ``repro_torch::linear_scan`` and
``repro_torch::flash_attention``, whose shape functions give the output
without launching a kernel or running the plain version's loops; their
FLOP formulas count attention as 4·B·Hq·D per live query-key pair and
the scan as 0 (vector work, which the cost model does not count).  Real
tensors never pass through the custom ops, so the plain versions and the
kernels, and their launch counts, are what they were.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.distributed.partitioning import is_distributed
from repro_torch.kernels import delta_mask as _dm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_sm90 as _fa90
from repro_torch.kernels import linear_scan as _ls
from repro_torch.kernels import page_digest as _pd
from repro_torch.kernels import ref as _ref

_KERNELS = {"linear_scan": _ls, "page_digest": _pd, "delta_mask": _dm,
            "flash_attention": _fa, "flash_attention_sm90": _fa90}


def _refuse_distributed(name: str, *ts) -> None:
    if any(is_distributed(t) for t in ts):
        raise NotImplementedError(f"{name} takes each rank's local tensors, not DTensors")


def _scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return _ref.ref_linear_scan(a, x)
    return _ls.linear_scan_cuda(a, x)


@torch.library.custom_op("repro_torch::linear_scan", mutates_args=())
def _linear_scan_op(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _scan(a, x)


@_linear_scan_op.register_fake
def _(a, x):
    if a.shape != x.shape or a.ndim != 3:
        raise ValueError(f"a and x must be (B, T, D) of one shape: {a.shape}, {x.shape}")
    return torch.empty_like(x)


def _linear_scan_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], output)


def _linear_scan_backward(ctx, g):
    """dL/dx_t = g_t + a_{t+1} dL/dx_{t+1} (a scan backwards in time) and
    dL/da_t = dL/dx_t * h_{t-1}."""
    a, h = ctx.saved_tensors
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    u = _linear_scan_op(a_next.flip(1), g.flip(1).contiguous()).flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return u * h_prev, u


_linear_scan_op.register_autograd(_linear_scan_backward, setup_context=_linear_scan_setup)


@register_flop_formula(torch.ops.repro_torch.linear_scan)
def _linear_scan_flops(a_shape, x_shape, *args, **kwargs) -> int:
    return 0


def linear_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t over (B, T, D), with h_{-1} = 0.  DTensors
    are scanned on each rank's local (B, T, D) slices, T gathered whole
    and x placed as a is: the recurrence is elementwise over B and D."""
    if isinstance(a, FakeTensor):
        return _linear_scan_op(a, x)
    if is_distributed(a):
        from torch.distributed.tensor import DTensor, Replicate

        mesh = a.device_mesh
        pl = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate() for p in a.placements)
        if not is_distributed(x):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
        h = linear_scan(a.redistribute(mesh, pl).to_local(), x.redistribute(mesh, pl).to_local())
        return DTensor.from_local(h, mesh, pl, run_check=False)
    return _scan(a, x)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attention(q, k, v, causal, window, q_offset, softcap):
    if q.device.type == "cpu":
        return _ref.ref_flash_attention(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset, softcap=softcap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward on the card: training over more than "
            "4096 kv positions waits for a later slice")
    kernel = (_fa90.flash_attention_sm90_cuda
              if q.dtype == k.dtype == v.dtype == torch.bfloat16 else _fa.flash_attention_cuda)
    return kernel(q, k, v, causal=causal, window=window, q_offset=q_offset, softcap=softcap)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                        window: Optional[int], q_offset: int,
                        softcap: Optional[float]) -> torch.Tensor:
    return _attention(q, k, v, causal, window, q_offset, softcap)


@_flash_attention_op.register_fake
def _(q, k, v, causal, window, q_offset, softcap):
    B, Hq, Tq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} does not attend over k, v {tuple(k.shape)}")
    return torch.empty_like(q)


def live_pairs(Tq: int, Tk: int, causal: bool, window: Optional[int], q_offset: int) -> int:
    """Query-key pairs that the mask leaves live: key j < Tk, and for the
    query at position p = q_offset + i, j <= p when causal and j > p - window."""
    p = np.arange(Tq, dtype=np.int64) + q_offset          # numpy: it runs under fake modes
    hi = np.minimum(p, Tk - 1) if causal else np.full_like(p, Tk - 1)
    lo = np.maximum(p - window + 1, 0) if window is not None else np.zeros_like(p)
    return int(np.maximum(hi - lo + 1, 0).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, causal, window, q_offset, softcap,
                           *args, **kwargs) -> int:
    B, Hq, Tq, D = q_shape
    return 4 * B * Hq * D * live_pairs(Tq, k_shape[2], causal, window, q_offset)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """GQA online-softmax attention, q: (B, Hq, Tq, D), k, v: (B, Hkv, Tk, D).

    On the card, bfloat16 q, k and v go to the tensor-core kernel
    (``flash_attention_sm90``), which raises on what it does not take;
    any other call goes to ``flash_attention``'s kernel, which takes
    float32 only and raises on anything else.  Forward only, as the TPU kernel: on the card a
    call that autograd would record raises, since neither kernel has a
    backward.
    """
    _refuse_distributed("flash_attention", q, k, v)
    if isinstance(q, FakeTensor):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError("flash_attention has no backward: not traced under autograd")
        return _flash_attention_op(q, k, v, causal, window, q_offset, softcap)
    return _attention(q, k, v, causal, window, q_offset, softcap)


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
    _refuse_distributed("page_digest", t)
    if t.device.type == "cpu":
        return _ref.ref_page_digest(as_page_words(t, page_bytes))
    return _pd.page_digest_cuda(leaf_bytes(t), page_bytes)


def delta_mask(new_digest: torch.Tensor, old_digest: torch.Tensor) -> torch.Tensor:
    """(n,) bool: pages whose digest changed since the last checkpoint."""
    _refuse_distributed("delta_mask", new_digest, old_digest)
    if new_digest.device.type == "cpu":
        return _ref.ref_delta_mask(new_digest, old_digest)
    return _dm.delta_mask_cuda(new_digest, old_digest)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
