"""Public kernel API of the port, dispatched by the tensor's device.

A tensor on the CPU goes to the plain PyTorch version in ``ref``; a CUDA
tensor goes to the hand-written kernel, which launches or raises.  There
is no switch and no fallback: the card always runs the kernel.  Under a
mesh the scan runs on each rank's local slices (its time axis whole);
attention is reached with local tensors (``models.layers``), and a
DTensor handed to the other kernels raises.

Gradients go through the same dispatch.  Under autograd (grad enabled
and an input that requires grad) the scan goes through the custom op
``repro_torch::linear_scan``, whose registered gradient is the same scan
run backwards in time (the kernel on the card), and attention through
``_FlashAttention``: its forward keeps each row's log-sum-exp, its
backward is ``flash_attention_bwd_sm90``'s kernel on the card for
bfloat16 (the tensor cores) and ``flash_attention_bwd``'s for float32,
and ``ref.ref_flash_attention_backward`` on the CPU.  With grad off (serving)
the kernels are called directly, as before.

A fake tensor (``FakeTensorMode``, the dry run of ``launch/dryrun.py``)
goes to the custom ops ``repro_torch::linear_scan``,
``repro_torch::flash_attention`` (o and lse) and
``repro_torch::flash_attention_backward``, whose shape functions give the
outputs without launching a kernel or running the plain versions' loops;
their FLOP formulas count attention as 4·B·Hq·D per live query-key pair,
its backward as 8·B·Hq·D (what the reference's differentiated scan
performs, keeping its probabilities), and the scan as 0 (vector work,
which the cost model does not count).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.distributed.partitioning import is_distributed
from repro_torch.kernels import delta_mask as _dm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import flash_attention_bwd_sm90 as _fab90
from repro_torch.kernels import flash_attention_sm90 as _fa90
from repro_torch.kernels import linear_scan as _ls
from repro_torch.kernels import page_digest as _pd
from repro_torch.kernels import ref as _ref

_KERNELS = {"linear_scan": _ls, "page_digest": _pd, "delta_mask": _dm,
            "flash_attention": _fa, "flash_attention_sm90": _fa90,
            "flash_attention_bwd": _fab, "flash_attention_bwd_sm90": _fab90}


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


def _recorded(*ts) -> bool:
    """Whether autograd records a call on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def linear_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t over (B, T, D), with h_{-1} = 0.  DTensors
    are scanned on each rank's local (B, T, D) slices, T gathered whole
    and x placed as a is: the recurrence is elementwise over B and D.
    Under autograd the call goes through the custom op, whose gradient
    is the reversed scan (one more launch on the card)."""
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
    if _recorded(a, x):
        return _linear_scan_op(a, x)
    return _scan(a, x)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attention(q, k, v, causal, window, q_offset, softcap, return_lse=False):
    """o, or (o, lse) with ``return_lse``: the custom op's shape function on
    fake tensors, the plain version on the CPU, the dtype's kernel on the
    card."""
    if isinstance(q, FakeTensor):
        o, lse = _flash_attention_op(q, k, v, causal, window, q_offset, softcap)
        return (o, lse) if return_lse else o
    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap,
              return_lse=return_lse)
    if q.device.type == "cpu":
        return _ref.ref_flash_attention(q, k, v, **kw)
    kernel = (_fa90.flash_attention_sm90_cuda
              if q.dtype == k.dtype == v.dtype == torch.bfloat16 else _fa.flash_attention_cuda)
    return kernel(q, k, v, **kw)


def _attention_backward(q, k, v, o, lse, do, causal, window, q_offset, softcap):
    """(dq, dk, dv): the custom op's shape function on fake tensors, the
    plain version on the CPU, the dtype's kernel on the card (bfloat16 q:
    the tensor-core kernel, which raises on what it does not take)."""
    if isinstance(q, FakeTensor):
        return _flash_attention_backward_op(q, k, v, o, lse, do, causal, window, q_offset,
                                            softcap)
    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
    if q.device.type == "cpu":
        return _ref.ref_flash_attention_backward(q, k, v, o, lse, do, **kw)
    kernel = (_fab90.flash_attention_bwd_sm90_cuda if q.dtype == torch.bfloat16
              else _fab.flash_attention_bwd_cuda)
    return kernel(q, k, v, o, lse, do, **kw)


class _FlashAttention(torch.autograd.Function):
    """Attention that autograd records: the forward keeps (q, k, v, o,
    lse), the backward recomputes the probabilities from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, softcap):
        o, lse = _attention(q, k, v, causal, window, q_offset, softcap, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, q_offset, softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _attention_backward(q, k, v, o, lse, do.contiguous(), *ctx.mask)
        return dq, dk, dv, None, None, None, None


def _check_attention_shapes(q, k, v):
    B, Hq, Tq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} does not attend over k, v {tuple(k.shape)}")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                        window: Optional[int], q_offset: int,
                        softcap: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    return _attention(q, k, v, causal, window, q_offset, softcap, return_lse=True)


@_flash_attention_op.register_fake
def _(q, k, v, causal, window, q_offset, softcap):
    _check_attention_shapes(q, k, v)
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_backward", mutates_args=())
def _flash_attention_backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                                 causal: bool, window: Optional[int], q_offset: int,
                                 softcap: Optional[float]) -> List[torch.Tensor]:
    return list(_attention_backward(q, k, v, o, lse, do, causal, window, q_offset, softcap))


@_flash_attention_backward_op.register_fake
def _(q, k, v, o, lse, do, causal, window, q_offset, softcap):
    _check_attention_shapes(q, k, v)
    return [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v)]



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


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _flash_attention_backward_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape,
                                    causal, window, q_offset, softcap, *args,
                                    **kwargs) -> int:
    """dV, dP, dQ and dK: four products of 2·D per live pair (the
    probabilities kept from the forward, as the reference's scan keeps
    them; the kernel recomputes S besides)."""
    B, Hq, Tq, D = q_shape
    return 8 * B * Hq * D * live_pairs(Tq, k_shape[2], causal, window, q_offset)


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
    (``flash_attention_sm90``, which splits the keys of a call with few
    blocks and merges them in the same launch), which
    raises on what it does not take;
    any other call goes to ``flash_attention``'s kernel, which takes
    float32 only and raises on anything else.  A call that autograd
    records also keeps each row's log-sum-exp, and its gradient is
    ``flash_attention_bwd_sm90``'s kernel on the card for bfloat16 and
    ``flash_attention_bwd``'s for float32 (the plain version on the CPU).
    """
    _refuse_distributed("flash_attention", q, k, v)
    if _recorded(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset, softcap)
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


def split_launches() -> int:
    """``flash_attention_sm90`` launches since the last
    :func:`reset_launch_counts` that split their keys into ranges (and
    merged them in the same launch)."""
    return _fa90.split_launches


def fwd_fp16_launches() -> int:
    """``flash_attention_sm90`` calls since the last
    :func:`reset_launch_counts` in which some row block took P V in one fp16
    part (rows that see 1024 keys or more: at head widths 65-128 two more
    launches convert v first; up to 64, calls of more than 64 rows, the
    kernel converts v's tiles in shared memory)."""
    return _fa90.fp16_launches


def bwd_fp16_launches() -> int:
    """``flash_attention_bwd_sm90`` calls since the last
    :func:`reset_launch_counts` that ran their products on fp16 copies
    (head widths up to 128: two more launches, the maxima and the
    conversion)."""
    return _fab90.fp16_launches


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
    _fa90.split_launches = 0
    _fa90.fp16_launches = 0
    _fab90.fp16_launches = 0
