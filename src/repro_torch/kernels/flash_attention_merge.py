"""CUDA kernel that merges the key ranges of ``flash_attention_sm90``'s
split path: from each range's float32 output o_s (B, Hq, S, Tq, D) and row
log-sum-exp lse_s (B, Hq, S, Tq), lse = logsumexp_s lse_s and
o = sum_s exp(lse_s - lse) o_s, written in bfloat16 (one warp a row,
``csrc/flash_attention_sm90.cu``); a row whose every range saw no key
comes out as zeros and lse -inf.

It replaces no TPU kernel of its own: ``flash_attention_pallas`` walks a
row's keys as the last, sequential grid dimension and carries m, l and
the accumulator across it in scratch memory, which blocks that run in
parallel cannot share, so a call cut into key ranges merges them in a
second launch.  ``flash_attention_sm90_cuda`` launches it from the same C
call as the split kernel and adds one to ``launches`` for it;
:func:`flash_attention_merge_cuda` runs it alone on given partials, to
hold it against its plain version, ``ref.ref_merge_attention``.  It is
bound by the bytes of the partials.

``launches`` counts the kernel's launches, and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from repro_torch.kernels import build

launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention_sm90").flash_attention_merge
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = [ptr] * 4 + [i64] * 5 + [ptr]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention_merge_cuda(
    o_s: torch.Tensor, lse_s: torch.Tensor, *, return_lse: bool = False
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """o_s (B, Hq, S, Tq, D) and lse_s (B, Hq, S, Tq), contiguous float32
    CUDA tensors, D even -> contiguous bf16 o (B, Hq, Tq, D) and, with
    ``return_lse``, float32 lse (B, Hq, Tq)."""
    global launches
    if o_s.ndim != 5 or tuple(lse_s.shape) != tuple(o_s.shape[:4]):
        raise ValueError(f"flash_attention_merge: o_s {tuple(o_s.shape)} and lse_s "
                         f"{tuple(lse_s.shape)} are not (B, Hq, S, Tq, D) and (B, Hq, S, Tq)")
    if o_s.dtype != torch.float32 or lse_s.dtype != torch.float32:
        raise TypeError(f"flash_attention_merge: float32 partials only, got {o_s.dtype}, "
                        f"{lse_s.dtype}")
    if not (o_s.is_contiguous() and lse_s.is_contiguous()) or o_s.shape[4] % 2:
        raise ValueError("flash_attention_merge: contiguous partials of an even head width")
    if o_s.device.type != "cuda" or lse_s.device != o_s.device:
        raise ValueError(f"flash_attention_merge: the kernel takes CUDA tensors on one "
                         f"device, got {o_s.device}, {lse_s.device}")
    B, Hq, S, Tq, D = o_s.shape
    out = torch.empty((B, Hq, Tq, D), dtype=torch.bfloat16, device=o_s.device)
    lse = torch.empty((B, Hq, Tq), dtype=torch.float32, device=o_s.device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    fn = _kernel()
    with torch.cuda.device(o_s.device):
        stream = torch.cuda.current_stream(o_s.device).cuda_stream
        err = fn(o_s.data_ptr(), lse_s.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if return_lse else None, B, Hq, S, Tq, D, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_merge: kernel launch failed with CUDA error {err}")
    launches += 1
    return (out, lse) if return_lse else out
