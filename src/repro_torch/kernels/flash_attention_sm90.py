"""CUDA kernel for GQA online-softmax (flash) attention on bf16 inputs,
on Hopper's tensor cores, forward (``flash_attention_bwd.py`` has the
backward).

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas`` for
bfloat16 q, k and v (``ops.flash_attention`` sends float32 inputs to
``flash_attention.py``'s kernel).  The kernel
(``csrc/flash_attention_sm90.cu``) runs one block per 192 query rows (128
above a head width of 128) of one (batch, query head), three (two)
warpgroups of 64 rows: one thread keeps TMA loads of k and v tiles in
flight while the warpgroups run q k^T and P V as ``wgmma`` on bf16 tiles,
with P split into two bf16 parts and m, l and the accumulator in
float32.  It walks only the live 64-key tiles.  With ``return_lse`` it
also writes each row's log-sum-exp, which the backward reads.  Its plain
version is ``repro_torch.kernels.ref.ref_flash_attention``.

``launches`` counts the kernel's launches, and nothing else; a run reads
it to show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as _fa

launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention_sm90").flash_attention_sm90_fwd
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = ([ptr] * 4 + [i64] * 6 + [i64] * 9
                       + [ctypes.c_int, ctypes.c_int, i64, i64, ctypes.c_int,
                          ctypes.c_float, ctypes.c_float, ptr, ptr])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    _fa._check_shapes(q, k, v)
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"flash_attention_sm90: bfloat16 inputs only, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    D = q.shape[3]
    if D % 8:
        raise ValueError(f"flash_attention_sm90: head width {D} is not a multiple of 8")
    for name, t in (("q", q), ("k", k), ("v", v)):
        # TMA reads rows from 16-byte aligned addresses; a size-1 dimension
        # is never stepped, so its stride does not matter
        if any(t.stride(i) % 8 for i in range(3) if t.shape[i] > 1):
            raise ValueError(f"flash_attention_sm90: {name}'s strides {t.stride()} are not "
                             f"multiples of 8 elements (16 bytes)")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_sm90: {name} does not start on a 16-byte "
                             f"boundary ({t.data_ptr():#x})")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_sm90: the kernel takes CUDA tensors on one device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.shape[0] > _fa._MAX_GRID_YZ or q.shape[1] > _fa._MAX_GRID_YZ:
        raise ValueError(f"flash_attention_sm90: batch {q.shape[0]} or {q.shape[1]} heads "
                         f"exceed {_fa._MAX_GRID_YZ}")


def flash_attention_sm90_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    softcap: Optional[float] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """q: (B, Hq, Tq, D), k, v: (B, Hkv, Tk, D) bfloat16 CUDA tensors, unit
    stride in D, D a multiple of 8 -> contiguous (B, Hq, Tq, D) bfloat16;
    with ``return_lse`` also each row's log-sum-exp, contiguous float32
    (B, Hq, Tq), -inf where a row sees no key."""
    global launches
    _check(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if k.shape[2] == 0:     # no key at all: every row is fully masked
        out.zero_()
        return (out, lse.fill_(float("-inf"))) if return_lse else out
    fn = _kernel()
    B, Hq, Tq, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Hq, k.shape[1], Tq, k.shape[2], D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 int(causal), int(window is not None), int(window or 0), int(q_offset),
                 int(softcap is not None), float(softcap or 0.0), float(D ** -0.5),
                 lse.data_ptr() if return_lse else None, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_sm90: kernel launch failed with CUDA error {err}")
    launches += 1
    return (out, lse) if return_lse else out
