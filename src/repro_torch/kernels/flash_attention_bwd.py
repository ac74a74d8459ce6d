"""CUDA kernel for the backward of GQA online-softmax (flash) attention.

Replaces no TPU kernel: ``repro/kernels/flash_attention.py`` is forward
only, and the reference trains through ``models/layers.py::
_blockwise_attention``, whose gradient ``jax.grad`` takes.  This is that
gradient on the card for float32 inputs, with float32 arithmetic
(bfloat16 goes to ``flash_attention_bwd_sm90.py``, on the tensor cores).
The kernel (``csrc/flash_attention_bwd.cu``) is FlashAttention-2's
backward in three launches: ``delta = rowsum(do * o)``, one block per
key tile of a kv head that walks the query heads and tiles seeing its
keys and writes dK and dV once, and one block per query tile that walks
the live key tiles and writes dQ once.  Each recomputes the
probabilities from the forward's row log-sum-exp.  No atomics: two calls
on one input give bit-equal gradients.  Its plain version is
``repro_torch.kernels.ref.ref_flash_attention_backward``.

On Hopper each pass brings the next tile in through ``cp.async`` into a
two-stage ring while it computes this one, keeps register tiles whose
shared-memory reads each feed 16 FMAs or more (8 above a width of 128),
tests the masks only on a tile on a mask edge, and takes the softcap as a
template argument.
:func:`block_config` gives its blocks at a head width, as the kernel's
``flash_attention_bwd_blocks`` reports them (:func:`kernel_blocks`).

``launches`` counts the wrapper's calls that launch the kernel (one a
backward, its three launches together), and nothing else; a run reads it
to show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as _fa

launches = 0

_fn = None


class Blocks(NamedTuple):
    """The tiles of both passes at one head width."""
    head_pad: int   # columns held in shared memory: D rounded up to 64, 128 or 256
    kv_keys: int    # keys a dK/dV block
    kv_rows: int    # query rows of a dK/dV block's tiles
    q_rows: int     # query rows a dQ block
    q_keys: int     # keys of a dQ block's tiles
    threads: int


def block_config(D: int) -> Blocks:
    """The blocks the kernel runs at head width ``D`` (1 to 256): up to 64
    columns a dK/dV block of 128 keys over 64-row query tiles and a dQ
    block of 128 rows over 64-key tiles; up to 128, 64 by 64 in both; above,
    32 by 32.  256 threads, one block an SM."""
    if not 1 <= D <= 256:
        raise ValueError(f"flash_attention_bwd: head width {D} is not in [1, 256]")
    if D <= 64:
        return Blocks(64, 128, 64, 128, 64, 256)
    if D <= 128:
        return Blocks(128, 64, 64, 64, 64, 256)
    return Blocks(256, 32, 32, 32, 32, 256)


def kernel_blocks(D: int) -> Blocks:
    """The compiled kernel's own blocks at head width ``D`` (builds the
    library: on the card only), to hold :func:`block_config` to."""
    fn = build.load("flash_attention_bwd").flash_attention_bwd_blocks
    fn.argtypes, fn.restype = [ctypes.c_int64, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int64 * len(Blocks._fields))()
    if fn(D, ctypes.addressof(out)) != 0:
        raise ValueError(f"flash_attention_bwd: head width {D} is not taken")
    return Blocks(*out)


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention_bwd").flash_attention_bwd
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = ([ptr] * 10 + [i64] * 6 + [i64] * 15
                       + [ctypes.c_int, ctypes.c_int, i64, i64, ctypes.c_int,
                          ctypes.c_float, ctypes.c_float, ptr])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, o, lse, do) -> None:
    _fa._check_shapes(q, k, v)
    B, Hq, Tq, D = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do {tuple(do.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    if o.stride(3) != 1 or do.stride(3) != 1:
        raise ValueError("flash_attention_bwd: o and do need unit stride in the head dimension")
    if any(t.dtype != torch.float32 for t in (q, k, v, o, do)):
        raise TypeError(f"flash_attention_bwd: float32 q, k, v, o and do only (bfloat16 goes to "
                        f"flash_attention_bwd_sm90), got {q.dtype}, {k.dtype}, {v.dtype}, "
                        f"{o.dtype}, {do.dtype}")
    if lse.shape != (B, Hq, Tq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be contiguous float32 {(B, Hq, Tq)}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    if q.device.type != "cuda" or any(t.device != q.device for t in (k, v, o, lse, do)):
        raise ValueError(f"flash_attention_bwd: the kernel takes CUDA tensors on one device, "
                         f"got {q.device}, {k.device}, {v.device}, {o.device}, {lse.device}, "
                         f"{do.device}")
    if B > _fa._MAX_GRID_YZ or Hq > _fa._MAX_GRID_YZ:
        raise ValueError(f"flash_attention_bwd: batch {B} or {Hq} heads exceed "
                         f"{_fa._MAX_GRID_YZ}")


def flash_attention_bwd_cuda(
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, o, do: (B, Hq, Tq, D), k, v: (B, Hkv, Tk, D), float32, unit
    stride in D; lse: contiguous float32 (B, Hq, Tq), the forward's row
    log-sum-exp -> contiguous float32 (dq, dk, dv)."""
    global launches
    _check(q, k, v, o, lse, do)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    if dq.numel() == 0:
        dk.zero_()
        dv.zero_()
        return dq, dk, dv
    fn = _kernel()
    B, Hq, Tq, D = q.shape
    delta = torch.empty((B, Hq, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 B, Hq, k.shape[1], Tq, k.shape[2], D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                 *do.stride()[:3],
                 int(causal), int(window is not None), int(window or 0), int(q_offset),
                 int(softcap is not None), float(softcap or 0.0), float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd: kernel launch failed with CUDA error {err}")
    launches += 1
    return dq, dk, dv
