"""CUDA kernel for GQA online-softmax (flash) attention on float32 inputs,
forward (``flash_attention_bwd.py`` has the backward).

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas`` for
float32 inputs (``ops.flash_attention`` sends bfloat16 inputs to
``flash_attention_sm90.py``'s tensor-core kernel).
The kernel (``csrc/flash_attention.cu``) runs one block per tile of
stacked query rows, a few positions of every query head that shares a kv
head (:func:`tiling`), so each K/V tile is read once for the group; it
walks only the key tiles that a causal or sliding-window mask leaves
live, brings them in through a two-stage ``cp.async`` ring that overlaps
the next tile's copies with this tile's arithmetic, and keeps the online
softmax's running max, normaliser and accumulator in registers.  Its
float32 arithmetic on the CUDA cores bounds it.  With ``return_lse`` it
also writes each row's log-sum-exp, which the backward reads.  Its plain
version is ``repro_torch.kernels.ref.ref_flash_attention``.

``launches`` counts the kernel's launches, and nothing else; a run reads
it to show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.kernels import build

launches = 0
MAX_HEAD_DIM = 256
_MAX_GRID_YZ = 65535

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention_fwd
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = ([ptr] * 4 + [i64] * 6 + [i64] * 9
                       + [ctypes.c_int, ctypes.c_int, i64, i64, ctypes.c_int,
                          ctypes.c_float, ctypes.c_float, i64, i64, i64, ptr, ptr])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


class Tiling(NamedTuple):
    """How the kernel cuts one call: ``head_pad`` columns of q, k and v in
    shared memory, and blocks of ``rows`` positions of ``heads`` query
    heads of one kv head (``rows * heads`` stacked rows)."""

    head_pad: int
    rows: int
    heads: int


def tiling(Hq: int, Hkv: int, D: int) -> Tiling:
    """The kernel's layout for a head width D (the smallest of 64, 128 and
    256 columns that holds it: 128 stacked rows, or 64 at 256 columns) and
    its GQA stacking: the G = Hq / Hkv heads of a kv head share each
    block's K/V tiles, ``rows`` positions each (a power of two, at least 16,
    so that every 8-row warp lies in one head), so that ``heads = stacked
    / rows`` heads fill the block; a group that does not divide into them leaves its last block's
    extra heads empty.  The grid is (position tiles of ``rows``, kv heads
    x head chunks of ``heads``, batch)."""
    head_pad = 64 if D <= 64 else 128 if D <= 128 else 256
    stacked = 64 if head_pad == 256 else 128
    group = Hq // Hkv
    rows = 16
    while rows < stacked and rows * group < stacked:
        rows *= 2
    return Tiling(head_pad, rows, stacked // rows)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Ranks, shapes, head grouping, head width and unit stride in D."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be (B, Hq, Tq, D) and k, v (B, Hkv, Tk, D) "
                         f"of one shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: batch and head width of q {tuple(q.shape)} and "
                         f"k {tuple(k.shape)} differ")
    if k.shape[1] == 0 or Hq % k.shape[1]:
        raise ValueError(f"flash_attention: {Hq} query heads do not group over "
                         f"{k.shape[1]} kv heads")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head width {D} outside 1..{MAX_HEAD_DIM}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v need unit stride in the head dimension")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    _check_shapes(q, k, v)
    B, Hq = q.shape[:2]
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError(f"flash_attention: float32 inputs only, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: the kernel takes CUDA tensors on one device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if B > _MAX_GRID_YZ or Hq > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention: batch {B} or {Hq} heads exceed {_MAX_GRID_YZ}")


def flash_attention_cuda(
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
    """q: (B, Hq, Tq, D), k, v: (B, Hkv, Tk, D) float32 CUDA tensors, unit
    stride in D -> contiguous (B, Hq, Tq, D) float32; with ``return_lse``
    also each row's log-sum-exp, contiguous float32 (B, Hq, Tq), -inf
    where a row sees no key."""
    global launches
    _check(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    fn = _kernel()
    B, Hq, Tq, D = q.shape
    tile = tiling(Hq, k.shape[1], D)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Hq, k.shape[1], Tq, k.shape[2], D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 int(causal), int(window is not None), int(window or 0), int(q_offset),
                 int(softcap is not None), float(softcap or 0.0), float(D ** -0.5),
                 tile.head_pad, tile.rows, tile.heads,
                 lse.data_ptr() if return_lse else None, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    launches += 1
    return (out, lse) if return_lse else out
