"""CUDA kernel for the backward of GQA online-softmax (flash) attention on
bf16 inputs, on Hopper's tensor cores (``flash_attention_bwd.py`` keeps
the float32 backward).

Replaces no TPU kernel: ``repro/kernels/flash_attention.py`` is forward
only, and the reference trains through ``models/layers.py::
_blockwise_attention``, whose gradient ``jax.grad`` takes.  This is that
gradient on the card for bfloat16 q, k, v, o and do.  The kernel
(``csrc/flash_attention_bwd_sm90.cu``) runs three launches: ``delta =
rowsum(do * o)`` with the row lse in log2 units; one block per key block
of a kv head that walks the query heads and 64-row tiles seeing its keys
and writes dK and dV once; one block per query-row block of a query head
that walks the live 64-key tiles and writes dQ once.  Each recomputes S
and dP, and every product (S, dP, dV, dK, dQ) is a ``wgmma`` on tiles
that TMA loads, with float32 sums.  No atomics: two calls on one input
give bit-equal gradients.  Its plain version is
``repro_torch.kernels.ref.ref_flash_attention_backward``.

At a head width up to 64 (seamless's) each block is two consumer
warpgroups of 64 keys or rows that take turns at the tensor cores, so one's
elementwise work runs while the other's products run, and each runs a
tile's exponentials while its previous tile's gradient products run; the
dQ pass's beside a producer warp that issues every load, the dK/dV pass's
alone (their warps issue the loads, a tile's four copies by four warps);
from 65 to 128 (danube's 120, olmo's 128) two such consumer warpgroups
over the head's two 64-column atoms, the dQ pass's beside a producer
warpgroup, the dK/dV pass's alone (one of their threads issues the loads);
from 136 to 256 (recurrentgemma's 256) two consumer warpgroups over
one 64-row tile of keys or query rows, each holding half of the gradient's
columns and computing half of each tile's S and dP, whose bf16 parts both
read from shared memory.  :func:`block_config` gives each, as the kernel's
``flash_attention_bwd_sm90_blocks`` reports them (:func:`kernel_blocks`).

Up to 128 columns every product runs on fp16 operands: two more launches
first take the largest |x| of q, k, v and do and write fp16 copies of q, k
and v, each times a power of two of its own (:func:`fp16_exponent`; the
stats launch converts do), and P and dS go to the tensor cores rounded once
to fp16, where the widths from 136 carry them as two bf16 parts.
:func:`fp16_copy` is the conversion's plain version.  The wrapper allocates
the copies and the conversion's scratch (its size the library's
``flash_attention_bwd_sm90_aux_floats``).

``launches`` counts the wrapper's calls that launch the kernel (one a
backward, its three or five launches together), and nothing else;
``fp16_launches`` the calls among them that converted to fp16.  A run
reads them to show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as _fa

launches = 0
fp16_launches = 0

_fn = None
_aux_floats = None   # the float32 scratch of the fp16 conversion, as the library reports it

_ROWS = 64   # the kernel's tile rows: the scratch pads Tq to a multiple of it


class Blocks(NamedTuple):
    """The kernel's blocks at one head width (``csrc/flash_attention_bwd_sm90.cu``,
    ``flash_attention_bwd_sm90_blocks``)."""
    kv_keys: int      # keys a dK/dV block
    kv_splits: int    # blocks that split one key block's dK, dV columns
    kv_threads: int
    q_rows: int       # query rows a dQ block
    q_threads: int
    q_tile: int       # query rows a tile of the dK/dV pass
    k_tile: int       # keys a tile of the dQ pass
    pad: int          # the scratch pads Tq to a multiple of this


def block_config(D: int) -> Blocks:
    """The blocks the kernel runs at head width ``D``: up to 128 two
    consumer warpgroups of 64 keys or rows, alone in a dK/dV block (256
    threads, which issue the loads themselves) and beside a producer in a
    dQ block (a warp up to 64, 288 threads; a warpgroup above, 384); above,
    two consumer warpgroups over one 64-row tile of keys or rows (256
    threads), each holding half of the gradient's columns."""
    if not 8 <= D <= 256 or D % 8:
        raise ValueError(f"flash_attention_bwd_sm90: head width {D} is not a multiple of 8 "
                         f"in [8, 256]")
    if D <= 64:
        return Blocks(128, 1, 256, 128, 288, _ROWS, _ROWS, _ROWS)
    if D <= 128:
        return Blocks(128, 1, 256, 128, 384, _ROWS, _ROWS, _ROWS)
    return Blocks(64, 1, 256, 64, 256, _ROWS, _ROWS, _ROWS)


def converts_to_fp16(D: int) -> bool:
    """Whether the kernel runs its products on fp16 copies at head width ``D``."""
    return D <= 128


def fp16_exponent(amax: torch.Tensor) -> torch.Tensor:
    """The power of two ``e`` (int32, ``amax``'s shape) by which the kernel
    multiplies a bf16 tensor whose largest magnitude is ``amax`` (a bf16
    value) before rounding it to fp16: ``2^15 <= amax 2^e <= 65280``, so
    nothing overflows fp16's 65504 and every value of ``2^-32 amax`` or
    more converts exactly (a bf16 value has 8 significant bits, fp16's
    subnormals are multiples of 2^-24); at most 127, where ``amax`` is 0 or
    below 2^-112.  ``csrc/flash_attention_bwd_sm90.cu::fp16_exponent``
    mirrors it on the float's bits."""
    e8 = (amax.float().abs().view(torch.int32) >> 23) & 0xFF
    return torch.where(e8 == 0, 127, (142 - e8).clamp(max=127)).to(torch.int32)


def fp16_copy(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the kernel's conversion of a bf16 tensor: (``x
    2^e`` rounded to fp16, ``e``), ``e = fp16_exponent(max |x|)``."""
    e = fp16_exponent(x.abs().max())
    return (x.float() * torch.exp2(e.float())).half(), e


# the forward kernel's v tiles at head widths up to 64 (keys); the most a
# tile's exponent rises over the one before, and its bound, also that of a
# tile of zeros before any other (csrc/flash_attention_sm90.cu d64::kExpRise,
# kExpNone)
V_TILE, EXP_RISE, EXP_NONE = 128, 64, 112


def fp16_tiles(v: torch.Tensor, tiles: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the forward kernel's conversion of v at head
    widths up to 64, in shared memory tile by tile along a block's walk: v
    (..., T, D) bf16 as ``tiles`` 128-key tiles (default all of T; keys past
    T are zeros, as TMA fills them), each times 2^e_t in fp16, e_t =
    ``fp16_exponent`` of the tile's largest |v| within [-EXP_NONE,
    EXP_NONE], at most ``EXP_RISE`` above e_(t-1), and e_(t-1) where the
    tile is all zeros (e_(-1) = EXP_NONE).  The kernel moves each value's
    bits to fp16's fields (its magnitude first raised to (112 - e_t) 2^7,
    then rebased and shifted left 3): exact where the result is an fp16
    normal, under 2^-14 where it would fall below fp16's normal range.
    Returns (the fp16 tiles (..., tiles 128, D), e (..., tiles) int32)."""
    n = -(-v.shape[-2] // V_TILE) if tiles is None else tiles
    x = torch.nn.functional.pad(v.to(torch.bfloat16), (0, 0, 0, n * V_TILE - v.shape[-2]))
    bits = (x.view(torch.int16).to(torch.int32) & 0xFFFF).unflatten(-2, (n, V_TILE))
    mag = bits & 0x7FFF
    amax = mag.amax(dim=(-2, -1))
    e_tile = fp16_exponent((amax << 16).view(torch.float32)).clamp(-EXP_NONE, EXP_NONE)
    e = torch.empty_like(e_tile)
    prev = torch.full(e.shape[:-1], EXP_NONE, dtype=torch.int32)
    for t in range(n):
        prev = torch.where(amax[..., t] == 0, prev, torch.minimum(e_tile[..., t], prev + EXP_RISE))
        e[..., t] = prev
    k = ((112 - e) << 7)[..., None, None]
    h = ((torch.maximum(mag, k) - k) << 3) | (bits & 0x8000)
    h = (h - ((h >> 15) << 16)).to(torch.int16)          # the same 16 bits, signed
    return h.view(torch.float16).flatten(-3, -2), e


def stats_shape(B: int, Hq: int, Tq: int, D: int) -> Tuple[int, int, int, int]:
    """The float32 scratch of lse2 and delta: (2, B, Hq, Tq padded)."""
    pad = block_config(D).pad
    return (2, B, Hq, -(-Tq // pad) * pad)


def kernel_blocks(D: int) -> Blocks:
    """The compiled kernel's own blocks at head width ``D`` (builds the
    library: on the card only), to hold :func:`block_config` to."""
    fn = build.load("flash_attention_bwd_sm90").flash_attention_bwd_sm90_blocks
    fn.argtypes, fn.restype = [ctypes.c_int64, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int64 * len(Blocks._fields))()
    if fn(D, ctypes.addressof(out)) != 0:
        raise ValueError(f"flash_attention_bwd_sm90: head width {D} is not taken")
    return Blocks(*out)


def _kernel():
    global _fn, _aux_floats
    if _fn is None:
        lib = build.load("flash_attention_bwd_sm90")
        aux = lib.flash_attention_bwd_sm90_aux_floats
        aux.argtypes, aux.restype = [], ctypes.c_int
        _aux_floats = aux()
        fn = lib.flash_attention_bwd_sm90
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = ([ptr] * 15 + [i64] * 6 + [i64] * 15
                       + [ctypes.c_int, ctypes.c_int, i64, i64, ctypes.c_int,
                          ctypes.c_float, ctypes.c_float, ptr])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, o, lse, do) -> None:
    _fa._check_shapes(q, k, v)
    B, Hq, Tq, D = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd_sm90: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must have q's shape {tuple(q.shape)}")
    if o.stride(3) != 1 or do.stride(3) != 1:
        raise ValueError("flash_attention_bwd_sm90: o and do need unit stride in the head "
                         "dimension")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, o, do)):
        raise TypeError(f"flash_attention_bwd_sm90: bfloat16 q, k, v, o and do only, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}, {o.dtype}, {do.dtype}")
    if lse.shape != (B, Hq, Tq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd_sm90: lse must be contiguous float32 "
                         f"{(B, Hq, Tq)}, got {lse.dtype} {tuple(lse.shape)}")
    if D % 8:
        raise ValueError(f"flash_attention_bwd_sm90: head width {D} is not a multiple of 8")
    named = (("q", q), ("k", k), ("v", v), ("o", o), ("do", do))
    for name, t in named:
        # TMA and 16-byte loads read rows from 16-byte aligned addresses; a
        # size-1 dimension is never stepped, so its stride does not matter
        if any(t.stride(i) % 8 for i in range(3) if t.shape[i] > 1):
            raise ValueError(f"flash_attention_bwd_sm90: {name}'s strides {t.stride()} are "
                             f"not multiples of 8 elements (16 bytes)")
    if q.device.type != "cuda" or any(t.device != q.device for t in (k, v, o, lse, do)):
        raise ValueError(f"flash_attention_bwd_sm90: the kernel takes CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}, {o.device}, "
                         f"{lse.device}, {do.device}")
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd_sm90: {name} does not start on a 16-byte "
                             f"boundary ({t.data_ptr():#x})")
    if B > _fa._MAX_GRID_YZ or Hq > _fa._MAX_GRID_YZ:
        raise ValueError(f"flash_attention_bwd_sm90: batch {B} or {Hq} heads exceed "
                         f"{_fa._MAX_GRID_YZ}")


def flash_attention_bwd_sm90_cuda(
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
    """q, o, do: (B, Hq, Tq, D), k, v: (B, Hkv, Tk, D), bfloat16 CUDA
    tensors, unit stride in D, D a multiple of 8, strides multiples of 8;
    lse: contiguous float32 (B, Hq, Tq), the forward's row log-sum-exp ->
    contiguous bfloat16 (dq, dk, dv)."""
    global launches, fp16_launches
    _check(q, k, v, o, lse, do)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    if dq.numel() == 0 or k.shape[2] == 0:   # no row, or no key: every row fully masked
        dq.zero_()
        return dq, dk.zero_(), dv.zero_()
    fn = _kernel()
    B, Hq, Tq, D = q.shape
    stats = torch.empty(stats_shape(B, Hq, Tq, D), dtype=torch.float32, device=q.device)
    f16 = converts_to_fp16(D)
    # the fp16 copies of q, k, v and do and the conversion's scratch
    half = ([torch.empty(t.shape, dtype=torch.float16, device=t.device) for t in (q, k, v, do)]
            + [torch.empty(_aux_floats, dtype=torch.float32, device=q.device)]) if f16 else []
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 *([t.data_ptr() for t in half] if f16 else [None] * 5),
                 B, Hq, k.shape[1], Tq, k.shape[2], D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                 *do.stride()[:3],
                 int(causal), int(window is not None), int(window or 0), int(q_offset),
                 int(softcap is not None), float(softcap or 0.0), float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_sm90: kernel launch failed with CUDA error "
                           f"{err}")
    launches += 1
    fp16_launches += f16
    return dq, dk, dv
