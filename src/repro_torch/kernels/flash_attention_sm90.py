"""CUDA kernel for GQA online-softmax (flash) attention on bf16 inputs,
on Hopper's tensor cores, forward (``flash_attention_bwd.py`` has the
backward).

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas`` for
bfloat16 q, k and v (``ops.flash_attention`` sends float32 inputs to
``flash_attention.py``'s kernel).  The kernel
(``csrc/flash_attention_sm90.cu``) runs q k^T and P V as ``wgmma`` on bf16
tiles that TMA brings into a ring in shared memory, with P split into two
bf16 parts and m, l and the accumulator in float32, and walks only the
live key tiles.  At a width of 64 or less a block holds one warpgroup of 64 rows for up to 64 query rows,
and otherwise 128 or 192 rows (:func:`block_rows`, by how well each fills
the card's waves of blocks) in two or three consumer warpgroups beside a
producer warpgroup, over 128-key tiles, the consumers taking turns at the
tensor cores so that one's softmax runs while the others' products run;
from 65 to 128 columns (danube's 120,
olmo's 128) the same over the head's two 64-column atoms, for any number
of rows.  From
136 to 256 columns (recurrentgemma's 256) a block holds 128 query rows in
two consumer warpgroups alone, over 64-key tiles of the head's four atoms,
taking turns at the tensor cores (64 rows of two query heads of a kv head
where the group is even, so that each k and v tile serves both); one of
their threads keeps the k and v loads in flight, in rings of their own.
With ``return_lse`` it also writes each row's log-sum-exp, which the
backward reads.  Its plain version is
``repro_torch.kernels.ref.ref_flash_attention``.

P is never rounded once to fp16 against an fp16 v (which would halve P
V's tensor time): where a row's weight sits on a few keys (peaked scores,
as trained models give) one rounding breaks the output's limit (2^-7
|want| + 1e-4) at any count of keys from 1100 to 16384, by up to 2.6x at
64 columns and 2.5x at 128, where two parts hold it
(``tools/emulate_fp16_attention.py --peaked``: 13 and 16 of 36 draws over,
two parts at most 0.98).

At a width of 64 or less, a call with fewer than two waves of blocks (a
decode step's cross-attention, a short prompt's) may split its live keys
into ranges (:func:`split_count`, ``ref.split_ranges``): one block per (row
block, range) writes the range's float32 output and lse, and the last
block of each row block to finish merges the ranges, in the same launch
(it finds that it is last by an arrival counter that the wrapper keeps
zeroed, one a row block, a buffer per device and stream).  It splits only
where that fills the waves better: S ranges make each block about 1/S of
the work, so the call takes about ceil(blocks S / SMs) / S waves of whole
blocks, and a count that does not lower that only adds the merge.  On an
H100 (PERF.md) a decode step's 64 blocks ran fastest in 2 ranges
and 192 blocks in 2, while 128 and 256 blocks (one and two full waves,
the prefill's cross-attention) ran fastest unsplit.  The plain versions
are ``ref.ref_flash_attention_partials`` and ``ref.ref_merge_attention``.

``launches`` counts the wrapper's calls that launch the kernel (one
launch a call), and nothing else; a run reads it to show that its path
went through the kernel.  ``split_launches`` counts those of them that
split their keys (and merged them), ``d64_launches`` those at head widths
up to 64 by the rows a block of the configuration they ran (64, 128 or
192).
"""

from __future__ import annotations

import ctypes
from fractions import Fraction
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref

launches = 0
split_launches = 0
d64_launches = {64: 0, 128: 0, 192: 0}   # calls at widths up to 64 by rows a block
# a call may split its keys when it has fewer blocks than this many waves
# of one block an SM, into at most enough ranges for SPLIT_WAVES waves
SPLIT_BELOW_WAVES, SPLIT_WAVES = 2, 4

_fn = None
_sm_counts = {}
_arrivals = {}      # (device index, stream) -> zeroed uint32 arrival counters


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention_sm90").flash_attention_sm90_fwd
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = ([ptr] * 4 + [i64] * 6 + [i64] * 9
                       + [ctypes.c_int, ctypes.c_int, i64, i64, ctypes.c_int,
                          ctypes.c_float, ctypes.c_float, ptr, i64, i64, i64, ptr, ptr, ptr,
                          i64, ptr])
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


def block_rows(B: int, Hq: int, Tq: int, D: int, sm_count: int) -> int:
    """Query rows a block of the kernel's configuration for Tq query rows of
    B x Hq heads of width D on ``sm_count`` SMs: at a width up to 64, 64 (one
    consumer warpgroup) up to 64 rows; above, 192 (three) where
    ceil(blocks / SMs) waves of 192-row blocks hold no more rows of an SM's
    time than those of 128-row blocks (two), else 128 (the encoder's 32768
    rows of 64 heads take 192, 83 waves against 125 of 128; the prefill's
    cross-attention's 512 take 128, two waves either way).  Above a width of
    64, 128 (two consumer warpgroups beside a producer up to 128 columns, two
    alone above, where an even group's block holds 64 rows of two query
    heads instead: 128 (row, head) pairs all the same).  Every configuration
    runs one block an SM.  A pure function of the shape and the SM count;
    the kernel runs the configuration of the rows it is passed."""
    if D > 64:
        return 128
    if Tq <= 64:
        return 64

    def held(rows):     # rows of an SM's time the call's waves of blocks take
        return -(-(B * Hq * -(-Tq // rows)) // sm_count) * rows

    return 192 if held(192) <= held(128) else 128


def split_count(B: int, Hq: int, Tq: int, Tk: int, D: int, *, causal: bool,
                window: Optional[int], q_offset: int, sm_count: int) -> int:
    """Key ranges S of a call: 1 above a head width of 64 (that
    configuration does not split), and when its blocks (B x Hq x row
    blocks, see :func:`block_rows`) make ``SPLIT_BELOW_WAVES`` waves of one
    block an SM.  Below that, of the counts up to enough ranges for
    ``SPLIT_WAVES`` waves and at most one for each whole 512-key chunk of
    the live keys (``ref.split_ranges``), the smallest S whose waves of
    blocks a unit of work, ceil(blocks S / SMs) / S, are fewest: a range
    is about 1/S of a block's keys, and a split that does not fill the
    waves better only adds the merge.  A pure function of the shape, the
    mask and the SM count, so two calls of one shape split alike."""
    blocks = B * Hq * -(-Tq // block_rows(B, Hq, Tq, D, sm_count))
    if D > 64 or blocks == 0 or blocks >= SPLIT_BELOW_WAVES * sm_count:
        return 1
    lo, hi = _ref.key_span(Tq, Tk, causal=causal, window=window, q_offset=q_offset)
    chunks = (hi - lo) // _ref.SPLIT_KEYS
    most = max(1, min(-(-SPLIT_WAVES * sm_count // blocks), chunks))
    return min(range(1, most + 1), key=lambda S: (Fraction(-(-blocks * S // sm_count), S), S))


def split_plan(Tq: int, Tk: int, splits: int, *, causal: bool, window: Optional[int],
               q_offset: int) -> Tuple[int, int]:
    """(lo, chunks) that the kernel reads ``ref.split_ranges``'s ranges
    from: range s starts at lo + 512 floor(s chunks / splits); (0, 0) for
    one range.  Raises for more ranges than whole chunks."""
    if splits < 1:
        raise ValueError(f"flash_attention_sm90: {splits} key ranges")
    if splits == 1:
        return 0, 0
    _ref.split_ranges(Tq, Tk, splits, causal=causal, window=window, q_offset=q_offset)
    lo, hi = _ref.key_span(Tq, Tk, causal=causal, window=window, q_offset=q_offset)
    chunks = (hi - lo) // _ref.SPLIT_KEYS
    if splits * chunks >= 2 ** 31:     # the kernel computes range bounds in 32 bits
        raise ValueError(f"flash_attention_sm90: {splits} ranges of {chunks} chunks")
    return lo, chunks


def _arrival_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """``n`` or more zeroed arrival counters for split calls on ``stream``.
    A split launch leaves every counter it used at zero, so the buffer is
    zeroed once and kept; calls on one stream run in order, and another
    stream gets a buffer of its own."""
    key = (device.index, stream)
    buf = _arrivals.get(key)
    if buf is None or buf.numel() < n:
        buf = _arrivals[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


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
    splits: Optional[int] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """q: (B, Hq, Tq, D), k, v: (B, Hkv, Tk, D) bfloat16 CUDA tensors, unit
    stride in D, D a multiple of 8 -> contiguous (B, Hq, Tq, D) bfloat16;
    with ``return_lse`` also each row's log-sum-exp, contiguous float32
    (B, Hq, Tq), -inf where a row sees no key.  ``splits``: the key ranges
    (default :func:`split_count`'s); with more than one the launch also
    merges them."""
    global launches, split_launches
    _check(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if k.shape[2] == 0:     # no key at all: every row is fully masked
        out.zero_()
        return (out, lse.fill_(float("-inf"))) if return_lse else out
    B, Hq, Tq, D = q.shape
    Tk = k.shape[2]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    sms = _sm_count(q.device)
    if splits is None:
        splits = split_count(B, Hq, Tq, Tk, D, **kw, sm_count=sms)
    if splits > 1 and D > 64:
        raise ValueError(f"flash_attention_sm90: key ranges at a head width up to 64 only, "
                         f"got {D}")
    lo, chunks = split_plan(Tq, Tk, splits, **kw)      # raises before any build
    rows = block_rows(B, Hq, Tq, D, sms)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part = lse_part = arrivals = None
        if splits > 1:
            part = torch.empty((B, Hq, splits, Tq, D), dtype=torch.float32, device=q.device)
            lse_part = torch.empty((B, Hq, splits, Tq), dtype=torch.float32, device=q.device)
            arrivals = _arrival_counters(q.device, stream, B * Hq * -(-Tq // rows))
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Hq, k.shape[1], Tq, Tk, D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 int(causal), int(window is not None), int(window or 0), int(q_offset),
                 int(softcap is not None), float(softcap or 0.0), float(D ** -0.5),
                 lse.data_ptr() if return_lse else None, splits, lo, chunks,
                 part.data_ptr() if part is not None else None,
                 lse_part.data_ptr() if lse_part is not None else None,
                 arrivals.data_ptr() if arrivals is not None else None, rows, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_sm90: kernel launch failed with CUDA error {err}")
    launches += 1
    if D <= 64:
        d64_launches[rows] += 1
    if splits > 1:
        split_launches += 1
    return (out, lse) if return_lse else out
