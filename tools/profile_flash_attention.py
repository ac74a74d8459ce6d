#!/usr/bin/env python3
"""Where the attention kernels spend their time, on one card.

The forward: builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` a
second time with ``-DFLASH_PHASE_CLOCKS`` (every warp adds up the SM clocks
it spends in each phase of its tile loop), runs it at the long serving
path's shape in float32 (h2o-danube3-4b: q (4, 32, 8192, 120), k and v
(4, 8, 8192, 120), window 4096) and prints, beside the kernel's time with
and without the clocks:

- each phase's share of the warps' clocks: waiting at the tile barrier,
  issuing the next tile's copies, the score loop, the softmax, the P.V
  loop;
- for the two FMA loops, the share of the scheduler's issue slots that
  their FMAs fill (each of an SM's four schedulers issues one warp
  instruction a clock, and hosts a quarter of the block's warps).

The backward: the same for ``csrc/flash_attention_bwd.cu`` at danube's
training shape in float32 (q (1, 32, 8192, 120), k and v (1, 8, 8192,
120), window 4096), for each of its two passes (dK/dV and dQ): waiting
for the tile's copies (with the tile barrier), issuing the next tile's
copies, the S and dP loop, the softmax and masks (with the P and dS
stores and their barrier), the gradient products.

The bf16 backward at head widths 136-256: the same for
``csrc/flash_attention_bwd_sm90.cu``'s ``d256`` passes at recurrentgemma-2b's
training shape (q (1, 10, 8192, 256), k and v (1, 1, 8192, 256), window
2048): waiting for the tile's loads, S and dP issued, S and dP waited for
(the wait also ends the previous tile's gradient products), the stage
released and the next tile issued, P and dS, the barrier before the shared
parts, the parts stored, their proxy fence, their barrier, the gradient
products issued.  And at head widths up to 64, its ``d64`` passes at
seamless-m4t-large-v2's encoder (2, 16, 8192, 64), unmasked: waiting for
the tile's loads, waiting for the consumer's turn, the products issued
(this tile's S and dP, the previous tile's gradients) and the turn passed,
a later tile's loads issued (the dK/dV pass's consumers), the products
waited for, P and dS rounded to fp16 (in the dQ pass with the stage
released), P and dS (the exponentials).  And at head widths 65-128, its
``d128`` dK/dV pass at olmo-1b's training shape (2, 16, 8192, 128), plain
causal: the ``d64`` pass's phases, by the warps' own count of their turns.

The bf16 forward at head widths 65-128 (``--what bf16-forward``): the same
for ``csrc/flash_attention_sm90.cu``'s ``d128`` kernels at olmo-1b's
training and serving shapes ((2, 16, 8192, 128) and (4, 16, 32768, 128),
plain causal), the launch of the one-part row blocks and that of the
two-part ones apart: waiting for a stage's loads, waiting for the turn,
the products issued and the turn passed, waiting for P V to drain,
waiting for S, the softmax, P rounded; each in clocks a warp a turn, by
the warps' own count of their turns.

Usage, from the root of a checkout::

    python3 tools/profile_flash_attention.py [--root DIR]
        [--what all|forward|backward|bf16-backward|bf16-forward]

``--root`` imports the port from another checkout's ``src/`` and builds
its sources with the clocks, so that one command can profile two versions.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--what", choices=("all", "forward", "backward", "bf16-backward",
                                   "bf16-forward"), default="all")
ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                help="checkout whose src/ holds the port to profile (default: this one)")
ARGS = ap.parse_args()
sys.path.insert(0, os.path.join(os.path.abspath(ARGS.root), "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402
from repro_torch.kernels import flash_attention_bwd_sm90 as fab90  # noqa: E402
from repro_torch.kernels import flash_attention_sm90 as fa90  # noqa: E402

ARCH, BATCH, T = "h2o-danube-3-4b", 4, 8192
TRAIN_BATCH = 1
PHASES = ("barrier", "copy issue", "score loop", "softmax", "P.V loop")
ROWS_PER_WARP, ROWS_PER_THREAD, SCHEDULERS = 8, 4, 4   # csrc/flash_attention.cu
BWD_PASSES = ("dK/dV", "dQ")
BWD_PHASES = ("copy wait", "copy issue", "S and dP", "softmax and masks", "gradient products")
BWD_WARPS = 8                                          # csrc/flash_attention_bwd.cu
BF16_ARCH = "recurrentgemma-2b"                        # the d256 passes' shape
BF16_PHASES = ("load wait", "S and dP issued", "S and dP waited", "release and issue",
               "P and dS", "parts barrier", "parts stored", "parts fence", "ready barrier",
               "gradient products issued")
BF16_WARPS = 8                                         # csrc/flash_attention_bwd_sm90.cu, d256
D64_ARCH, D64_BATCH = "seamless-m4t-large-v2", 2       # the d64 passes' shape: its encoder
D64_PHASES = ("load wait", "turn wait", "products issued", "loads issued", "products waited",
              "fp16 parts", "P and dS")
D64_WARPS, D64_ROWS = 8, 128                           # consumer warps, keys or rows a block
OLMO_ARCH = "olmo-1b"                                  # the d128 kernels' shapes, plain causal
OLMO_FWD_SHAPES = (("olmo train forward", 2, 8192), ("olmo prefill", 4, 32768))
OLMO_TRAIN = (2, 8192)
FWD_PASSES = ("one part", "two parts")
FWD_PHASES = ("load wait", "turn wait", "products issued", "P V drained", "S waited",
              "softmax", "P rounded")
FWD_CLOCK_PHASES = 8                                   # kFwdPhases: the phases, then turns


def build_clocked(source, entry, argtypes, reader):
    """``source`` built with the phase clocks: (its entry point, its clock reader)."""
    out = build.BUILD_DIR / f"lib{source}_clocks.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-DFLASH_PHASE_CLOCKS", "-o", str(out),
                    str(build.CSRC / f"{source}.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    read = getattr(lib, reader)
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    return fn, read


def warp_tiles(tile, Tq, Tk, window, BK):
    """Key tiles the kernel walks, summed over its blocks' warps, for one
    (batch, kv head) and causal attention with q_offset 0."""
    total = 0
    for x in range(-(-Tq // tile.rows)):
        q0 = x * tile.rows
        q_last = min(q0 + tile.rows, Tq) - 1
        k_begin = max(0, q0 - window + 1) // BK * BK
        k_end = min(Tk, q_last + 1)
        total += -(-(k_end - k_begin) // BK)
    return total * tile.rows * tile.heads // ROWS_PER_WARP


def cuda_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_forward(smi):
    cfg = get_config(ARCH)
    Hq, Hkv, D, window = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
    g = torch.Generator(device="cuda").manual_seed(12)
    q = torch.randn((BATCH, Hq, T, D), generator=g, device="cuda")
    k = torch.randn((BATCH, Hkv, T, D), generator=g, device="cuda")
    v = torch.randn((BATCH, Hkv, T, D), generator=g, device="cuda")
    run = lambda: fa.flash_attention_cuda(q, k, v, causal=True, window=window)  # noqa: E731
    plain_ms = cuda_ms(run)

    fn, clocks_read = build_clocked("flash_attention", "flash_attention_fwd",
                                    fa._kernel().argtypes, "flash_phase_clocks_read")
    saved, fa._fn = fa._kernel(), fn   # the wrapper, launching the clocked build
    try:
        clocked_ms = cuda_ms(run)
        clocks_read(None)
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 5)()
        clocks_read(buf)
    finally:
        fa._fn = saved
    clocks = list(buf)

    tile = fa.tiling(Hq, Hkv, D)
    BK = 32 if tile.head_pad == 256 else 64
    n = warp_tiles(tile, T, T, window, BK) * BATCH * Hkv * -(-(Hq // Hkv) // tile.heads)
    per_scheduler = tile.rows * tile.heads // ROWS_PER_WARP // SCHEDULERS
    fma = {"score loop": ROWS_PER_THREAD * (BK // 16) * 4 * -(-D // 4),
           "P.V loop": ROWS_PER_THREAD * 4 * (tile.head_pad // 64) * BK}
    total = sum(clocks)
    row = {"device": smi, "shape": [[BATCH, Hq, T, D], [BATCH, Hkv, T, D]], "window": window,
           "kernel_ms": plain_ms, "clocked_kernel_ms": clocked_ms,
           "phase_share": {name: c / total for name, c in zip(PHASES, clocks)},
           "fma_issue_share": {name: n * fma[name] * per_scheduler / clocks[PHASES.index(name)]
                               for name in fma}}
    print(json.dumps(row))
    print(f"flash_attention float32 {row['shape']} window {window}: {plain_ms:.3f} ms "
          f"({clocked_ms:.3f} ms with the phase clocks), on {smi}")
    for name, share in row["phase_share"].items():
        extra = (f", its FMAs fill {row['fma_issue_share'][name]:.1%} of the issue slots"
                 if name in fma else "")
        print(f"  {name}: {share:.1%} of the warps' clocks{extra}")


def bwd_tiles(blocks, Tq, Tk, group, window):
    """(dK/dV, dQ) tiles the backward's passes walk for one (batch, kv
    head), causal with q_offset 0, as csrc/flash_attention_bwd.cu walks
    them."""
    BK, BQ = blocks.kv_keys, blocks.kv_rows
    kv = 0
    for kt in range(0, Tk, BK):
        nk = min(BK, Tk - kt)
        lo = kt // BQ * BQ
        hi = min(Tq, kt + nk - 1 + window) if window is not None else Tq
        kv += group * max(0, -(-(hi - lo) // BQ))
    BQ, BK = blocks.q_rows, blocks.q_keys
    q = 0
    for q0 in range(0, Tq, BQ):
        last = min(q0 + BQ, Tq) - 1
        begin = max(0, q0 - window + 1) // BK * BK if window is not None else 0
        q += group * -(-(min(Tk, last + 1) - begin) // BK)
    return kv, q


def profile_backward(smi):
    cfg = get_config(ARCH)
    Hq, Hkv, D, window = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
    g = torch.Generator(device="cuda").manual_seed(13)
    q = torch.randn((TRAIN_BATCH, Hq, T, D), generator=g, device="cuda")
    k = torch.randn((TRAIN_BATCH, Hkv, T, D), generator=g, device="cuda")
    v = torch.randn((TRAIN_BATCH, Hkv, T, D), generator=g, device="cuda")
    do = torch.randn((TRAIN_BATCH, Hq, T, D), generator=g, device="cuda")
    o, lse = fa.flash_attention_cuda(q, k, v, causal=True, window=window, return_lse=True)
    run = lambda: fab.flash_attention_bwd_cuda(q, k, v, o, lse, do,  # noqa: E731
                                               causal=True, window=window)
    plain_ms = cuda_ms(run)

    fn, clocks_read = build_clocked("flash_attention_bwd", "flash_attention_bwd",
                                    fab._kernel().argtypes, "flash_bwd_phase_clocks_read")
    saved, fab._fn = fab._kernel(), fn   # the wrapper, launching the clocked build
    try:
        clocked_ms = cuda_ms(run)
        clocks_read(None)
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 10)()
        clocks_read(buf)
    finally:
        fab._fn = saved
    clocks = [list(buf)[:5], list(buf)[5:]]

    blocks = fab.block_config(D)
    NC, chunks = blocks.head_pad // 64, -(-D // 8) * 2    # float4 chunks of D, rounded up to even
    # FMAs a thread (a warp's FMA instructions) a tile: s and dp over the
    # chunks, then dV and dK (or dQ) over the tile's rows (or keys)
    kv_score = chunks * (blocks.kv_rows // 16) * (blocks.kv_keys // 16) * 8
    q_score = chunks * (blocks.q_rows // 16) * (blocks.q_keys // 16) * 8
    fma = {"dK/dV": {"S and dP": kv_score,
                     "gradient products": blocks.kv_rows * (blocks.kv_keys // 16) * NC * 8},
           "dQ": {"S and dP": q_score,
                  "gradient products": blocks.q_keys * (blocks.q_rows // 16) * NC * 4}}
    tiles = dict(zip(BWD_PASSES, bwd_tiles(blocks, T, T, Hq // Hkv, window)))
    per_scheduler = BWD_WARPS // SCHEDULERS
    row = {"device": smi, "shape": [[TRAIN_BATCH, Hq, T, D], [TRAIN_BATCH, Hkv, T, D]],
           "window": window, "kernel_ms": plain_ms, "clocked_kernel_ms": clocked_ms,
           "blocks": blocks._asdict(), "passes": {}}
    for i, name in enumerate(BWD_PASSES):
        c = clocks[i]
        n = tiles[name] * TRAIN_BATCH * Hkv * BWD_WARPS   # (warp, tile) pairs
        row["passes"][name] = {
            "tiles": tiles[name] * TRAIN_BATCH * Hkv,
            "phase_share": {p: x / sum(c) for p, x in zip(BWD_PHASES, c)},
            "clocks_per_warp_tile": {p: x / n for p, x in zip(BWD_PHASES, c)},
            "fma_issue_share": {p: n * f * per_scheduler / c[BWD_PHASES.index(p)]
                                for p, f in fma[name].items()}}
    print(json.dumps(row))
    print(f"flash_attention_bwd float32 {row['shape']} window {window}: {plain_ms:.3f} ms "
          f"({clocked_ms:.3f} ms with the phase clocks), on {smi}")
    for name, r in row["passes"].items():
        print(f"  {name} pass, {r['tiles']} tiles:")
        for p, share in r["phase_share"].items():
            extra = (f", its FMAs fill {r['fma_issue_share'][p]:.1%} of the issue slots"
                     if p in r["fma_issue_share"] else "")
            print(f"    {p}: {share:.1%} of the warps' clocks, "
                  f"{r['clocks_per_warp_tile'][p]:.0f} a warp a tile{extra}")


def d256_tiles(Tq, Tk, group, window, rows=64):
    """(dK/dV, dQ) 64-row tiles the d256 passes walk for one (batch, kv
    head), causal with q_offset 0."""
    kv = sum(group * -(-(min(Tq, kt + rows - 1 + window) - kt) // rows)
             for kt in range(0, Tk, rows))
    q = sum(group * -(-(min(Tk, q0 + rows) - max(0, q0 - window + 1) // rows * rows) // rows)
            for q0 in range(0, Tq, rows))
    return kv, q


def read_clocks(module, fn, clocks_read, run, passes, n):
    """The ``passes`` x ``n`` phase clocks of one ``run`` through the clocked
    build ``fn`` of ``module``'s kernel, and ``run``'s time with it."""
    saved, module._fn = module._kernel(), fn   # the wrapper, launching the clocked build
    try:
        clocked_ms = cuda_ms(run)
        clocks_read(None)
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (passes * n))()
        clocks_read(buf)
    finally:
        module._fn = saved
    return [list(buf)[i * n:(i + 1) * n] for i in range(passes)], clocked_ms


def bf16_clocks(fn, clocks_read, run):
    """The five passes' phase clocks (d256's (b) and (c), then d64's, then
    d128's (b)) of one ``run`` through the clocked build ``fn``, and
    ``run``'s time with it."""
    return read_clocks(fab90, fn, clocks_read, run, 5, 10)   # kClockPhases


def print_turns(title, passes, phases):
    """One JSON line, then each pass's phases in clocks a warp a turn;
    ``passes``: {name: clocks, the last entry the warps' turns}."""
    row = {**title, "passes": {}}
    for name, c in passes.items():
        turns = c[-1]
        row["passes"][name] = {
            "warp_turns": turns,
            "phase_share": {p: x / max(1, sum(c[:len(phases)])) for p, x in zip(phases, c)},
            "clocks_per_warp_turn": {p: x / max(1, turns) for p, x in zip(phases, c)}}
    print(json.dumps(row))
    print(f"{row['what']} {row['shape']}: {row['kernel_ms']:.3f} ms ({row['clocked_kernel_ms']:.3f}"
          f" ms with the phase clocks), on {row['device']}")
    for name, r in row["passes"].items():
        total = sum(r["clocks_per_warp_turn"].values())
        print(f"  {name}, {r['warp_turns']} warp turns, {total:.0f} clocks a warp a turn:")
        for p, share in r["phase_share"].items():
            print(f"    {p}: {share:.1%}, {r['clocks_per_warp_turn'][p]:.0f} a warp a turn")


def profile_bf16_backward(smi):
    fn, clocks_read = build_clocked("flash_attention_bwd_sm90", "flash_attention_bwd_sm90",
                                    fab90._kernel().argtypes, "flash_bwd_sm90_phase_clocks_read")
    profile_d256_backward(smi, fn, clocks_read)
    profile_d64_backward(smi, fn, clocks_read)
    profile_d128_backward(smi, fn, clocks_read)


def profile_d128_backward(smi, fn, clocks_read):
    """The d128 dK/dV pass's phase clocks at olmo-1b's training shape."""
    cfg = get_config(OLMO_ARCH)
    B, T_ = OLMO_TRAIN
    g = torch.Generator(device="cuda").manual_seed(16)
    q, k, v, do = (torch.randn((B, cfg.n_heads, T_, cfg.head_dim), generator=g,
                               device="cuda").bfloat16() for _ in range(4))
    o, lse = fa90.flash_attention_sm90_cuda(q, k, v, causal=True, return_lse=True)
    run = lambda: fab90.flash_attention_bwd_sm90_cuda(q, k, v, o, lse, do,  # noqa: E731
                                                      causal=True)
    plain_ms = cuda_ms(run)
    clocks, clocked_ms = bf16_clocks(fn, clocks_read, run)
    print_turns({"device": smi, "what": "flash_attention_bwd_sm90 bf16 d128",
                 "shape": [B, cfg.n_heads, T_, cfg.head_dim], "mask": "causal",
                 "kernel_ms": plain_ms, "clocked_kernel_ms": clocked_ms},
                {"dK/dV": clocks[4][:len(D64_PHASES)] + [clocks[4][-1]]}, D64_PHASES)


def profile_bf16_forward(smi):
    """The d128 forward's phase clocks at olmo-1b's training and serving
    shapes, its one-part and two-part launches apart."""
    fn, clocks_read = build_clocked("flash_attention_sm90", "flash_attention_sm90_fwd",
                                    fa90._kernel().argtypes, "flash_fwd_sm90_phase_clocks_read")
    cfg = get_config(OLMO_ARCH)
    for name, B, T_ in OLMO_FWD_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(17)
        q, k, v = (torch.randn((B, cfg.n_heads, T_, cfg.head_dim), generator=g,
                               device="cuda").bfloat16() for _ in range(3))
        run = lambda: fa90.flash_attention_sm90_cuda(q, k, v, causal=True)  # noqa: E731
        plain_ms = cuda_ms(run)
        clocks, clocked_ms = read_clocks(fa90, fn, clocks_read, run, len(FWD_PASSES),
                                         FWD_CLOCK_PHASES)
        print_turns({"device": smi, "what": f"flash_attention_sm90 bf16 d128, {name}",
                     "shape": [B, cfg.n_heads, T_, cfg.head_dim], "mask": "causal",
                     "one_part_blocks": fa90.one_part_blocks(T_, T_, cfg.head_dim, causal=True,
                                                             window=None, q_offset=0),
                     "kernel_ms": plain_ms, "clocked_kernel_ms": clocked_ms},
                    dict(zip(FWD_PASSES, clocks)), FWD_PHASES)
        del q, k, v
        torch.cuda.empty_cache()


def profile_d64_backward(smi, fn, clocks_read):
    """The d64 passes' phase clocks at seamless's encoder shape, unmasked."""
    cfg = get_config(D64_ARCH)
    H, D, T_ = cfg.n_heads, cfg.head_dim, T
    g = torch.Generator(device="cuda").manual_seed(15)
    q, k, v, do = (torch.randn((D64_BATCH, H, T_, D), generator=g, device="cuda").bfloat16()
                   for _ in range(4))
    o, lse = fa90.flash_attention_sm90_cuda(q, k, v, causal=False, return_lse=True)
    run = lambda: fab90.flash_attention_bwd_sm90_cuda(q, k, v, o, lse, do,  # noqa: E731
                                                      causal=False)
    plain_ms = cuda_ms(run)
    clocks, clocked_ms = bf16_clocks(fn, clocks_read, run)
    blocks = -(-T_ // D64_ROWS) * D64_BATCH * H        # blocks of either pass
    loops = {"dK/dV": T_ // 64 - 1, "dQ": T_ // 64 - 1}  # turns of a block's loop, tile 0's apart
    row = {"device": smi, "shape": [[D64_BATCH, H, T_, D]] * 2, "mask": None,
           "kernel_ms": plain_ms, "clocked_kernel_ms": clocked_ms, "passes": {}}
    for i, name in enumerate(BWD_PASSES):
        c = clocks[2 + i][:len(D64_PHASES)]
        pairs = blocks * loops[name] * D64_WARPS           # (warp, tile) pairs
        row["passes"][name] = {
            "tiles": blocks * loops[name],
            "phase_share": {p: x / sum(c) for p, x in zip(D64_PHASES, c)},
            "clocks_per_warp_tile": {p: x / pairs for p, x in zip(D64_PHASES, c)}}
    print(json.dumps(row))
    print(f"flash_attention_bwd_sm90 bf16 d64 {row['shape'][0]} no mask: {plain_ms:.3f} ms "
          f"({clocked_ms:.3f} ms with the phase clocks), on {smi}")
    for name, r in row["passes"].items():
        print(f"  {name} pass, {r['tiles']} tiles:")
        for p, share in r["phase_share"].items():
            print(f"    {p}: {share:.1%} of the warps' clocks, "
                  f"{r['clocks_per_warp_tile'][p]:.0f} a warp a tile")


def profile_d256_backward(smi, fn, clocks_read):
    cfg = get_config(BF16_ARCH)
    Hq, Hkv, D, window = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
    g = torch.Generator(device="cuda").manual_seed(14)
    q, do = (torch.randn((TRAIN_BATCH, Hq, T, D), generator=g, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn((TRAIN_BATCH, Hkv, T, D), generator=g, device="cuda").bfloat16()
            for _ in range(2))
    o, lse = fa90.flash_attention_sm90_cuda(q, k, v, causal=True, window=window,
                                            return_lse=True)
    run = lambda: fab90.flash_attention_bwd_sm90_cuda(q, k, v, o, lse, do,  # noqa: E731
                                                      causal=True, window=window)
    plain_ms = cuda_ms(run)
    clocks, clocked_ms = bf16_clocks(fn, clocks_read, run)
    tiles = dict(zip(BWD_PASSES, d256_tiles(T, T, Hq // Hkv, window)))
    row = {"device": smi, "shape": [[TRAIN_BATCH, Hq, T, D], [TRAIN_BATCH, Hkv, T, D]],
           "window": window, "kernel_ms": plain_ms, "clocked_kernel_ms": clocked_ms,
           "passes": {}}
    for i, name in enumerate(BWD_PASSES):
        c = clocks[i]
        pairs = tiles[name] * TRAIN_BATCH * Hkv * BF16_WARPS   # (warp, tile) pairs
        row["passes"][name] = {
            "tiles": tiles[name] * TRAIN_BATCH * Hkv,
            "phase_share": {p: x / sum(c) for p, x in zip(BF16_PHASES, c)},
            "clocks_per_warp_tile": {p: x / pairs for p, x in zip(BF16_PHASES, c)}}
    print(json.dumps(row))
    print(f"flash_attention_bwd_sm90 bf16 {row['shape']} window {window}: {plain_ms:.3f} ms "
          f"({clocked_ms:.3f} ms with the phase clocks), on {smi}")
    for name, r in row["passes"].items():
        print(f"  {name} pass, {r['tiles']} tiles:")
        for p, share in r["phase_share"].items():
            print(f"    {p}: {share:.1%} of the warps' clocks, "
                  f"{r['clocks_per_warp_tile'][p]:.0f} a warp a tile")


def main() -> int:
    args = ARGS
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if args.what in ("all", "forward"):
        profile_forward(smi)
    if args.what in ("all", "backward"):
        profile_backward(smi)
    if args.what in ("all", "bf16-backward"):
        profile_bf16_backward(smi)
    if args.what in ("all", "bf16-forward"):
        profile_bf16_forward(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
