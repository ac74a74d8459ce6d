#!/usr/bin/env python3
"""Where the float32 ``flash_attention`` kernel spends its time, on one card.

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` a second time
with ``-DFLASH_PHASE_CLOCKS`` (every warp adds up the SM clocks it spends
in each phase of its tile loop), runs it at the long serving path's shape
in float32 (h2o-danube3-4b: q (4, 32, 8192, 120), k and v (4, 8, 8192,
120), window 4096) and prints, beside the kernel's time with and without
the clocks:

- each phase's share of the warps' clocks: waiting at the tile barrier,
  issuing the next tile's copies, the score loop, the softmax, the P.V
  loop;
- for the two FMA loops, the share of the scheduler's issue slots that
  their FMAs fill (each of an SM's four schedulers issues one warp
  instruction a clock, and hosts a quarter of the block's warps).

Usage, from the root of a checkout::

    python3 tools/profile_flash_attention.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

ARCH, BATCH, T = "h2o-danube-3-4b", 4, 8192
PHASES = ("barrier", "copy issue", "score loop", "softmax", "P.V loop")
ROWS_PER_WARP, ROWS_PER_THREAD, SCHEDULERS = 8, 4, 4   # csrc/flash_attention.cu


def build_clocked():
    out = build.BUILD_DIR / "libflash_attention_clocks.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-DFLASH_PHASE_CLOCKS", "-o", str(out),
                    str(build.CSRC / "flash_attention.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.flash_attention_fwd
    fn.argtypes = fa._kernel().argtypes
    fn.restype = ctypes.c_int
    lib.flash_phase_clocks_read.argtypes = [ctypes.c_void_p]
    lib.flash_phase_clocks_read.restype = ctypes.c_int
    return fn, lib.flash_phase_clocks_read


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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cfg = get_config(ARCH)
    Hq, Hkv, D, window = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
    g = torch.Generator(device="cuda").manual_seed(12)
    q = torch.randn((BATCH, Hq, T, D), generator=g, device="cuda")
    k = torch.randn((BATCH, Hkv, T, D), generator=g, device="cuda")
    v = torch.randn((BATCH, Hkv, T, D), generator=g, device="cuda")
    run = lambda: fa.flash_attention_cuda(q, k, v, causal=True, window=window)  # noqa: E731
    plain_ms = cuda_ms(run)

    fn, clocks_read = build_clocked()
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
