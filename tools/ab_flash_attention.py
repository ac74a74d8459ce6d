#!/usr/bin/env python3
"""Times versions of the bf16 attention kernels against each other on one
card, their calls interleaved.

Each ``--root`` is a checkout. Its ``csrc/flash_attention_sm90.cu`` and
``csrc/flash_attention_bwd_sm90.cu`` are built side by side, and one process
calls the port's wrappers (this checkout's ``src/``; the libraries' C entry
points take the same arguments) with each version's library in turn, round
robin: a round times ``--calls`` back-to-back calls of every version with
CUDA events, after a warm-up, and ``--rounds`` rounds make each version's
spread. So two versions meet the same clocks, power and neighbours, which
``tools/time_flash_attention.py --root`` (one process a version, one after
the other) cannot give. Prints one JSON line a shape and version: the
median, lowest and highest ms a call over the rounds, and the card's name
and power limit.

Shapes, bf16, inputs from a seed: olmo-1b's training forward and backward
(2, 16, 8192, 128) and serving forward (4, 16, 32768, 128), plain causal;
h2o-danube3-4b's training forward and backward, q (1, 32, 8192, 120) over
(1, 8, 8192, 120), and serving forward (4, 32, 8192, 120), causal with a
4096 window.

Usage, from the root of a checkout::

    python3 tools/ab_flash_attention.py --root DIR [--root DIR ...]
        [--what forward|backward|all] [--only TEXT] [--rounds N] [--calls N]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention_bwd_sm90 as fab90  # noqa: E402
from repro_torch.kernels import flash_attention_sm90 as fa90  # noqa: E402

# name, q shape, k/v shape, window (every shape causal)
SHAPES = [
    ("olmo train", (2, 16, 8192, 128), (2, 16, 8192, 128), None),
    ("olmo prefill", (4, 16, 32768, 128), (4, 16, 32768, 128), None),
    ("danube train", (1, 32, 8192, 120), (1, 8, 8192, 120), 4096),
    ("danube prefill", (4, 32, 8192, 120), (4, 8, 8192, 120), 4096),
]
# the wrapper module and C entry point of each source
SOURCES = {"flash_attention_sm90": (fa90, "flash_attention_sm90_fwd"),
           "flash_attention_bwd_sm90": (fab90, "flash_attention_bwd_sm90")}


def build_roots(roots, out_dir):
    """{source: [its entry point built from each root]}, all nvcc at once."""
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for i, root in enumerate(roots):
        for name in SOURCES:
            out = os.path.join(out_dir, f"lib{name}_{i}.so")
            src = os.path.join(root, "src", "repro_torch", "kernels", "csrc", f"{name}.cu")
            procs.append((name, out, subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-o", out, src],
                stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)))
    # this checkout's wrappers (their own builds run meanwhile) give the argument types
    argtypes = {name: module._kernel().argtypes for name, (module, _) in SOURCES.items()}
    fns = {name: [] for name in SOURCES}
    for name, out, proc in procs:
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for {out}")
        fn = getattr(ctypes.CDLL(out), SOURCES[name][1])
        fn.argtypes, fn.restype = argtypes[name], ctypes.c_int
        fns[name].append(fn)
    return fns


def interleaved(module, fns, call, rounds, calls):
    """[ms a call of each of ``fns`` in each round], ``call`` launching
    through ``module``'s wrapper with its library swapped in."""
    saved = module._kernel()
    times = [[] for _ in fns]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        for fn in fns:   # warm-up: each library's first launch configures its kernels
            module._fn = fn
            call()
        torch.cuda.synchronize()
        for _ in range(rounds):
            for i, fn in enumerate(fns):
                module._fn = fn
                start.record()
                for _ in range(calls):
                    call()
                end.record()
                torch.cuda.synchronize()
                times[i].append(start.elapsed_time(end) / calls)
    finally:
        module._fn = saved
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", required=True,
                    help="a checkout whose kernels to time (give two or more)")
    ap.add_argument("--what", choices=("forward", "backward", "all"), default="all")
    ap.add_argument("--only", default="", help="time only the shapes whose name holds this text")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--calls", type=int, default=5, help="calls timed a round (1 at 32768)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    roots = [os.path.abspath(r) for r in args.root]
    fns = build_roots(roots, os.path.join(str(build.BUILD_DIR), "ab"))
    g = torch.Generator(device="cuda").manual_seed(21)
    for name, qs, ks, window in SHAPES:
        if args.only not in name:
            continue
        q, do = (torch.randn(qs, generator=g, device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn(ks, generator=g, device="cuda").bfloat16() for _ in range(2))
        kw = dict(causal=True, window=window)
        o, lse = fa90.flash_attention_sm90_cuda(q, k, v, return_lse=True, **kw)
        calls = 1 if qs[2] > 8192 else args.calls
        runs = []
        if args.what in ("forward", "all"):
            runs.append(("forward", fa90, fns["flash_attention_sm90"],
                         lambda: fa90.flash_attention_sm90_cuda(q, k, v, **kw)))
        if args.what in ("backward", "all") and "train" in name:
            runs.append(("backward", fab90, fns["flash_attention_bwd_sm90"],
                         lambda: fab90.flash_attention_bwd_sm90_cuda(q, k, v, o, lse, do, **kw)))
        for what, module, versions, call in runs:
            times = interleaved(module, versions, call, args.rounds, calls)
            for root, t in zip(roots, times):
                print(json.dumps({"shape": f"{name} {what}", "q": list(qs), "kv": list(ks),
                                  "root": root, "median_ms": statistics.median(t),
                                  "min_ms": min(t), "max_ms": max(t), "rounds": len(t),
                                  "calls": calls, "card": smi}), flush=True)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
