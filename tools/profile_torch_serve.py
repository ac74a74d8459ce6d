#!/usr/bin/env python3
"""Where the time goes in the port's serving path, on one CUDA card.

Builds a full-width model in bf16 (``--arch``, recurrentgemma-2b by
default; random weights from a seed), warms it up, then traces with
``torch.profiler`` one prefill of 4 x ``--prompt-len`` byte tokens (512
by default) and 16 decode steps.  An encoder-decoder's prefill also
encodes 4 x 32768 frame embeddings (the repo's prefill_32k frames, made
with numpy from a seed), and its decode steps attend to the memories the
prefill returned.  For each phase it prints the wall time
(host clock around work that ends in a synchronise), the device time
summed over kernels, the device's idle share, the kernels that take the
most device time, and the kernel launches of the port's own CUDA kernels
(``ops.launch_counts``) with their device time and share.  The Chrome
traces go to the directory named by ``--out`` (``profile_out/`` by
default).

Usage, from the root of a checkout::

    python3 tools/profile_torch_serve.py [--arch ARCH] [--prompt-len T] [--out DIR]
    python3 tools/profile_torch_serve.py --arch h2o-danube-3-4b --prompt-len 8192
    python3 tools/profile_torch_serve.py --arch seamless-m4t-large-v2
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

BATCH, DECODE_STEPS = 4, 16
ENC_FRAMES = 32768      # an encoder-decoder's frames a row


def kernel_events(prof):
    """Device-side entries only (kernels, memcpy, memset), so no time is
    counted twice through the CPU ops that launched them."""
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_us(prof) -> float:
    return sum(e.self_device_time_total for e in kernel_events(prof))


def top_kernels(prof, n=12):
    rows = sorted(kernel_events(prof), key=lambda e: e.self_device_time_total, reverse=True)
    return [(e.key[:90], e.count, e.self_device_time_total / 1e3) for e in rows[:n]]


# the port's own CUDA kernels, by the name of their __global__ function
PORT_KERNELS = {"linear_scan": "linear_scan_f32_kernel", "page_digest": "page_digest_kernel",
                "delta_mask": "delta_mask_kernel", "flash_attention": "flash_attention_kernel<",
                "flash_attention_sm90": "flash_attention_sm90_kernel",
                "flash_attention_sm90 (D <= 64)": "flash_attention_d64_kernel"}


def port_kernel_ms(prof):
    """Device ms of each of the port's kernels that ran in the trace."""
    out = {}
    for e in kernel_events(prof):
        for name, symbol in PORT_KERNELS.items():
            if symbol in e.key:
                out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3
    return out


def traced(name, fn, out_dir):
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = device_us(prof) / 1e3
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))
    row = {"phase": name, "wall_ms": wall_ms, "device_ms": dev_ms,
           "idle_share": max(0.0, 1.0 - dev_ms / wall_ms),
           "top": top_kernels(prof), "launches": ops.launch_counts(),
           "port_kernel_ms": port_kernel_ms(prof)}
    print(json.dumps(row))
    for key, count, ms in row["top"]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {key}")
    for kname, ms in row["port_kernel_ms"].items():
        print(f"  port kernel {kname}: {ms:.3f} ms, {ms / dev_ms:.2%} of the device time")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b", choices=ARCH_IDS)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--out", default=os.path.join(ROOT, "profile_out"),
                    help="directory for the Chrome traces")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}")
    cfg = get_config(args.arch)
    print(f"model: {cfg.name}, prompt {BATCH} x {args.prompt_len}, {DECODE_STEPS} decode steps")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(32, 127, (BATCH, args.prompt_len)), device="cuda")
    batch = {"tokens": tokens}
    if cfg.arch_kind == "encdec":
        print(f"encoder: {BATCH} x {ENC_FRAMES} frames")
        batch["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (BATCH, ENC_FRAMES, cfg.d_model), dtype=np.float32)).to("cuda")
    max_len = args.prompt_len + DECODE_STEPS + 1
    state = {}

    def prefill():
        state.clear()
        cache = model.init_cache(BATCH, max_len, device="cuda")
        logits, cache, *state["extras"] = model.prefill(params, batch, cache)
        state["cache"], state["tok"] = cache, torch.argmax(logits, dim=-1)

    def decode():
        tok, cache = state["tok"], state["cache"]
        for i in range(DECODE_STEPS):
            logits, cache = model.decode_step(params, tok, args.prompt_len + i, cache,
                                              *state["extras"])
            tok = torch.argmax(logits, dim=-1)

    with torch.inference_mode():
        prefill()
        decode()      # warm-up: cuBLAS handles, kernel build, allocator
        rows = [traced("prefill", prefill, args.out), traced("decode", decode, args.out)]
    rows[1]["per_step_wall_ms"] = rows[1]["wall_ms"] / DECODE_STEPS
    print(json.dumps({"profile": rows, "arch": cfg.name, "prompt_len": args.prompt_len,
                      "frames": ENC_FRAMES if cfg.arch_kind == "encdec" else None,
                      "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
