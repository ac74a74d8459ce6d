#!/usr/bin/env python3
"""Where the time goes in the port's training path, on one CUDA card.

Builds full-width olmo-1b in bf16 with its fp32 AdamW state (random
weights from a seed), takes two warm-up steps at batch 2 x 2048 tokens,
then traces one step with ``torch.profiler``: wall time, device time
summed over kernels, the device's idle share and the kernels that take
the most device time.  Then it runs a full checkpoint save and a
restore at 256 KiB pages under ``cProfile`` (host-side work: the
profiler inflates their wall time) and prints the functions with the
most time of their own.  The Chrome trace and the cProfile tables go to
the directory named by ``--out`` (``profile_out/`` by default).

Usage, from the root of a checkout::

    python3 tools/profile_torch_train.py [--out DIR]
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from profile_torch_serve import device_us, top_kernels  # noqa: E402
from repro_torch.checkpoint import BlobCheckpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import BlobSeerService  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import AdamWConfig, TrainStepBuilder  # noqa: E402

BATCH, SEQ, PSIZE = 2, 2048, 256 * 1024


def host_profile(name, fn, out_dir, n=15):
    """Wall time of ``fn()`` under cProfile and its top functions by own time."""
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    result = fn()
    prof.disable()
    wall_s = time.perf_counter() - t0
    stats = pstats.Stats(prof).sort_stats("tottime")
    stats.dump_stats(os.path.join(out_dir, f"{name}.pstats"))
    rows = []
    for (file, line, func), (_, ncalls, tottime, cumtime, _) in sorted(
            stats.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:n]:
        rows.append((f"{os.path.basename(file)}:{line}({func})", ncalls, tottime, cumtime))
    print(json.dumps({"phase": name, "wall_s": wall_s, "top": rows}))
    for key, ncalls, tottime, cumtime in rows:
        print(f"  {tottime:8.2f} s own {cumtime:8.2f} s cum  x{ncalls:<8d} {key}")
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(40)
    with open(os.path.join(out_dir, f"{name}_cumulative.txt"), "w") as f:
        f.write(buf.getvalue())
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "profile_out"),
                    help="directory for the Chrome trace and the cProfile tables")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    builder = TrainStepBuilder(build_model(get_config("olmo-1b")),
                               opt=AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100))
    state = builder.init_state(torch.Generator(device="cuda").manual_seed(0))
    step = builder.train_step_fn()
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, 259, (BATCH, SEQ + 1)), device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for _ in range(2):                      # warm-up: cuBLAS handles, allocator
        state, _ = step(state, batch)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = device_us(prof) / 1e3
    prof.export_chrome_trace(os.path.join(args.out, "trace_train_step.json"))
    row = {"phase": "train_step", "wall_ms": wall_ms, "device_ms": dev_ms,
           "idle_share": max(0.0, 1.0 - dev_ms / wall_ms), "top": top_kernels(prof, n=16),
           "loss": float(metrics["loss"])}
    print(json.dumps(row))
    for key, count, ms in row["top"]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {key}")
    del prof, metrics

    client = BlobSeerService(n_providers=4, n_meta_shards=4).client("trainer")
    ckpt = BlobCheckpointer(client, psize=PSIZE)
    host_profile("save", lambda: ckpt.save(state, step=3), args.out)
    host_profile("restore", lambda: ckpt.restore(builder.abstract_state(), device="cuda"),
                 args.out)
    print(json.dumps({"device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
