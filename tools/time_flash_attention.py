#!/usr/bin/env python3
"""Times the attention kernels, ``flash_attention_sm90`` and both backwards, on one card.

At the shapes the serving paths give it, bf16, random inputs from a seed:
seamless-m4t-large-v2's encoder self-attention (4, 16, 32768, 64), its
prefill's cross-attention (q (4, 16, 512, 64)) and a decode step's
(q (4, 16, 1, 64)), both over 32768 frames, all unmasked; and
h2o-danube3-4b's prefill attention, q (4, 32, 8192, 120) over k, v
(4, 8, 8192, 120), causal with a 4096 window, and its training step's
forward, q (1, 32, 8192, 120) over (1, 8, 8192, 120); recurrentgemma-2b's
prefill attention, q (4, 10, 32768, 256) over k, v (4, 1, 32768, 256),
causal with a 2048 window, and its training step's forward, q (1, 10,
8192, 256) over (1, 1, 8192, 256); olmo-1b's prefill attention, (4, 16,
32768, 128) over the same, plain causal (no window), and its training
step's forward, (2, 16, 8192, 128).  For each it prints one JSON
line: the kernel's device time (CUDA events over back-to-back calls after
a warm-up), its bound (4 D flops a live pair over the bf16 tensor-core
rate, or q, k, v read and o written once over the memory rate, the larger),
``scaled_dot_product_attention``'s time on the same inputs (no mask,
seamless's, and a plain causal mask, olmo's, as ``is_causal=False`` or
``True`` with no mask tensor under each of the cuDNN, flash and
memory-efficient backends alone, each one's time or "refused" in
``sdpa_backends`` and the fastest that ran as ``sdpa_ms``; with no mask also
PyTorch's own pick of backend, ``sdpa_pick_ms``; for the windowed
shapes the window-causal boolean mask on the memory-efficient backend, kv
heads repeated outside the timing), the largest difference from the first call's output to the
plain version's (``ref.ref_flash_attention``) at the three smaller shapes,
the 128-row blocks (over the key ranges of a split call) that take P V in
one fp16 part and in two bf16 parts (``row_blocks``: the rule of the
checkout timed, ``one_part_ranges`` or at head widths 65-128
``one_part_blocks``, none in one part in a checkout without either; none
at a decode step's one query row), each of its launches' device time
(``launches_ms``, ``torch.profiler``), and the card's name and power
limit.

The backward, ``flash_attention_bwd_sm90``, at the training phases' four
shapes: seamless-m4t-large-v2's encoder (2, 16, 8192, 64) and its
cross-attention, q (2, 16, 2048, 64) over 8192 frames, unmasked,
h2o-danube3-4b's (1, 32, 8192, 120) over (1, 8, 8192, 120), causal with a
4096 window, recurrentgemma-2b's (1, 10, 8192, 256) over (1, 1, 8192,
256), causal with a 2048 window, and olmo-1b's (2, 16, 8192, 128), plain
causal.  Each line gives its device time (the forward's o and lse as
input, a seeded do), its bound (10 D flops a live pair, S recomputed, over
the bf16 tensor-core rate, or q, k, v, o, do and lse read and the three
gradients written once over the memory rate, the larger), each of its
launches' device time (``torch.profiler``), and the time of
``scaled_dot_product_attention``'s backward on the same inputs and mask
(no mask or a plain causal mask: each backend alone as above,
``sdpa_bwd_backends``, ``sdpa_bwd_ms`` the fastest, and with no mask
PyTorch's pick, ``sdpa_bwd_pick_ms``; else the boolean mask on the
memory-efficient backend, kv heads repeated outside the timing).

The float32 backward, ``flash_attention_bwd``, at h2o-danube3-4b's
training shape in float32 (as above) and seamless-m4t-large-v2's encoder
(2, 16, 8192, 64), unmasked: its device time, its bound (10 D flops a
live pair over the float32 rate outside the tensor cores, 67 TFLOP/s, or
the bytes, the larger), and ``scaled_dot_product_attention``'s float32
backward on the same inputs and mask.

The split path of ``flash_attention_sm90`` at seamless's two cross-attentions
(a decode step's q (4, 16, 1, 64) and the prefill's q (4, 16, 512, 64) over
32768 frames): the call at the wrapper's own key ranges, and the same call
with ``splits=1``; then the split rule's sweep, q (4, 16, Tq, 64) over
32768 keys for Tq = 1, 128, 256, 384 and 512: the blocks of an unsplit
call, the wrapper's key ranges, and the call's time at each of 1, 2, 3,
the wrapper's and the ranges that would give four waves of blocks
(``by_splits``).

The limits (``--what limits``): ``chip_smoke.py``'s forward cases at head
widths up to 64 (``FLASH_D64_ONE_PART_CASES``, ``FLASH_D64_CASES``,
``FLASH_SPLIT_CASES``, read from this checkout's ``chip_smoke.py``), k and
v contiguous and strided, then under ``FLASH_D64_FWD_SCALES`` (the layouts
in turns), each call of the checkout timed against the plain version: one
line a case with its largest share of the bf16 limit (2^-7 |want| +
1e-4, in v's units where v is scaled up) by scale, and its blocks in one
fp16 part, so that two checkouts' shares stand side by side.

First it prints, for each attention kernel it compiled (the sources are
built anew in a fresh checkout), ptxas's registers a thread and spill bytes,
whether ptxas serialised its wgmma ("C7512 ... insufficient register
resources"), and the highest register its SASS names (``cuobjdump``, where
the toolkit has it): ptxas reports the budget of the launch, while a
warpgroup's code after ``setmaxnreg.inc`` may use more.

Usage, from the root of a checkout::

    python3 tools/time_flash_attention.py [--root DIR] [--reps N]
        [--what all|forward|backward|float32-backward|split|limits] [--only TEXT]

``--root`` imports the port from another checkout's ``src/`` (its own
kernels are built there), so one command can time two versions in turns.
``--only`` keeps the shapes whose name holds TEXT (``recurrentgemma``: the
head-width-256 shapes alone; ``olmo``: the three plain causal D = 128 shapes).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import shutil
import subprocess
import sys

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                help="checkout whose src/ holds the port to time (default: this one)")
ap.add_argument("--reps", type=int, default=20, help="calls timed a shape (5 at the encoder)")
ap.add_argument("--what", choices=("all", "forward", "backward", "float32-backward", "split",
                                   "limits"),
                default="all", help="which kernels to time (backward: the bf16 one)")
ap.add_argument("--only", default="", help="time only the shapes whose name holds this text")
ARGS = ap.parse_args()
sys.path.insert(0, os.path.join(os.path.abspath(ARGS.root), "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention_sm90 as fa90  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda  # noqa: E402
from repro_torch.kernels.flash_attention_bwd_sm90 import (  # noqa: E402
    flash_attention_bwd_sm90_cuda)
from repro_torch.kernels.flash_attention_sm90 import (  # noqa: E402
    flash_attention_sm90_cuda, split_count)
from repro_torch.kernels.ref import ref_flash_attention  # noqa: E402

# H100 SXM data sheet: bf16 tensor cores, float32 outside them, HBM3
BF16_FLOP_PER_S, F32_FLOP_PER_S, HBM_BYTES_PER_S = 989e12, 67e12, 3.35e12
# name, q shape, k/v shape, causal, window
SHAPES = [
    ("seamless cross decode", (4, 16, 1, 64), (4, 16, 32768, 64), False, None),
    ("seamless cross prefill", (4, 16, 512, 64), (4, 16, 32768, 64), False, None),
    ("seamless encoder", (4, 16, 32768, 64), (4, 16, 32768, 64), False, None),
    ("danube prefill", (4, 32, 8192, 120), (4, 8, 8192, 120), True, 4096),
    ("danube train forward", (1, 32, 8192, 120), (1, 8, 8192, 120), True, 4096),
    ("recurrentgemma prefill", (4, 10, 32768, 256), (4, 1, 32768, 256), True, 2048),
    ("recurrentgemma train forward", (1, 10, 8192, 256), (1, 1, 8192, 256), True, 2048),
    ("olmo prefill", (4, 16, 32768, 128), (4, 16, 32768, 128), True, None),
    ("olmo train forward", (2, 16, 8192, 128), (2, 16, 8192, 128), True, None),
]
BWD_SHAPES = [
    ("seamless encoder backward", (2, 16, 8192, 64), (2, 16, 8192, 64), False, None),
    ("seamless cross backward", (2, 16, 2048, 64), (2, 16, 8192, 64), False, None),
    ("danube train backward", (1, 32, 8192, 120), (1, 8, 8192, 120), True, 4096),
    ("recurrentgemma train backward", (1, 10, 8192, 256), (1, 1, 8192, 256), True, 2048),
    ("olmo train backward", (2, 16, 8192, 128), (2, 16, 8192, 128), True, None),
]
F32_BWD_SHAPES = [
    ("danube train backward float32", (1, 32, 8192, 120), (1, 8, 8192, 120), True, 4096),
    ("seamless encoder backward float32", (2, 16, 8192, 64), (2, 16, 8192, 64), False, None),
]
SPLIT_SHAPES = SHAPES[:2]       # seamless's two cross-attentions, calls of few blocks
SPLIT_SWEEP_TQ = (1, 128, 256, 384, 512)   # query rows of q (4, 16, Tq, 64) over 32768 keys


def row_blocks(qs, ks, causal, window, splits=1):
    """{"one_part", "two_part"}: the forward's blocks a (batch, head), over
    the key ranges of a call split ``splits`` ways, that take P V in one
    fp16 part and in two bf16 parts by the rule of the checkout timed
    (``one_part_ranges``, or ``one_part_blocks`` at head widths 65-128; a
    checkout without either has none in one part); None above 128."""
    Tq, Tk, D = qs[2], ks[2], qs[3]
    if D > 128:
        return None
    kw = dict(causal=causal, window=window, q_offset=0)
    if hasattr(fa90, "one_part_ranges"):
        parts = fa90.one_part_ranges(Tq, Tk, D, splits, **kw)
    elif D > 64 and hasattr(fa90, "one_part_blocks"):
        parts = [fa90.one_part_blocks(Tq, Tk, D, **kw)]
    else:
        parts = [(0, 0)]
    one = sum(b - a for a, b in parts)
    blocks = -(-Tq // fa90.block_rows(Tq, D)) * splits
    return {"one_part": one, "two_part": blocks - one}


def smoke_cases():
    """The limits' cases and scales, read from this checkout's
    ``chip_smoke.py`` (its module-level assignments of those names,
    evaluated in order; nothing else of it runs)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    names = ("FLASH_FP16_SCALES", "FLASH_FWD_FP16_SCALES", "FLASH_D64_FWD_SCALES",
             "FLASH_D64_ONE_PART_CASES", "FLASH_D64_CASES", "FLASH_SPLIT_CASES",
             "FLASH_BF16_REL", "FLASH_BF16_FLOOR")
    env = {"dict": dict}
    for node in ast.parse(open(path).read()).body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        targets = target.elts if isinstance(target, ast.Tuple) else [target]
        if all(getattr(t, "id", None) in names for t in targets):
            value = eval(compile(ast.Expression(node.value), path, "eval"), env)
            env.update(zip((t.id for t in targets), value if len(targets) > 1 else [value]))
    return env


def time_limits(smi):
    """The checkout timed on chip_smoke.py's forward cases up to 64 columns:
    one line a case, its largest share of the bf16 limit by scale."""
    c = smoke_cases()
    cases = [(name, tuple(case[:6]), {k: x for k, x in case[6].items() if k != "splits"},
              case[6]["splits"]) for name, *case in c["FLASH_D64_ONE_PART_CASES"]]
    cases += [(f"D <= 64 case {i}", (B, Hq, Hkv, Tq, Tk, D),
               dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset), None)
              for i, (B, Hq, Hkv, Tq, Tk, D, causal, window, softcap, q_offset)
              in enumerate(c["FLASH_D64_CASES"])]
    cases += [(f"forced split {i}", (B, Hq, Hkv, Tq, Tk, D),
               dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset), ranges)
              for i, (B, Hq, Hkv, Tq, Tk, D, causal, window, q_offset, softcap, ranges)
              in enumerate(c["FLASH_SPLIT_CASES"])]
    scales = {"plain": (1, 1, 1), **c["FLASH_D64_FWD_SCALES"]}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (name, (B, Hq, Hkv, Tq, Tk, D), kw, splits) in enumerate(cases):
        if ARGS.only not in name:
            continue
        mask = dict(causal=kw["causal"], window=kw.get("window"), q_offset=kw.get("q_offset", 0))
        ranges = splits or split_count(B, Hq, Tq, Tk, D, **mask, sm_count=sms)
        shares = {}
        runs = [("plain", False), ("plain", True)] + [
            (scale, j % 2 == 1) for j, scale in enumerate(scales) if scale != "plain"]
        for scale, strided in runs:
            g = torch.Generator(device="cuda").manual_seed(300 + i)
            sq, sk, sv = scales[scale]
            q = (torch.randn((B, Hq, Tq, D), generator=g, device="cuda") * sq).bfloat16()
            kv_shape = (B, Tk, Hkv, D) if strided else (B, Hkv, Tk, D)
            k = (torch.randn(kv_shape, generator=g, device="cuda") * sk).bfloat16()
            v = (torch.randn(kv_shape, generator=g, device="cuda") * sv).bfloat16()
            if strided:
                k, v = k.transpose(1, 2), v.transpose(1, 2)
            got = flash_attention_sm90_cuda(q, k, v, splits=ranges, **kw).float()
            want = ref_flash_attention(q, k, v, **kw).float()
            unit = max(1.0, sv)
            share = float(((got - want).abs() / unit / (
                c["FLASH_BF16_REL"] * want.abs() / unit + c["FLASH_BF16_FLOOR"])).max())
            shares[scale] = max(shares.get(scale, 0.0), share)
        blocks = None
        if hasattr(fa90, "one_part_ranges"):
            parts = fa90.one_part_ranges(Tq, Tk, D, ranges, **mask)
            one = sum(b - a for a, b in parts)
            blocks = {"one_part": one,
                      "two_part": -(-Tq // fa90.block_rows(Tq, D)) * ranges - one}
        print(json.dumps({
            "limits": name, "q": [B, Hq, Tq, D], "kv": [B, Hkv, Tk, D], "mask": kw,
            "splits": ranges, "root": os.path.abspath(ARGS.root), "share": shares,
            "row_blocks": blocks, "card": smi}), flush=True)


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def live_pairs(Tq, Tk, causal, window):
    pos = torch.arange(Tq, dtype=torch.int64)
    hi = torch.minimum(pos, torch.tensor(Tk - 1)) if causal else torch.full((Tq,), Tk - 1)
    lo = (pos - window + 1).clamp(min=0) if window is not None else torch.zeros(Tq, dtype=torch.int64)
    return int((hi - lo + 1).clamp(min=0).sum())


def sdpa_backends(q, k, v, do, reps, causal):
    """{"sdpa_ms", "sdpa_backend", "sdpa_backends"}: ``scaled_dot_product_attention``
    with no mask tensor, ``is_causal=causal`` (its backward where ``do`` is
    given) under each of the cuDNN, flash and memory-efficient backends
    alone, "refused" where one does not take the call, and the fastest that
    ran; kv heads repeated outside the timing.  ``is_causal`` aligns the mask
    top-left: the port's mask at Tq = Tk."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    assert not causal or q.shape[2] == k.shape[2], "is_causal is the port's mask only at Tq = Tk"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    group = q.shape[1] // k.shape[1]
    qq, kk, vv = (t.detach().clone().requires_grad_(do is not None) for t in (
        q, k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)))
    times = {}
    for name in ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION"):
        with sdpa_kernel([getattr(SDPBackend, name)]):
            try:
                if do is None:
                    times[name] = cuda_ms(lambda: sdpa(qq, kk, vv, is_causal=causal), reps)
                else:
                    o = sdpa(qq, kk, vv, is_causal=causal)
                    times[name] = cuda_ms(lambda: torch.autograd.grad(
                        o, (qq, kk, vv), do, retain_graph=True), reps)
            except RuntimeError:
                times[name] = "refused"
        torch.cuda.empty_cache()
    ran = {name: ms for name, ms in times.items() if ms != "refused"}
    best = min(ran, key=ran.get) if ran else None
    return {"sdpa_ms": ran.get(best), "sdpa_backend": best, "sdpa_backends": times}


def sdpa_ms(q, k, v, causal, window, reps):
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is None and not causal:
        return cuda_ms(lambda: sdpa(q, k, v), reps)
    qpos = torch.arange(q.shape[2], device="cuda")[:, None]
    kpos = torch.arange(k.shape[2], device="cuda")[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    group = q.shape[1] // k.shape[1]
    ke, ve = k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        return cuda_ms(lambda: sdpa(q, ke, ve, attn_mask=mask), reps)


def sdpa_bwd_ms(q, k, v, do, causal, window, reps):
    from torch.nn.attention import SDPBackend, sdpa_kernel
    group = q.shape[1] // k.shape[1]
    qq, kk, vv = (t.detach().clone().requires_grad_() for t in (
        q, k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)))
    mask, backends = None, [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]
    if causal or window is not None:
        qpos = torch.arange(q.shape[2], device="cuda")[:, None]
        kpos = torch.arange(k.shape[2], device="cuda")[None, :]
        mask = kpos <= qpos if causal else torch.ones_like(kpos > qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        backends = [SDPBackend.EFFICIENT_ATTENTION]
    with sdpa_kernel(backends):
        out = torch.nn.functional.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)
        return cuda_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), do, retain_graph=True),
                       reps)


def launch_ms(fn, reps):
    """{kernel name: device ms a call} of ``fn`` under ``torch.profiler``,
    over ``reps`` calls after a warm-up (the launches of one call apart)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:90]: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def demangle(names):
    """C++ names of mangled kernel symbols (unchanged without ``c++filt``)."""
    if not names or shutil.which("c++filt") is None:
        return list(names)
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True)
    return out.stdout.splitlines()


def sass_max_registers(name):
    """{mangled kernel: highest register its SASS names} for built source
    ``name``, or {} where ``cuobjdump`` is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))], capture_output=True,
                          text=True).stdout
    top, kernel = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = m.group(1)
            top[kernel] = -1
        elif kernel is not None:
            for r in re.findall(r"\bR(\d+)\b", line):
                top[kernel] = max(top[kernel], int(r))
    return top


def ptxas_report(logs, smi):
    """One JSON line a kernel compiled now: ptxas's registers and spill
    bytes, wgmma serialisation, the SASS's highest register."""
    for name, log in logs.items():
        rows, serialised, kernel = {}, {}, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = m.group(1)
                rows[kernel] = {}
                continue
            m = re.search(r"serialized due to (.*?) (?:for|in) the function '(\S+)'", line)
            if m:
                serialised[m.group(2)] = m.group(1)
            if kernel is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                rows[kernel]["spill_stores"], rows[kernel]["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows[kernel]["registers"] = int(m.group(1))
        top = sass_max_registers(name)
        for kernel, readable in zip(rows, demangle(list(rows))):
            print(json.dumps({"ptxas": readable, "source": name, **rows[kernel],
                              "wgmma_serialised": serialised.get(kernel, False),
                              "sass_max_register": top.get(kernel),
                              "root": os.path.abspath(ARGS.root), "card": smi}), flush=True)


def time_backward(g, smi, shapes, dtype):
    """The dtype's backward kernel at each of ``shapes``."""
    forward, backward, rate = ((flash_attention_sm90_cuda, flash_attention_bwd_sm90_cuda,
                                BF16_FLOP_PER_S) if dtype == torch.bfloat16 else
                               (flash_attention_cuda, flash_attention_bwd_cuda, F32_FLOP_PER_S))
    for name, qs, ks, causal, window in shapes:
        if ARGS.only not in name:
            continue
        q = torch.randn(qs, generator=g, device="cuda").to(dtype)
        k = torch.randn(ks, generator=g, device="cuda").to(dtype)
        v = torch.randn(ks, generator=g, device="cuda").to(dtype)
        do = torch.randn(qs, generator=g, device="cuda").to(dtype)
        kw = dict(causal=causal, window=window)
        o, lse = forward(q, k, v, return_lse=True, **kw)
        reps = max(1, ARGS.reps // 4)
        ms = cuda_ms(lambda: backward(q, k, v, o, lse, do, **kw), reps)
        pairs = qs[0] * qs[1] * live_pairs(qs[2], ks[2], causal, window)
        ops_s = 10 * qs[3] * pairs / rate
        bytes_s = ((4 * q.numel() + 4 * k.numel()) * q.element_size()
                   + 4 * lse.numel()) / HBM_BYTES_PER_S
        print(json.dumps({
            "shape": name, "q": list(qs), "kv": list(ks), "dtype": str(dtype)[6:],
            "root": os.path.abspath(ARGS.root),
            "ms": ms, "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "launches_ms": launch_ms(lambda: backward(q, k, v, o, lse, do, **kw), reps),
            **({key.replace("sdpa", "sdpa_bwd"): val for key, val in
                sdpa_backends(q, k, v, do, reps, causal).items()} if window is None else
               {"sdpa_bwd_ms": sdpa_bwd_ms(q, k, v, do, causal, window, reps)}),
            # unmasked: PyTorch's own pick of backend too (the earlier yardstick)
            **({"sdpa_bwd_pick_ms": sdpa_bwd_ms(q, k, v, do, causal, window, reps)}
               if not causal and window is None else {}),
            "card": smi}), flush=True)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()


def time_split(g, smi):
    """The bf16 kernel at the split shapes: at the wrapper's own key ranges
    (one launch that also merges them) and with ``splits=1``; then the
    split rule's sweep over Tq at a few range counts each."""
    for name, qs, ks, causal, window in SPLIT_SHAPES:
        if ARGS.only not in name:
            continue
        q = torch.randn(qs, generator=g, device="cuda").bfloat16()
        k = torch.randn(ks, generator=g, device="cuda").bfloat16()
        v = torch.randn(ks, generator=g, device="cuda").bfloat16()
        kw = dict(causal=causal, window=window)
        ranges = split_count(qs[0], qs[1], qs[2], ks[2], qs[3], causal=causal, window=window,
                             q_offset=0, sm_count=torch.cuda.get_device_properties(0)
                             .multi_processor_count)
        print(json.dumps({
            "shape": f"{name} split", "q": list(qs), "kv": list(ks),
            "root": os.path.abspath(ARGS.root), "splits": ranges,
            "ms": cuda_ms(lambda: flash_attention_sm90_cuda(q, k, v, **kw), ARGS.reps * 5),
            "unsplit_ms": cuda_ms(lambda: flash_attention_sm90_cuda(q, k, v, splits=1, **kw),
                                  ARGS.reps * 5),
            "card": smi}), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B, H, Tk, D = 4, 16, 32768, 64
    k = torch.randn((B, H, Tk, D), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, H, Tk, D), generator=g, device="cuda").bfloat16()
    for Tq in SPLIT_SWEEP_TQ:
        name = f"split sweep Tq {Tq}"
        if ARGS.only not in name:
            continue
        q = torch.randn((B, H, Tq, D), generator=g, device="cuda").bfloat16()
        blocks = B * H * -(-Tq // fa90.block_rows(Tq, D))
        ranges = split_count(B, H, Tq, Tk, D, causal=False, window=None, q_offset=0,
                             sm_count=sms)
        tried = sorted({1, 2, 3, ranges, -(-4 * sms // blocks)})
        print(json.dumps({
            "shape": name, "q": [B, H, Tq, D], "kv": [B, H, Tk, D],
            "root": os.path.abspath(ARGS.root), "blocks": blocks, "waves": blocks / sms,
            "splits": ranges,
            "by_splits": {S: cuda_ms(lambda: flash_attention_sm90_cuda(q, k, v, causal=False,
                                                                       splits=S), ARGS.reps * 5)
                          for S in tried},
            "card": smi}), flush=True)
        del q
    del k, v
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    ptxas_report(build.build_all(["flash_attention_sm90", "flash_attention_bwd_sm90",
                                  "flash_attention_bwd"]), smi)
    g = torch.Generator(device="cuda").manual_seed(0)
    if ARGS.what in ("all", "backward"):
        time_backward(g, smi, BWD_SHAPES, torch.bfloat16)
    if ARGS.what in ("all", "float32-backward"):
        time_backward(g, smi, F32_BWD_SHAPES, torch.float32)
    if ARGS.what in ("all", "split"):
        time_split(g, smi)
    if ARGS.what == "limits":
        time_limits(smi)
    if ARGS.what not in ("all", "forward"):
        return
    for name, qs, ks, causal, window in SHAPES:
        if ARGS.only not in name:
            continue
        q = torch.randn(qs, generator=g, device="cuda").bfloat16()
        k = torch.randn(ks, generator=g, device="cuda").bfloat16()
        v = torch.randn(ks, generator=g, device="cuda").bfloat16()
        kw = dict(causal=causal, window=window)
        reps = ARGS.reps if qs[2] < 32768 else max(1, ARGS.reps // 4)
        err = None
        if qs[2] * ks[2] <= 512 * 32768:
            got = flash_attention_sm90_cuda(q, k, v, **kw)
            err = float((got.float() - ref_flash_attention(q, k, v, **kw).float()).abs().max())
        ms = cuda_ms(lambda: flash_attention_sm90_cuda(q, k, v, **kw), reps)
        ops_s = 4 * qs[3] * qs[0] * qs[1] * live_pairs(qs[2], ks[2], causal, window) / BF16_FLOP_PER_S
        bytes_s = (2 * q.numel() + k.numel() + v.numel()) * 2 / HBM_BYTES_PER_S
        print(json.dumps({
            "shape": name, "q": list(qs), "kv": list(ks), "root": os.path.abspath(ARGS.root),
            "ms": ms, "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            **(sdpa_backends(q, k, v, None, reps, causal) if window is None else
               {"sdpa_ms": sdpa_ms(q, k, v, causal, window, reps)}),
            **({"sdpa_pick_ms": sdpa_ms(q, k, v, causal, window, reps)}
               if not causal and window is None else {}),
            "max_abs_err": err,
            "row_blocks": row_blocks(qs, ks, causal, window, split_count(
                qs[0], qs[1], qs[2], ks[2], qs[3], causal=causal, window=window, q_offset=0,
                sm_count=torch.cuda.get_device_properties(0).multi_processor_count)),
            "launches_ms": launch_ms(lambda: flash_attention_sm90_cuda(q, k, v, **kw), reps),
            "card": smi}), flush=True)
        del q, k, v
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
