#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

Run from the root of a checkout, with one CUDA card of compute
capability 9.0 or later::

    python3 chip_smoke.py

Phases (each one's failure fails the run):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA source of the port, one nvcc each, all in parallel;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, over the shapes of the kernel tests plus the serving path's;
4. serve: ``repro_torch.launch.serve.generate`` on full-width
   recurrentgemma-2b in bf16 (random weights from a seed), 4 prompts of
   512 byte tokens, 32 new tokens; the launch counts of that run must
   show every kernel of the path (18 ``linear_scan`` launches, one per
   RG-LRU layer, all in the prefill); then the prefill time, the decode
   rate and the peak memory;
5. decode vs teacher forcing: at full width with 4 layers in float32, a
   kernel-backed prefill plus single-step decodes must reproduce the full
   forward's logits (the check of ``tests/test_models.py``);
6. the ``kernels`` line: per kernel, its launches on the serving path,
   its error against the plain version, its time, the plain version's
   time and the least time the card could take, at the path's shape.

It prints one JSON line with the kernels, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``; without a card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import ByteTokenizer  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.linear_scan import linear_scan_cuda  # noqa: E402
from repro_torch.kernels.ref import ref_linear_scan  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models.param_util import tree_leaves  # noqa: E402

ARCH = "recurrentgemma-2b"
BATCH, PROMPT_LEN, MAX_NEW = 4, 512, 32
SCAN_SHAPES = [(2, 64, 32), (3, 100, 17), (1, 1, 8), (4, 257, 130)]  # tests/test_kernels.py
SCAN_TOL = 1e-5                                                       # tests/test_kernels.py
TEACHER_TOL = 2e-2                                                    # tests/test_models.py
# H100 SXM data sheet: HBM3 rate, and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scan_inputs(shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = 0.5 + 0.499 * torch.rand(shape, generator=g, device="cuda")
    x = torch.randn(shape, generator=g, device="cuda")
    return a, x


# ------------------------------------------------------------------ phases


def phase_device(state):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap < (9, 0):
        raise RuntimeError(f"compute capability {cap} < (9, 0): the kernels target sm_90a")
    state["kind"] = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    state["smi"] = smi.stdout.strip().splitlines()[0]
    log(f"device: {state['kind']} capability {cap}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible")
    # float32 products in full float32 on the card, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: matmul.allow_tf32=False cudnn.allow_tf32=False")


def phase_build(state):
    t0 = time.perf_counter()
    logs = build.build_all()
    state["build_s"] = time.perf_counter() - t0
    for name in build.SOURCES:
        build.load(name)
        for line in logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"build: {len(build.SOURCES)} source(s) in {state['build_s']:.2f} s")


def phase_scan_vs_plain(state):
    path_shape = (BATCH, PROMPT_LEN, state["cfg"].rnn_width)
    worst = 0.0
    for i, shape in enumerate(SCAN_SHAPES + [path_shape]):
        a, x = scan_inputs(shape, seed=100 + i)
        got = linear_scan_cuda(a, x)
        want = ref_linear_scan(a, x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=SCAN_TOL, atol=SCAN_TOL)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"  linear_scan {shape}: max abs err {err:.3e}")
    state["scan_err"] = worst
    log(f"kernel vs plain: linear_scan within rtol=atol={SCAN_TOL} (worst {worst:.3e})")


def prompts_for(seed):
    tok = ByteTokenizer()
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(BATCH):
        text = bytes(rng.integers(32, 127, PROMPT_LEN - 2).astype(np.uint8)).decode()
        out.append(tok.encode(text, add_special=True))
    return out


def phase_serve(state):
    cfg = state["cfg"]
    n_rglru = sum(1 for i in range(cfg.n_layers)
                  if cfg.block_pattern[i % len(cfg.block_pattern)] == "rglru")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"serve: {cfg.name} {cfg.n_layers} layers ({n_rglru} rglru), d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}, {n_params / 1e9:.3f} B params")
    prompts = prompts_for(seed=1)
    max_len = PROMPT_LEN + MAX_NEW

    # -- the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = generate(model, params, prompts, max_new=MAX_NEW, max_len=max_len, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    state["launches"] = counts
    log(f"  generate: {BATCH}x{PROMPT_LEN} prompt + {MAX_NEW} new tokens in {wall:.3f} s "
        f"(first call); launches {counts}")
    if counts["linear_scan"] != n_rglru:
        raise AssertionError(f"linear_scan launched {counts['linear_scan']} times, "
                             f"expected {n_rglru} (one per RG-LRU layer)")
    for p, o in zip(prompts, outs):
        if o.shape != (PROMPT_LEN + MAX_NEW,) or not np.array_equal(o[:PROMPT_LEN], p):
            raise AssertionError(f"bad output shape {o.shape} or prompt not preserved")
        if not ((o >= 0) & (o < cfg.vocab_size)).all():
            raise AssertionError("token outside the vocabulary")

    # -- timings through the same entry points, warm
    tokens = torch.as_tensor(np.stack(prompts).astype(np.int64), device="cuda")
    with torch.inference_mode():
        prefill_ms = []
        for _ in range(3):
            cache = model.init_cache(BATCH, max_len, device="cuda")
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, {"tokens": tokens}, cache)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
            if ops.launch_counts()["linear_scan"] != n_rglru:
                raise AssertionError(f"prefill launched {ops.launch_counts()} scans")
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite prefill logits")
        tok = torch.argmax(logits, dim=-1)
        finite = torch.ones((), dtype=torch.bool, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MAX_NEW):   # no host sync inside the loop, as in generate
            logits, cache = model.decode_step(params, tok, PROMPT_LEN + i, cache)
            finite &= torch.isfinite(logits).all()
            tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        if not bool(finite):
            raise AssertionError("non-finite decode logits")
    state["serve"] = {
        "prefill_ms": sorted(prefill_ms)[1],
        "decode_tok_s": BATCH * MAX_NEW / decode_s,
        "decode_ms_per_step": decode_s * 1e3 / MAX_NEW,
        "peak_gib": peak / 2**30,
        "generate_first_call_s": wall,
    }
    log(f"  prefill {BATCH}x{PROMPT_LEN}: {state['serve']['prefill_ms']:.2f} ms (median of 3: "
        f"{', '.join(f'{m:.2f}' for m in prefill_ms)}); decode {state['serve']['decode_tok_s']:.1f} "
        f"tok/s ({state['serve']['decode_ms_per_step']:.2f} ms/step, batch {BATCH}); "
        f"peak memory {state['serve']['peak_gib']:.2f} GiB; on {state['smi']}")
    del params, model, cache, logits
    torch.cuda.empty_cache()


def phase_teacher_forcing(state):
    cfg = dataclasses.replace(state["cfg"], n_layers=4, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    B, T, T0 = 2, 48, 40
    g = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g, device="cuda")
    with torch.inference_mode():
        x = params["embed"]["table"][toks]
        full = LM._logits(params, cfg, LM.apply_stack_train(
            params, cfg, x, torch.arange(T, device="cuda"))[0])
        cache = model.init_cache(B, T + 4, device="cuda")
        ops.reset_launch_counts()
        lg, cache = model.prefill(params, {"tokens": toks[:, :T0]}, cache)
        scans = ops.launch_counts()["linear_scan"]
        errs = [float((lg - full[:, T0 - 1]).abs().max())]
        for t in range(T0, T):
            lg, cache = model.decode_step(params, toks[:, t], t, cache)
            errs.append(float((lg - full[:, t]).abs().max()))
    log(f"teacher forcing: {cfg.n_layers} layers {cfg.block_pattern} + rest, d_model "
        f"{cfg.d_model}, float32, prefill {T0} + {T - T0} decode steps: max |dlogit| "
        f"{max(errs):.3e} (tol {TEACHER_TOL})")
    if scans != 3:
        raise AssertionError(f"the prefill ran {scans} scan kernels, expected 3")
    if not max(errs) < TEACHER_TOL:
        raise AssertionError(f"decode disagrees with the full forward: {errs}")
    del params, model, cache, full
    torch.cuda.empty_cache()


def phase_kernel_times(state):
    B, T, D = BATCH, PROMPT_LEN, state["cfg"].rnn_width
    a, x = scan_inputs((B, T, D), seed=7)
    err = float((linear_scan_cuda(a, x) - ref_linear_scan(a, x)).abs().max())
    n = B * T * D
    bytes_bound = 12 * n / HBM_BYTES_PER_S
    ops_bound = 2 * n / F32_FLOP_PER_S
    state["kernels"] = [{
        "name": "linear_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
        "replaces": "src/repro/kernels/linear_scan.py:48",
        "launches": state["launches"]["linear_scan"],
        "max_abs_err": max(err, state["scan_err"]),
        "ms": cuda_ms(lambda: linear_scan_cuda(a, x), reps=200),
        "plain_ms": cuda_ms(lambda: ref_linear_scan(a, x), reps=5),
        "bound_ms": max(bytes_bound, ops_bound) * 1e3,
        "bound_by": "bytes" if bytes_bound >= ops_bound else "operations",
        "library_ms": None,   # no single PyTorch call computes a linear recurrence
        "shape": [B, T, D],
        "dtype": "float32",
        "bound_basis": f"12 B/element over {HBM_BYTES_PER_S:.3g} B/s (H100 SXM HBM3)",
    }]
    k = state["kernels"][0]
    log(f"linear_scan ({B},{T},{D}) f32: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.3f} ms, "
        f"bound {k['bound_ms']:.4f} ms ({k['bound_ms'] / k['ms']:.1%} of HBM roofline) "
        f"on {state['smi']}")


PHASES = [
    ("device", phase_device),
    ("build", phase_build),
    ("kernel vs plain", phase_scan_vs_plain),
    ("serve", phase_serve),
    ("decode vs teacher forcing", phase_teacher_forcing),
    ("kernel times", phase_kernel_times),
]


def main() -> int:
    state = {"cfg": get_config(ARCH)}
    failed = []
    for name, fn in PHASES:
        if failed and failed[0] in ("device", "build"):
            break   # nothing can run without the card or the kernels
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn(state)
        except Exception:
            traceback.print_exc()
            failed.append(name)
            log(f"FAILED: {name}")
        log(f"   ({time.perf_counter() - t0:.1f} s)")
    if failed or "kernels" not in state:
        log(f"chip_smoke: failed phases: {failed}")
        return 1
    print(json.dumps({"kernels": state["kernels"]}))
    print(state["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": state["kind"],
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
