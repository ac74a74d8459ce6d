#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

Run from the root of a checkout, with one CUDA card of compute
capability 9.0 or later::

    python3 chip_smoke.py

Phases (each one's failure fails the run):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA source of the port, one nvcc each, all in parallel;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, over the shapes of the kernel tests plus the serving path's
   (``linear_scan``) and the training path's (``page_digest`` bit-equal
   over the digest tests' sweep and one full-size leaf, the stacked
   ``w_up`` master of olmo-1b, 16 x 2048 x 8192 float32 at 256 KiB
   pages; ``delta_mask`` bit-equal over 63,000 rows with planted
   differences);
4. serve: ``repro_torch.launch.serve.generate`` on full-width
   recurrentgemma-2b in bf16 (random weights from a seed), 4 prompts of
   512 byte tokens, 32 new tokens; the launch counts of that run must
   show every kernel of the path (18 ``linear_scan`` launches, one per
   RG-LRU layer, all in the prefill); then the prefill time, the decode
   rate and the peak memory;
5. decode vs teacher forcing: at full width with 4 layers in float32, a
   kernel-backed prefill plus single-step decodes must reproduce the full
   forward's logits (the check of ``tests/test_models.py``);
6. train: ``repro_torch.launch.train.main`` at its default size (6
   steps, two checkpoints: every leaf digested twice and masked once);
   then full-width olmo-1b (bf16 params, fp32 AdamW state, 1.18 B
   parameters, 16.5 GB of state) takes 3 AdamW steps at batch 2 x 2048
   tokens from a seeded synthetic corpus in a BlobSeer blob, with finite
   loss and grad norm; a ``BlobCheckpointer`` at 256 KiB pages saves the
   whole state (one ``page_digest`` launch per leaf, every page
   written), restores it into fresh tensors on the card (byte-equal),
   and saves again with only ``extra`` moved (one ``delta_mask`` launch
   per leaf, no page written); then the step time, the save and restore
   times, the peak device memory and the host's peak RSS;
7. the ``kernels`` line: per kernel, its launches on its path (serving
   for ``linear_scan``, training for the other two), its error against
   the plain version, its time, the plain version's time, the least time
   the card could take and, where one PyTorch call computes the same
   function, that call's time, at the path's shape.

It prints one JSON line with the kernels, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``; without a card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import resource
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import BlobCheckpointer  # noqa: E402
from repro_torch.checkpoint.blobckpt import flatten_with_paths  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import BlobSeerService  # noqa: E402
from repro_torch.data import ByteTokenizer, CorpusWriter, ShardedReader  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.delta_mask import delta_mask_cuda  # noqa: E402
from repro_torch.kernels.linear_scan import linear_scan_cuda  # noqa: E402
from repro_torch.kernels.page_digest import padded_page_words, page_digest_cuda  # noqa: E402
from repro_torch.kernels.ref import (ref_delta_mask, ref_linear_scan,  # noqa: E402
                                     ref_page_digest)
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.launch.train import synthesize_corpus  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models.param_util import tree_leaves  # noqa: E402
from repro_torch.train import AdamWConfig, TrainStepBuilder  # noqa: E402

ARCH = "recurrentgemma-2b"
BATCH, PROMPT_LEN, MAX_NEW = 4, 512, 32
TRAIN_ARCH = "olmo-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 3
CKPT_PSIZE = 256 * 1024                     # BlobCheckpointer's default page
# the digest tests' sweep (tests/test_torch_digest.py): word-domain pages,
# byte cases (page bytes, total bytes) and leaves at 4096-byte pages
DIGEST_WORD_SHAPES = [(1, 512), (3, 512), (8, 1024), (17, 1536)]
DIGEST_BYTE_CASES = [(64 * 1024, 3 * 64 * 1024), (4096, 4096 * 2 + 100), (100, 700), (8, 8)]
DIGEST_LEAVES = [(torch.float32, 5000), (torch.bfloat16, 5000), (torch.int32, 5000),
                 (torch.bfloat16, 5001), (torch.float32, 37)]
FULL_LEAF = (16, 2048, 8192)                # olmo-1b's stacked w_up master, float32
MASK_ROWS, MASK_PLANTED = 63_000, 257
SCAN_SHAPES = [(2, 64, 32), (3, 100, 17), (1, 1, 8), (4, 257, 130)]  # tests/test_kernels.py
SCAN_TOL = 1e-5                                                       # tests/test_kernels.py
TEACHER_TOL = 2e-2                                                    # tests/test_models.py
# H100 SXM data sheet: HBM3 rate, and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# The digest and the mask do 32-bit integer work on the CUDA cores; the
# data sheet gives no integer rate outside the tensor cores, so their
# operations are counted against its CUDA-core (float32) rate.  Both
# kernels are bound by bytes at any plausible integer rate.
CUDA_CORE_OP_PER_S = F32_FLOP_PER_S


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


def digest_case(t: torch.Tensor, psize: int) -> int:
    """The kernel's digests of ``t``'s bytes against the plain version's;
    returns the largest difference of the uint32 values (0 when equal)."""
    got = page_digest_cuda(ops.leaf_bytes(t), psize)
    want = ref_page_digest(ops.as_page_words(t, psize))
    torch.cuda.synchronize()
    err = int((got.long() & 0xFFFFFFFF).sub(want.long() & 0xFFFFFFFF).abs().max()) \
        if got.numel() else 0
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"page_digest {tuple(t.shape)} {t.dtype} at {psize} B pages: "
                             f"{got.shape} vs {want.shape}, max |diff| {err}")
    return err


def phase_digest_vs_plain(state):
    g = torch.Generator(device="cuda").manual_seed(11)
    worst, n = 0, 0
    for n_pages, n_words in DIGEST_WORD_SHAPES:
        words = torch.randint(-2**31, 2**31 - 1, (n_pages, n_words), dtype=torch.int32,
                              device="cuda", generator=g)
        if not torch.equal(page_digest_cuda(ops.leaf_bytes(words), n_words * 4),
                           ref_page_digest(words)):
            raise AssertionError(f"page_digest words ({n_pages}, {n_words})")
        worst, n = max(worst, digest_case(words, n_words * 4)), n + 1
    for psize, total in DIGEST_BYTE_CASES:
        data = torch.randint(0, 256, (total,), dtype=torch.uint8, device="cuda", generator=g)
        worst, n = max(worst, digest_case(data, psize)), n + 1
    for dtype, numel in DIGEST_LEAVES:
        leaf = torch.randn(numel, device="cuda", generator=g)
        leaf = (leaf * 1000).to(dtype) if dtype == torch.int32 else leaf.to(dtype)
        worst, n = max(worst, digest_case(leaf, 4096)), n + 1
    # a leaf that starts off a 16-byte boundary takes the byte-wise loads
    odd = torch.randint(0, 256, (3 * 4096 + 7,), dtype=torch.uint8, device="cuda",
                        generator=g)[3:]
    worst, n = max(worst, digest_case(odd, 4096)), n + 1
    big = torch.randn(FULL_LEAF, device="cuda", generator=g)
    worst, n = max(worst, digest_case(big, CKPT_PSIZE)), n + 1
    del big
    state["digest_err"] = worst
    log(f"kernel vs plain: page_digest bit-equal in {n} cases incl. {FULL_LEAF} float32 "
        f"at {CKPT_PSIZE} B pages")

    new = torch.randint(-2**31, 2**31 - 1, (MASK_ROWS, 2), dtype=torch.int32, device="cuda",
                        generator=g)
    old = new.clone()
    rows = torch.randperm(MASK_ROWS, device="cuda", generator=g)[:MASK_PLANTED]
    cols = torch.randint(0, 3, (MASK_PLANTED,), device="cuda", generator=g)
    old[rows[cols != 1], 0] += 1          # col 0, or both when cols == 2
    old[rows[cols != 0], 1] ^= 1 << 30    # col 1, or both
    got = delta_mask_cuda(new, old)
    want = ref_delta_mask(new, old)
    torch.cuda.synchronize()
    if not torch.equal(got, want) or int(got.sum()) != MASK_PLANTED:
        raise AssertionError(f"delta_mask: {int(got.sum())} rows flagged, plain "
                             f"{int(want.sum())}, planted {MASK_PLANTED}")
    state["mask_err"] = int((got.int() - want.int()).abs().max())
    log(f"kernel vs plain: delta_mask bit-equal over {MASK_ROWS} rows "
        f"({MASK_PLANTED} planted differences found)")


def host_rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20   # KiB on Linux


def phase_train_entry(state):
    """``repro_torch.launch.train.main`` as a user calls it, on the card:
    its default (CPU-sized) olmo-1b, 6 steps, a checkpoint every 3."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train_main(["--steps", "6", "--ckpt-every", "3", "--quiet"])
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_leaves = len(flatten_with_paths(out["state"]))
    log(f"train entry point: {len(out['losses'])} steps, losses "
        f"{', '.join(f'{x:.4f}' for x in out['losses'])} in {wall:.2f} s; launches {counts}")
    if len(out["losses"]) != 6 or not np.isfinite(out["losses"]).all():
        raise AssertionError(f"bad losses {out['losses']}")
    if out["state"]["params"]["embed"]["table"].device.type != "cuda":
        raise AssertionError("the entry point did not train on the card")
    # two saves: every leaf digested twice, masked once (the second save)
    if counts["page_digest"] != 2 * n_leaves or counts["delta_mask"] != n_leaves:
        raise AssertionError(f"expected {2 * n_leaves} digests and {n_leaves} masks")
    del out
    torch.cuda.empty_cache()


def phase_train(state):
    cfg = get_config(TRAIN_ARCH)
    tok = ByteTokenizer()
    svc = BlobSeerService(n_providers=4, n_meta_shards=4)
    client = svc.client("trainer")
    writer = CorpusWriter(client, psize=16 * 1024)
    synthesize_corpus(writer, tok, n_docs=400)
    reader = ShardedReader(client, writer.blob_id, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    builder = TrainStepBuilder(build_model(cfg),
                               opt=AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100))
    step_fn = builder.train_step_fn()

    # -- the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    train_state = builder.init_state(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = flatten_with_paths(train_state)
    n_params = sum(t.numel() for t in tree_leaves(train_state["params"]))
    state_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
    log(f"train: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}, {n_params / 1e9:.3f} B params, state "
        f"{state_bytes / 1e9:.2f} GB in {len(leaves)} leaves (init {init_s:.2f} s)")
    step_ms = []
    for _ in range(TRAIN_STEPS):
        tokens, labels = reader.next_batch()
        batch = {"tokens": torch.as_tensor(tokens, device="cuda"),
                 "labels": torch.as_tensor(labels, device="cuda")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_state, metrics = step_fn(train_state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        step_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"  step {int(train_state['step'])}: loss {loss:.4f} grad norm {gnorm:.4f} "
            f"in {step_ms[-1]:.1f} ms")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"non-finite loss {loss} or grad norm {gnorm}")
    del metrics, batch
    step_peak = torch.cuda.max_memory_allocated()
    leaves = flatten_with_paths(train_state)    # the step counter is a new tensor

    ckpt = BlobCheckpointer(client, psize=CKPT_PSIZE)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    st1 = ckpt.save(train_state, step=TRAIN_STEPS, extra={"reader": reader.state_dict()})
    save_s = time.perf_counter() - t0
    after = ops.launch_counts()
    digests = after["page_digest"] - before["page_digest"]
    log(f"  full save: {st1.pages_written}/{st1.pages_total} pages, "
        f"{st1.written_bytes / 1e9:.2f} GB in {save_s:.2f} s, {digests} page_digest launches; "
        f"host peak RSS {host_rss_gib():.1f} GiB")
    if digests != len(leaves) or after["delta_mask"] != before["delta_mask"]:
        raise AssertionError(f"full save launched {digests} digests for {len(leaves)} leaves")
    if st1.pages_written != st1.pages_total:
        raise AssertionError("the first save must write every page")

    t0 = time.perf_counter()
    restored = ckpt.restore(builder.abstract_state(), device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = flatten_with_paths(restored)
    if [k for k, _ in got] != [k for k, _ in leaves]:
        raise AssertionError("restored tree differs")
    for (k, a), (_, b) in zip(got, leaves):
        if a.dtype != b.dtype or a.shape != b.shape or \
                not torch.equal(ops.leaf_bytes(a), ops.leaf_bytes(b)):
            raise AssertionError(f"restored leaf {k} differs")
    del restored, got
    log(f"  restore: {len(leaves)} leaves byte-equal on the card in {restore_s:.2f} s")

    before = ops.launch_counts()
    t0 = time.perf_counter()
    st2 = ckpt.save(train_state, step=TRAIN_STEPS,
                    extra={"reader": reader.state_dict(), "note": "extra moved"})
    save2_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    masks = counts["delta_mask"] - before["delta_mask"]
    log(f"  second save, state unchanged: {st2.pages_written}/{st2.pages_total} pages in "
        f"{save2_s:.2f} s, {masks} delta_mask launches")
    if masks != len(leaves) or counts["page_digest"] - before["page_digest"] != len(leaves):
        raise AssertionError(f"second save launched {masks} masks for {len(leaves)} leaves")
    if st2.pages_written != 0:
        raise AssertionError("an unchanged state must write no page")
    state["train_launches"] = counts
    peak = torch.cuda.max_memory_allocated()

    # the whole state's delta scan, timed outside the counted path
    data = [ops.leaf_bytes(t) for _, t in leaves]
    scan_ms = cuda_ms(lambda: [page_digest_cuda(d, CKPT_PSIZE) for d in data], reps=5)
    padded = sum(-(-d.numel() // CKPT_PSIZE) * padded_page_words(CKPT_PSIZE) * 4 for d in data)
    free = subprocess.run(["free", "-g"], capture_output=True, text=True, timeout=60).stdout
    state["train"] = {
        "step_ms": step_ms, "save_s": save_s, "restore_s": restore_s, "save2_s": save2_s,
        "peak_gib": peak / 2**30, "step_peak_gib": step_peak / 2**30,
        "host_rss_gib": host_rss_gib(), "pages": st1.pages_total,
        "state_gb": state_bytes / 1e9, "state_digest_ms": scan_ms,
        "state_digest_bound_ms": padded / HBM_BYTES_PER_S * 1e3,
    }
    t = state["train"]
    log(f"  step {TRAIN_BATCH}x{TRAIN_SEQ}: {', '.join(f'{m:.1f}' for m in step_ms)} ms; "
        f"save {save_s:.2f} s, restore {restore_s:.2f} s, unchanged save {save2_s:.2f} s; "
        f"peak device memory {t['peak_gib']:.2f} GiB (steps {t['step_peak_gib']:.2f}); "
        f"host peak RSS {t['host_rss_gib']:.1f} GiB; whole-state page_digest "
        f"{scan_ms:.3f} ms vs bound {t['state_digest_bound_ms']:.3f} ms; on {state['smi']}")
    log("  free -g:\n" + free.rstrip())
    del train_state, leaves, data, ckpt, svc, client
    torch.cuda.empty_cache()


def phase_kernel_times(state):
    B, T, D = BATCH, PROMPT_LEN, state["cfg"].rnn_width
    a, x = scan_inputs((B, T, D), seed=7)
    err = float((linear_scan_cuda(a, x) - ref_linear_scan(a, x)).abs().max())
    n = B * T * D
    bytes_bound = 12 * n / HBM_BYTES_PER_S
    ops_bound = 2 * n / F32_FLOP_PER_S
    kernels = [{
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
    del a, x

    # page_digest at the training path's largest leaf: the stacked w_up
    # master, read once (its padded pages), 8 B of digest written a page
    leaf = torch.randn(FULL_LEAF, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(8))
    data = ops.leaf_bytes(leaf)
    n_pages = -(-data.numel() // CKPT_PSIZE)
    words = n_pages * padded_page_words(CKPT_PSIZE)
    dg_bytes = words * 4 + n_pages * 8
    dg_ops = 2 * 3 * words        # add salt, multiply, add, for each of the two lanes
    kernels.append({
        "name": "page_digest",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/page_digest.cu",
        "replaces": "src/repro/kernels/page_digest.py:85",
        "launches": state["train_launches"]["page_digest"],
        "max_abs_err": max(state["digest_err"], digest_case(leaf, CKPT_PSIZE)),
        "ms": cuda_ms(lambda: page_digest_cuda(data, CKPT_PSIZE), reps=20),
        "plain_ms": cuda_ms(lambda: ref_page_digest(ops.as_page_words(data, CKPT_PSIZE)),
                            reps=3),
        "bound_ms": max(dg_bytes / HBM_BYTES_PER_S, dg_ops / CUDA_CORE_OP_PER_S) * 1e3,
        "bound_by": "bytes" if dg_bytes / HBM_BYTES_PER_S >= dg_ops / CUDA_CORE_OP_PER_S
        else "operations",
        "library_ms": None,   # no PyTorch op does a wrapping uint32 multiply-accumulate
        "shape": list(FULL_LEAF),
        "dtype": "float32",
        "page_bytes": CKPT_PSIZE,
        "bound_basis": f"padded page bytes read + 8 B/page written over "
                       f"{HBM_BYTES_PER_S:.3g} B/s (H100 SXM HBM3)",
    })
    del leaf, data

    # delta_mask at the same leaf's page count (its launch on the main path)
    g = torch.Generator(device="cuda").manual_seed(9)
    new = torch.randint(-2**31, 2**31 - 1, (n_pages, 2), dtype=torch.int32, device="cuda",
                        generator=g)
    old = new.clone()
    old[::97, 1] += 1
    err = int((delta_mask_cuda(new, old).int() - ref_delta_mask(new, old).int()).abs().max())
    dm_bytes = n_pages * (8 + 8 + 4)
    dm_ops = n_pages * 3          # two compares and an or per row
    kernels.append({
        "name": "delta_mask",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_mask.cu",
        "replaces": "src/repro/kernels/delta_mask.py:29",
        "launches": state["train_launches"]["delta_mask"],
        "max_abs_err": max(state["mask_err"], err),
        "ms": cuda_ms(lambda: delta_mask_cuda(new, old), reps=200),
        "plain_ms": cuda_ms(lambda: ref_delta_mask(new, old), reps=200),
        "bound_ms": max(dm_bytes / HBM_BYTES_PER_S, dm_ops / CUDA_CORE_OP_PER_S) * 1e3,
        "bound_by": "bytes" if dm_bytes / HBM_BYTES_PER_S >= dm_ops / CUDA_CORE_OP_PER_S
        else "operations",
        "library_ms": cuda_ms(lambda: (new != old).any(dim=1), reps=200),
        "shape": [n_pages, 2],
        "dtype": "int32",
        "bound_basis": f"20 B/row over {HBM_BYTES_PER_S:.3g} B/s (H100 SXM HBM3)",
    })
    state["kernels"] = kernels
    for k in kernels:
        log(f"{k['name']} {k['shape']} {k['dtype']}: kernel {k['ms']:.4f} ms, plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']}, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_ms'] / k['ms']:.1%} of roofline), {k['launches']} launches on the "
            f"path, on {state['smi']}")


PHASES = [
    ("device", phase_device),
    ("build", phase_build),
    ("kernel vs plain", phase_scan_vs_plain),
    ("digest and mask vs plain", phase_digest_vs_plain),
    ("serve", phase_serve),
    ("decode vs teacher forcing", phase_teacher_forcing),
    ("train entry point", phase_train_entry),
    ("train and checkpoint", phase_train),
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
