#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

Run from the root of a checkout, with one CUDA card of compute
capability 9.0 or later::

    python3 chip_smoke.py

Phases (each one's failure fails the run):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA source of the port, one nvcc each, all in parallel;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, over the shapes of the kernel tests plus the serving path's and
   a long prompt's (``linear_scan`` bit-equal, ``torch.equal``, and within
   1e-5 at (4, 512, 2560) and (4, 8192, 2560)) and the training path's
   (``page_digest`` bit-equal
   over the digest tests' sweep and one full-size leaf, the stacked
   ``w_up`` master of olmo-1b, 16 x 2048 x 8192 float32 at 256 KiB
   pages; ``delta_mask`` bit-equal over 63,000 rows with planted
   differences); and
   attention against its plain version over the attention tests' sweep:
   ``flash_attention_sm90`` (bf16 on the tensor cores) on every case in
   bf16, within 3e-2 and 2^-7 |want| + 1e-4 per element, and
   ``flash_attention`` (float32 arithmetic) on the float32 cases within
   2e-5, with Tq = 1, ragged lengths, softcap, windows, D = 8 to 256,
   strided k and v, a ``q_offset`` that leaves rows fully masked (zeros),
   float32-only cases at the float32 kernel's tile edges (Tq off its row
   tile, D = 33, 100, 120, 256, query groups of 1, 3, 8 and 32, a window
   inside one key tile), the long serving path's shape (4, 32, 8192, 120) over
   (4, 8, 8192, 120) with a 4096 window, in both dtypes and layouts, and
   the encoder-decoder's three unmasked shapes over 32768 frames of 16
   heads of 64 in both dtypes: the encoder's self-attention (batch 1, v
   strided), the prefill's cross-attention (4, 16, 512, 64) and a decode
   step's (4, 16, 1, 64);
4. serve: ``repro_torch.launch.serve.generate`` on full-width
   recurrentgemma-2b in bf16 (random weights from a seed), 4 prompts of
   512 byte tokens, 32 new tokens; the launch counts of that run must
   show every kernel of the path (18 ``linear_scan`` launches, one per
   RG-LRU layer, all in the prefill); then the prefill time, the decode
   rate and the peak memory;
5. decode vs teacher forcing: at full width with 4 layers in float32, a
   kernel-backed prefill plus single-step decodes must reproduce the full
   forward's logits (the check of ``tests/test_models.py``);
6. long-context serve: ``generate`` on full-width h2o-danube3-4b in
   bf16 (3.96 B parameters, sliding window 4096), 4 prompts of 8192
   tokens, 32 new tokens: every prefill attention is over more than 4096
   kv positions, so the run must launch ``flash_attention_sm90`` exactly
   once per layer (24) per prefill, and the float32 kernel never; then
   the prefill time (median of 3), the decode rate over the rolling
   window cache and the peak memory;
7. long decode vs teacher forcing: h2o-danube3-4b at full width with 4
   layers in float32, an 8160-token prefill (kernel) and 32 single-step
   decodes (no kernel) against one forward over the 8192 tokens
   (kernel): the last 32 positions' logits within 2e-2; float32 inputs
   run the float32 ``flash_attention``;
8. train: ``repro_torch.launch.train.main`` at its default size (6
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
9. the modules without a kernel (the reference runs no Pallas kernel
   there; each run must launch none): ``generate`` on full-width
   olmoe-1b-7b in bf16 (6.919 B parameters, 64 experts top-8), 4 x 512
   byte tokens + 32 new, with the prefill time (median of 3), the decode
   rate, the peak memory and the (token, choice) pairs the prefill's
   expert capacity dropped; olmoe-1b-7b at full width with 2 layers in
   float32 on the card and on the CPU from the same parameters and
   tokens (a 2 x 128 prefill and 8 decode steps): logits within 2e-3 and
   the same experts at every (token, choice) unless the two router
   probabilities are within 1e-6; full-width granite-moe-1b-a400m (bf16
   params, fp32 AdamW state, 18.7 GB) takes 3 steps at batch 2 x 2048
   at remat ``"full"``, then the next batch's forward and backward at
   ``"full"`` and ``"dots"`` and one step at ``"dots"`` from the same
   state and batch (losses equal within 1e-5 relative, aux > 0), with
   step and forward-backward times and peak memory per policy;
   ``generate`` on full-width xlstm-350m (21 mLSTM + 3 sLSTM layers) in
   bf16, 4 x 512 + 32 new; and xlstm-350m at full width with 8 layers
   in float32, a 500-token prefill and 12 decodes against one forward
   over 512 tokens (2e-2);
10. the encoder-decoder: full-width seamless-m4t-large-v2 in bf16 (24 +
   24 layers, 1.632 B parameters) serves 4 x 32768 frame embeddings
   (numpy, from a seed) and 4 x 512 byte tokens through the facade's
   ``prefill`` and 31 greedy ``decode_step``s over its memories: exactly
   48 + 24 x 31 ``flash_attention_sm90`` launches (every encoder layer,
   every cross-attention) and no float32 one; then the prefill time
   (median of 3), the encoder's and the memories' times, the decode rate
   and the peak memory; 4 + 4 layers in float32 over 1 x 8192 frames, a
   512-token prefill and 32 decodes against one ``decode_train`` over the
   544 tokens (2e-2; the float32 ``flash_attention``, 8 + 8 + 128
   launches); full-width training at 2 x 2048 frames and tokens (bf16
   params, fp32 AdamW state, remat ``"full"``), 3 steps, finite, no
   launch (2048 frames stay dense: the kernels have no backward);
11. the mesh paths, on a (1, 1) ("data", "model") ``DeviceMesh`` over a
   one-rank NCCL group (``repro_torch.distributed``): full-width olmo-1b
   under ``tp_fsdp`` + ``zero2`` with ``accum=2`` takes two steps at
   2 x 2048 from the state and batches of a no-mesh ``accum=2`` run
   (losses within 1e-4 relative, parameters within rtol 5e-4), then its
   state is saved whole (34 ``page_digest`` launches on the gathered
   leaves), restored into the mesh placements (byte-equal) and saved
   again unchanged (34 + 34 launches, no page); ``compressed_grad_mean``
   over NCCL on that state's gradients, each leaf within one int8 step
   (scale / 127); full-width h2o-danube3-4b under ``tp_serve_sm``: the
   long-context phase's 4 x 8192 prompts (24 ``flash_attention_sm90``
   launches on the local shards) and 32 decode steps through
   ``sharded_decode_attention``, teacher-forced on that phase's greedy
   tokens and held to its logits (max |dlogit| and the share of equal
   greedy tokens reported, no bound), and its 4-layer float32 copy
   against its own no-mesh run within rtol 2e-4, atol 2e-5 (4 + 4
   float32 launches); step, prefill and decode times and peaks beside
   the no-mesh ones;
12. dry run: ``repro_torch.launch.dryrun`` in three processes at once
   (their fake process groups apart from this one's NCCL group), on fake
   tensors over a fake 256-rank 16 x 16 mesh: olmo-1b ``train_4k``
   (``tp_fsdp``), qwen3-32b ``train_4k`` (both at one microbatch),
   h2o-danube3-4b ``prefill_32k`` (``tp_serve``), granite-moe-1b-a400m
   ``decode_32k``, recurrentgemma-2b ``long_500k``, and olmo-1b
   ``train_4k`` over 512 ranks (2 x 16 x 16): each must be ``ok``; and a
   (1, 1) record of the train phase's step (olmo-1b, 2 x 2048), whose
   input bytes must equal the bytes the train phase's state and batch
   hold on the card within 0.1 %, its temp-bytes estimate printed beside
   that phase's measured peak;
13. roofline vs card: for the olmo-1b train step at 2 x 2048 and the
   h2o-danube3-4b prefill at 4 x 8192 of this run, the model FLOPs, the
   cost model's roofline at (1, 1) with the H100's constants, the
   measured time and model FLOPs / 989e12 / measured seconds; and the
   host time of a call of ``ops.flash_attention`` (the custom-op
   binding's fake-tensor check) against the kernel's wrapper at a
   seamless decode step's shape;
14. examples: ``examples/train_e2e_torch.py`` at its defaults with its
   crash at step 150, and uninterrupted: the losses after the resume
   equal bit for bit; ``examples/branch_experiments_torch.py``: each
   fork adds no data page, the trunk restores byte-equal after the
   branches; their saves launch ``page_digest`` and ``delta_mask``;
15. the ``kernels`` line: per kernel, its launches on its paths (serving
   recurrentgemma-2b for ``linear_scan``, training, mesh training and the
   examples for ``page_digest`` and ``delta_mask``, long-context, encoder-decoder and
   mesh serving for ``flash_attention_sm90``, the float32 long and
   encoder-decoder teacher forcing and the float32 mesh serve for
   ``flash_attention``; ``launches_by_path``),
   its error against
   the plain version, its time, the plain version's time, the least time
   the card could take and, where one PyTorch call computes the same
   function, that call's time, at the path's shape (``linear_scan`` also
   at (4, 8192, 2560): ``long_ms``, ``long_plain_ms``, ``long_bound_ms``;
   for both attention
   kernels, ``scaled_dot_product_attention`` with the window-causal
   boolean mask in the kernel's dtype, which the port never calls);
   ``flash_attention_sm90`` also at the encoder-decoder's three shapes
   (``seamless``: error, time, plain time, bound, and
   ``scaled_dot_product_attention`` with no mask).

It prints one JSON line with the kernels, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``; without a card it exits non-zero and
prints no result.  ``--phases a,b,...`` runs only the named phases, in
their order (for work on one path; such a run prints no result).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import resource
import socket
import subprocess
import sys
import time
import traceback
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import BlobCheckpointer  # noqa: E402
from repro_torch.checkpoint.blobckpt import flatten_with_paths  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import BlobSeerService  # noqa: E402
from repro_torch.data import ByteTokenizer, CorpusWriter, ShardedReader  # noqa: E402
from repro_torch.distributed.collectives import compressed_grad_mean  # noqa: E402
from repro_torch.distributed.partitioning import full as whole  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.delta_mask import delta_mask_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention_sm90 import flash_attention_sm90_cuda  # noqa: E402
from repro_torch.kernels.linear_scan import linear_scan_cuda  # noqa: E402
from repro_torch.kernels.page_digest import padded_page_words, page_digest_cuda  # noqa: E402
from repro_torch.kernels.ref import (ref_delta_mask, ref_flash_attention,  # noqa: E402
                                     ref_linear_scan, ref_page_digest)
from repro_torch.configs.shapes import ShapeCell  # noqa: E402
from repro_torch.launch.costmodel import analytic_roofline  # noqa: E402
from repro_torch.launch.hlo import F32_FLOPS, HBM_BW, PEAK_FLOPS  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.specs import model_flops_for  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.train import synthesize_corpus  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.param_util import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import AdamWConfig, TrainStepBuilder  # noqa: E402
from repro_torch.train.optimizer import global_norm  # noqa: E402

ARCH = "recurrentgemma-2b"
BATCH, PROMPT_LEN, MAX_NEW = 4, 512, 32
LONG_ARCH = "h2o-danube-3-4b"
LONG_BATCH, LONG_PROMPT, LONG_NEW = 4, 8192, 32   # the published context, twice the window
LONG_TF_PREFILL = 8160                            # teacher forcing: 8160 + 32 decodes = 8192
TRAIN_ARCH = "olmo-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 3
# the mesh phases, on a (1, 1) ("data", "model") mesh over a one-rank NCCL group
MESH_TRAIN_BATCH, MESH_TRAIN_STEPS, MESH_ACCUM = TRAIN_BATCH, 2, 2
MESH_LOSS_RTOL = 1e-4                                   # mesh vs no-mesh step loss
MESH_PARAM_RTOL, MESH_PARAM_ATOL = 5e-4, 1e-6           # tests/test_train.py:80
MESH_DEC_RTOL, MESH_DEC_ATOL = 2e-4, 2e-5               # tests/test_decode_attn.py:44
CKPT_PSIZE = 256 * 1024                     # BlobCheckpointer's default page
MOE_ARCH = "olmoe-1b-7b"                    # served: 4 x 512 keeps the dispatch O(T^2) small
MOE_CMP_LAYERS, MOE_CMP_BATCH, MOE_CMP_PROMPT, MOE_CMP_DECODE = 2, 2, 128, 8
MOE_CMP_TOL, MOE_TIE = 2e-3, 1e-6           # logits card vs CPU; a router near-tie
MOE_TRAIN_ARCH = "granite-moe-1b-a400m"
REMAT_LOSS_RTOL, REMAT_GNORM_RTOL = 1e-5, 1e-3
XLSTM_ARCH = "xlstm-350m"
XLSTM_TF_LAYERS, XLSTM_TF_PREFILL, XLSTM_TF_DECODE = 8, 500, 12
ENCDEC_ARCH = "seamless-m4t-large-v2"
# the repo's prefill_32k cell feeds 32768 encoder frames; one card holds a
# batch of 4 of them (12.9 GB of cross memories), not the cell's 32
ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_NEW = 4, 32768, 512, 32
ENCDEC_TF_LAYERS, ENCDEC_TF_FRAMES = 4, 8192   # teacher forcing: 4 + 4 layers, float32
# training stays at or under the blockwise threshold (4096 frames): the
# attention kernels have no backward on the card
ENCDEC_TRAIN_FRAMES = 2048
# the digest tests' sweep (tests/test_torch_digest.py): word-domain pages,
# byte cases (page bytes, total bytes) and leaves at 4096-byte pages
DIGEST_WORD_SHAPES = [(1, 512), (3, 512), (8, 1024), (17, 1536)]
DIGEST_BYTE_CASES = [(64 * 1024, 3 * 64 * 1024), (4096, 4096 * 2 + 100), (100, 700), (8, 8)]
DIGEST_LEAVES = [(torch.float32, 5000), (torch.bfloat16, 5000), (torch.int32, 5000),
                 (torch.bfloat16, 5001), (torch.float32, 37)]
FULL_LEAF = (16, 2048, 8192)                # olmo-1b's stacked w_up master, float32
MASK_ROWS, MASK_PLANTED = 63_000, 257
SCAN_SHAPES = [(2, 64, 32), (3, 100, 17), (1, 1, 8), (4, 257, 130)]  # tests/test_kernels.py
SCAN_LONG_T = 8192                          # the scan at a long prompt, timed too
SCAN_TOL = 1e-5                                                       # tests/test_kernels.py
TEACHER_TOL = 2e-2                                                    # tests/test_models.py
# flash attention: tests/test_kernels.py's cases (B, Hq, Hkv, Tq, Tk, D,
# causal, window, softcap, dtype) with q_offset = Tk - Tq when causal, plus
# the long path's head width and window, D = 256 MQA and strided k, v;
# every case also runs in bf16 (the tensor-core kernel)
FLASH_CASES = [
    (2, 4, 2, 64, 64, 32, True, None, None, torch.float32),
    (1, 8, 1, 37, 37, 16, True, None, None, torch.float32),
    (2, 2, 2, 50, 70, 8, False, None, None, torch.float32),
    (1, 4, 2, 96, 96, 64, True, 24, None, torch.float32),
    (1, 2, 1, 1, 40, 16, True, None, None, torch.float32),
    (1, 4, 4, 128, 128, 128, True, None, None, torch.float32),
    (1, 4, 2, 64, 64, 32, True, None, None, torch.bfloat16),
    (1, 2, 2, 32, 32, 16, True, None, 20.0, torch.float32),
    (1, 8, 2, 300, 1500, 120, True, 100, None, torch.float32),
    (2, 8, 1, 130, 300, 256, True, None, None, torch.float32),
    (1, 32, 8, 1, 5000, 120, True, 4096, None, torch.bfloat16),
    (1, 4, 2, 200, 4200, 120, True, 64, 30.0, torch.bfloat16),
]
# float32 only (the tensor-core kernel takes D in multiples of 8): the
# float32 kernel's tile edges, flash_attention.tiling's layouts and GQA
# stackings: Tq off the 32-row tile, D = 100 and 120 (128 columns) and 256
# (64 stacked rows, 32-key tiles), G = 1, 3 (a block with an empty head),
# 8 and 32, a window inside one key tile, D = 33 (4-byte copies)
FLASH_F32_CASES = [
    (2, 8, 2, 77, 77, 120, True, None, None),
    (2, 4, 2, 130, 200, 100, True, 64, None),
    (1, 2, 2, 70, 90, 256, False, None, None),
    (1, 4, 2, 100, 100, 256, True, 40, 25.0),
    (1, 8, 1, 45, 300, 120, True, None, None),
    (1, 6, 2, 50, 50, 64, True, None, 10.0),
    (1, 32, 1, 20, 100, 64, True, None, None),
    (1, 4, 1, 200, 200, 120, True, 5, None),
    (1, 4, 2, 40, 70, 33, True, None, None),
    (1, 4, 4, 129, 129, 120, False, 17, None),
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}              # tests/test_kernels.py
# Past a few thousand keys an output of random q, k, v is ~0.03, as small
# as the bf16 tolerance above, so bf16 outputs are also held element by
# element to one bf16 rounding of the plain version's value: both round
# float32 sums of the same products, so they may differ by one ulp
# (<= 2^-7 |want|).  The floor covers outputs near zero.
FLASH_BF16_REL, FLASH_BF16_FLOOR = 2.0 ** -7, 1e-4
# H100 SXM data sheet (``repro_torch.launch.hlo``, the cost model's constants):
# bf16 dense tensor-core rate (the least time of attention), HBM3 rate, and
# the float32 rate outside the tensor cores
BF16_FLOP_PER_S, HBM_BYTES_PER_S, F32_FLOP_PER_S = PEAK_FLOPS, HBM_BW, F32_FLOPS
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


def scan_shapes(cfg):
    """The serving path's scan shape and the same at a long prompt."""
    return (BATCH, PROMPT_LEN, cfg.rnn_width), (BATCH, SCAN_LONG_T, cfg.rnn_width)


def phase_scan_vs_plain(state):
    worst = 0.0
    for i, shape in enumerate(SCAN_SHAPES + list(scan_shapes(state["cfg"]))):
        a, x = scan_inputs(shape, seed=100 + i)
        got = linear_scan_cuda(a, x)
        want = ref_linear_scan(a, x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=SCAN_TOL, atol=SCAN_TOL)
        if not torch.equal(got, want):
            raise AssertionError(f"linear_scan {shape}: not bit-equal to the plain loop")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"  linear_scan {shape}: bit-equal, max abs err {err:.3e}")
    state["scan_err"] = worst
    log(f"kernel vs plain: linear_scan bit-equal and within rtol=atol={SCAN_TOL} "
        f"(worst {worst:.3e})")


def prompts_for(seed, batch=BATCH, length=PROMPT_LEN):
    tok = ByteTokenizer()
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batch):
        text = bytes(rng.integers(32, 127, length - 2).astype(np.uint8)).decode()
        out.append(tok.encode(text, add_special=True))
    return out


def attention_inputs(B, Hq, Hkv, Tq, Tk, D, dtype, seed, strided=False):
    """q (B, Hq, Tq, D); k, v (B, Hkv, Tk, D), as views of (B, Tk, Hkv, D)
    tensors when ``strided`` (the layout a projection einsum hands over)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Hq, Tq, D), generator=g, device="cuda").to(dtype)
    kv_shape = (B, Tk, Hkv, D) if strided else (B, Hkv, Tk, D)
    k = torch.randn(kv_shape, generator=g, device="cuda").to(dtype)
    v = torch.randn(kv_shape, generator=g, device="cuda").to(dtype)
    if strided:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    return q, k, v


def flash_kernel(dtype):
    """The attention kernel ``ops.flash_attention`` runs for ``dtype``."""
    return flash_attention_sm90_cuda if dtype == torch.bfloat16 else flash_attention_cuda


def flash_case(q, k, v, **kw):
    """``ops.flash_attention`` on the card (the dtype's kernel) against the
    plain version on the same inputs; returns the largest absolute
    difference and, for bf16, the largest share of the scaled limit
    ``FLASH_BF16_REL * |want| + FLASH_BF16_FLOOR`` (None for float32),
    raising past either limit."""
    got = ops.flash_attention(q, k, v, **kw)
    want = ref_flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype or not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention {tuple(q.shape)} {kw}: {got.shape} {got.dtype} "
                             f"vs {want.shape} {want.dtype}, finite {bool(torch.isfinite(got).all())}")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if not err <= FLASH_TOL[q.dtype]:
        raise AssertionError(f"flash_attention {tuple(q.shape)} {q.dtype} {kw}: max abs err "
                             f"{err:.3e} > {FLASH_TOL[q.dtype]}")
    if q.dtype != torch.bfloat16:
        return err, None
    share = float((diff / (FLASH_BF16_REL * want.float().abs() + FLASH_BF16_FLOOR)).max())
    if not share <= 1.0:
        raise AssertionError(f"flash_attention {tuple(q.shape)} bf16 {kw}: |got - want| reaches "
                             f"{share:.3f} x ({FLASH_BF16_REL:.3g} |want| + {FLASH_BF16_FLOOR})")
    return err, share


def long_shapes(cfg):
    """q and k/v shapes of one prefill attention on the long serving path."""
    return ((LONG_BATCH, cfg.n_heads, LONG_PROMPT, cfg.head_dim),
            (LONG_BATCH, cfg.n_kv_heads, LONG_PROMPT, cfg.head_dim))


def seamless_shapes(cfg, batch=ENCDEC_BATCH):
    """q and k/v shapes of the encoder-decoder's attention over 32768
    frames: the encoder's self-attention, the prefill's cross-attention
    and a decode step's."""
    kv = (batch, cfg.n_kv_heads, ENCDEC_FRAMES, cfg.head_dim)
    return {"encoder": ((batch, cfg.n_heads, ENCDEC_FRAMES, cfg.head_dim), kv),
            "cross prefill": ((batch, cfg.n_heads, ENCDEC_PROMPT, cfg.head_dim), kv),
            "cross decode": ((batch, cfg.n_heads, 1, cfg.head_dim), kv)}


def seamless_cases(cfg):
    """(name, q shape, k/v shape, strided) of the plain-version checks."""
    shapes = seamless_shapes(cfg)
    enc_q, enc_kv = seamless_shapes(cfg, batch=1)["encoder"]
    return [("encoder", enc_q, enc_kv, True),
            ("cross prefill", *shapes["cross prefill"], False),
            ("cross decode", *shapes["cross decode"], False)]


def phase_flash_vs_plain(state):
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_share, n = 0.0, 0
    for i, (B, Hq, Hkv, Tq, Tk, D, causal, window, softcap, dtype) in enumerate(FLASH_CASES):
        for dt in (dtype,) if dtype == torch.bfloat16 else (dtype, torch.bfloat16):
            for strided in (False, True):
                q, k, v = attention_inputs(B, Hq, Hkv, Tq, Tk, D, dt, seed=200 + i,
                                           strided=strided)
                kw = dict(causal=causal, window=window, softcap=softcap,
                          q_offset=Tk - Tq if causal else 0)
                err, share = flash_case(q, k, v, **kw)
                worst[dt], n = max(worst[dt], err), n + 1
                worst_share = max(worst_share, share or 0.0)
                log(f"  {flash_kernel(dt).__name__} {tuple(q.shape)} kv {tuple(k.shape)} {dt} "
                    f"{kw} strided={strided}: max abs err {err:.3e}, bf16 limit share {share}")
    for i, (B, Hq, Hkv, Tq, Tk, D, causal, window, softcap) in enumerate(FLASH_F32_CASES):
        for strided in (False, True):
            q, k, v = attention_inputs(B, Hq, Hkv, Tq, Tk, D, torch.float32, seed=260 + i,
                                       strided=strided)
            kw = dict(causal=causal, window=window, softcap=softcap,
                      q_offset=Tk - Tq if causal else 0)
            err, _ = flash_case(q, k, v, **kw)
            worst[torch.float32], n = max(worst[torch.float32], err), n + 1
            log(f"  flash_attention_cuda {tuple(q.shape)} kv {tuple(k.shape)} float32 {kw} "
                f"strided={strided}: max abs err {err:.3e}")
    # rows before the first key (q_offset < 0) see nothing: zeros, not NaN
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = attention_inputs(1, 4, 2, 100, 100, 120, dt, seed=250)
        got = ops.flash_attention(q, k, v, causal=True, q_offset=-40)
        err, share = flash_case(q, k, v, causal=True, q_offset=-40)
        worst[dt], n = max(worst[dt], err), n + 1
        worst_share = max(worst_share, share or 0.0)
        if not torch.equal(got[:, :, :40], torch.zeros_like(got[:, :, :40])):
            raise AssertionError(f"{dt}: fully masked rows are not zero")
    # the long serving path's shape, in the layout the model hands over
    # (v a strided view of the projection) and contiguous; in float32 too,
    # where 2e-5 holds every row's sums at ~1e-3 of a typical output
    cfg = get_config(LONG_ARCH)
    qs, ks = long_shapes(cfg)
    for dtype in (torch.bfloat16, torch.float32):
        for strided in (True, False):
            q, k, v = attention_inputs(qs[0], qs[1], ks[1], qs[2], ks[2], qs[3], dtype,
                                       seed=251, strided=strided)
            err, share = flash_case(q, k, v, causal=True, window=cfg.window)
            worst[dtype], n = max(worst[dtype], err), n + 1
            worst_share = max(worst_share, share or 0.0)
            log(f"  {flash_kernel(dtype).__name__} {qs} kv {ks} {dtype} window {cfg.window} "
                f"strided={strided}: max abs err {err:.3e}, bf16 limit share {share}")
            del q, k, v
            torch.cuda.empty_cache()
    # the encoder-decoder's three new uses, unmasked: the encoder's
    # bidirectional self-attention (batch 1, so that the plain version's
    # float32 score slices stay at 2 GB; v a strided view as the model
    # hands it over), the prefill's cross-attention and a decode step's
    # one-query cross-attention over contiguous memories
    for name, qs, ks, strided in seamless_cases(get_config(ENCDEC_ARCH)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = attention_inputs(qs[0], qs[1], ks[1], qs[2], ks[2], qs[3], dtype,
                                       seed=252, strided=strided)
            err, share = flash_case(q, k, v, causal=False)
            worst[dtype], n = max(worst[dtype], err), n + 1
            worst_share = max(worst_share, share or 0.0)
            log(f"  {flash_kernel(dtype).__name__} seamless {name} {qs} kv {ks} {dtype} "
                f"non-causal strided={strided}: max abs err {err:.3e}, bf16 limit share {share}")
            del q, k, v
            torch.cuda.empty_cache()
    state["flash_err"] = worst
    state["flash_bf16_share"] = worst_share
    log(f"kernel vs plain: attention in {n} cases, flash_attention (float32) worst "
        f"{worst[torch.float32]:.3e} (tol {FLASH_TOL[torch.float32]}), "
        f"flash_attention_sm90 (bf16) worst "
        f"{worst[torch.bfloat16]:.3e} (tol {FLASH_TOL[torch.bfloat16]}) and "
        f"{worst_share:.3f} of {FLASH_BF16_REL:.3g} |want| + {FLASH_BF16_FLOOR}")


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


def phase_serve_long(state):
    cfg = get_config(LONG_ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(3))
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"long serve: {cfg.name} {cfg.n_layers} layers ({cfg.block_pattern[0]}, window "
        f"{cfg.window}), d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B params")
    prompts = prompts_for(seed=4, batch=LONG_BATCH, length=LONG_PROMPT)
    max_len = LONG_PROMPT + LONG_NEW

    # -- the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = generate(model, params, prompts, max_new=LONG_NEW, max_len=max_len, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    state["long_launches"] = counts
    log(f"  generate: {LONG_BATCH}x{LONG_PROMPT} prompt + {LONG_NEW} new tokens in {wall:.3f} s "
        f"(first call); launches {counts}")
    if counts["flash_attention_sm90"] != cfg.n_layers or counts["flash_attention"] != 0:
        raise AssertionError(f"flash_attention_sm90 launched {counts['flash_attention_sm90']} "
                             f"times and flash_attention {counts['flash_attention']}, expected "
                             f"{cfg.n_layers} and 0 (bf16: one tensor-core launch per layer, "
                             f"in the prefill)")
    for p, o in zip(prompts, outs):
        if o.shape != (LONG_PROMPT + LONG_NEW,) or not np.array_equal(o[:LONG_PROMPT], p):
            raise AssertionError(f"bad output shape {o.shape} or prompt not preserved")
        if not ((o >= 0) & (o < cfg.vocab_size)).all():
            raise AssertionError("token outside the vocabulary")

    # -- timings through the same entry points, warm
    tokens = torch.as_tensor(np.stack(prompts).astype(np.int64), device="cuda")
    with torch.inference_mode():
        prefill_ms = []
        for _ in range(3):
            cache = model.init_cache(LONG_BATCH, max_len, device="cuda")
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, {"tokens": tokens}, cache)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
            c = ops.launch_counts()
            if c["flash_attention_sm90"] != cfg.n_layers or c["flash_attention"] != 0:
                raise AssertionError(f"prefill launched {c}")
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite prefill logits")
        tok = torch.argmax(logits, dim=-1)
        finite = torch.ones((), dtype=torch.bool, device="cuda")
        # the mesh serve phase is teacher-forced on these tokens and held to these logits
        ref = state["long_ref"] = {"logits": [logits], "fed": []}
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(LONG_NEW):   # no host sync inside the loop, as in generate
            ref["fed"].append(tok)
            logits, cache = model.decode_step(params, tok, LONG_PROMPT + i, cache)
            ref["logits"].append(logits)
            finite &= torch.isfinite(logits).all()
            tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        if not bool(finite):
            raise AssertionError("non-finite decode logits")
        c = ops.launch_counts()
        if c["flash_attention"] != 0 or c["flash_attention_sm90"] != 0:
            raise AssertionError("a decode step over the window cache launched a kernel")
    state["serve_long"] = {
        "prefill_ms": sorted(prefill_ms)[1],
        "decode_tok_s": LONG_BATCH * LONG_NEW / decode_s,
        "decode_ms_per_step": decode_s * 1e3 / LONG_NEW,
        "peak_gib": peak / 2**30,
        "generate_first_call_s": wall,
    }
    r = state["serve_long"]
    log(f"  prefill {LONG_BATCH}x{LONG_PROMPT}: {r['prefill_ms']:.2f} ms (median of 3: "
        f"{', '.join(f'{m:.2f}' for m in prefill_ms)}); decode {r['decode_tok_s']:.1f} tok/s "
        f"({r['decode_ms_per_step']:.2f} ms/step, batch {LONG_BATCH}, window cache "
        f"{cfg.window}); peak memory {r['peak_gib']:.2f} GiB; on {state['smi']}")
    del params, model, cache, logits
    torch.cuda.empty_cache()


def phase_teacher_forcing_long(state):
    cfg = dataclasses.replace(get_config(LONG_ARCH), n_layers=4, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(5))
    B, T, T0 = 2, LONG_PROMPT, LONG_TF_PREFILL
    g = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g, device="cuda")
    with torch.inference_mode():
        ops.reset_launch_counts()
        x = params["embed"]["table"][toks]
        h = LM.apply_stack_train(params, cfg, x, torch.arange(T, device="cuda"))[0]
        full = LM._logits(params, cfg, h[:, T0 - 1:])      # positions T0-1 .. T-1
        del x, h
        fwd = ops.launch_counts()["flash_attention"]
        cache = model.init_cache(B, T + 4, device="cuda")
        ops.reset_launch_counts()
        lg, cache = model.prefill(params, {"tokens": toks[:, :T0]}, cache)
        pre = ops.launch_counts()["flash_attention"]
        errs = [float((lg - full[:, 0]).abs().max())]
        for t in range(T0, T):
            lg, cache = model.decode_step(params, toks[:, t], t, cache)
            errs.append(float((lg - full[:, t - T0 + 1]).abs().max()))
        dec = ops.launch_counts()["flash_attention"] - pre
        sm90 = ops.launch_counts()["flash_attention_sm90"]
    state["teacher_long_err"] = max(errs)
    state["long_tf_launches"] = fwd + pre
    log(f"long teacher forcing: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"float32, prefill {T0} + {T - T0} decode steps vs one forward over {T}: max "
        f"|dlogit| {max(errs):.3e} (tol {TEACHER_TOL}); flash_attention launches: forward "
        f"{fwd}, prefill {pre}, decode {dec}")
    if (fwd, pre, dec, sm90) != (cfg.n_layers, cfg.n_layers, 0, 0):
        raise AssertionError(f"expected {cfg.n_layers} float32 launches in the forward and "
                             f"the prefill, none in decode and no bf16 kernel, got {fwd}, "
                             f"{pre}, {dec}, {sm90}")
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
    if got.dtype != torch.bool or got.shape != (MASK_ROWS,):
        raise AssertionError(f"delta_mask: {got.dtype} {tuple(got.shape)}, expected bool "
                             f"({MASK_ROWS},)")
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
    client, reader = corpus_reader(TRAIN_BATCH, TRAIN_SEQ)
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
        batch_bytes = sum(t.numel() * t.element_size() for t in batch.values())
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
        "arg_bytes": state_bytes + batch_bytes,
        "state_digest_bound_ms": padded / HBM_BYTES_PER_S * 1e3,
    }
    t = state["train"]
    log(f"  step {TRAIN_BATCH}x{TRAIN_SEQ}: {', '.join(f'{m:.1f}' for m in step_ms)} ms; "
        f"save {save_s:.2f} s, restore {restore_s:.2f} s, unchanged save {save2_s:.2f} s; "
        f"peak device memory {t['peak_gib']:.2f} GiB (steps {t['step_peak_gib']:.2f}); "
        f"host peak RSS {t['host_rss_gib']:.1f} GiB; whole-state page_digest "
        f"{scan_ms:.3f} ms vs bound {t['state_digest_bound_ms']:.3f} ms; on {state['smi']}")
    log("  free -g:\n" + free.rstrip())
    del train_state, leaves, data, ckpt, client
    torch.cuda.empty_cache()


def live_pairs(Tq, Tk, *, causal, window, q_offset) -> int:
    """(query, key) pairs that the masks leave live, for one (batch, head)."""
    qpos = q_offset + np.arange(Tq, dtype=np.int64)
    hi = np.minimum(qpos, Tk - 1) if causal else np.full(Tq, Tk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window is not None else np.zeros(Tq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def sdpa_ms(q, k, v, window) -> float:
    """Device ms of ``scaled_dot_product_attention`` on the same inputs
    with the window-causal boolean mask, on its memory-efficient backend
    (the math backend would hold every score), the kv heads repeated to
    the query heads outside the timing (that backend takes no
    ``enable_gqa``).  The yardstick only: the port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    Tq, Tk = q.shape[2], k.shape[2]
    qpos = torch.arange(Tq, device="cuda")[:, None]
    kpos = torch.arange(Tk, device="cuda")[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    group = q.shape[1] // k.shape[1]
    ke, ve = k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, ke, ve, attn_mask=mask), reps=5)


def seamless_times():
    """``flash_attention_sm90`` at the encoder-decoder's three shapes over
    32768 frames (bf16, no mask): its error against the plain version, its
    time, the plain version's, the bound, and ``scaled_dot_product_attention``
    with no mask (which lets PyTorch pick its flash backend)."""
    out = {}
    for i, (name, (qs, ks)) in enumerate(seamless_shapes(get_config(ENCDEC_ARCH)).items()):
        B, Hq, Tq, D = qs
        q, k, v = attention_inputs(B, Hq, ks[1], Tq, ks[2], D, torch.bfloat16, seed=30 + i)
        err, share = flash_case(q, k, v, causal=False)
        pairs = live_pairs(Tq, ks[2], causal=False, window=None, q_offset=0) * B * Hq
        ops_s = 4 * D * pairs / BF16_FLOP_PER_S
        bytes_s = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() / HBM_BYTES_PER_S
        out[name] = {
            "shape": [list(qs), list(ks)],
            "max_abs_err": err,
            "bf16_limit_share": share,
            "ms": cuda_ms(lambda: flash_attention_sm90_cuda(q, k, v, causal=False),
                          reps=3 if Tq > ENCDEC_PROMPT else 20),
            "plain_ms": cuda_ms(lambda: ref_flash_attention(q, k, v, causal=False),
                                reps=1 if Tq > ENCDEC_PROMPT else 5),
            "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v), reps=3 if Tq > ENCDEC_PROMPT else 20),
        }
        del q, k, v
        torch.cuda.empty_cache()
    return out


def scan_times(shape, seed, plain_reps):
    """linear_scan at ``shape``: error, kernel ms, plain ms and the bound
    (12 B an element over the memory rate, or 2 flops over the float32
    rate, whichever is larger)."""
    a, x = scan_inputs(shape, seed=seed)
    err = float((linear_scan_cuda(a, x) - ref_linear_scan(a, x)).abs().max())
    n = a.numel()
    bytes_bound, ops_bound = 12 * n / HBM_BYTES_PER_S, 2 * n / F32_FLOP_PER_S
    return {"err": err, "ms": cuda_ms(lambda: linear_scan_cuda(a, x), reps=200),
            "plain_ms": cuda_ms(lambda: ref_linear_scan(a, x), reps=plain_reps),
            "bound_ms": max(bytes_bound, ops_bound) * 1e3,
            "bound_by": "bytes" if bytes_bound >= ops_bound else "operations"}


def phase_kernel_times(state):
    path, long = scan_shapes(state["cfg"])
    t, t_long = scan_times(path, seed=7, plain_reps=5), scan_times(long, seed=10, plain_reps=1)
    kernels = [{
        "name": "linear_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
        "replaces": "src/repro/kernels/linear_scan.py:48",
        "launches": state["launches"]["linear_scan"],
        "max_abs_err": max(t["err"], t_long["err"], state["scan_err"]),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,   # no single PyTorch call computes a linear recurrence
        "shape": list(path),
        "dtype": "float32",
        "bound_basis": f"12 B/element over {HBM_BYTES_PER_S:.3g} B/s (H100 SXM HBM3)",
        "long_shape": list(long),
        "long_ms": t_long["ms"],
        "long_plain_ms": t_long["plain_ms"],
        "long_bound_ms": t_long["bound_ms"],
    }]

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
        "launches": state["train_launches"]["page_digest"]
        + state["mesh_train_launches"]["page_digest"]
        + state["examples_launches"]["page_digest"],
        "launches_by_path": {f"{TRAIN_ARCH} train": state["train_launches"]["page_digest"],
                             f"{TRAIN_ARCH} mesh train":
                                 state["mesh_train_launches"]["page_digest"],
                             "examples": state["examples_launches"]["page_digest"]},
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
    dm_bytes = n_pages * (8 + 8 + 1)   # two digest rows read, one bool written
    dm_ops = n_pages * 3          # two compares and an or per row
    kernels.append({
        "name": "delta_mask",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_mask.cu",
        "replaces": "src/repro/kernels/delta_mask.py:29",
        "launches": state["train_launches"]["delta_mask"]
        + state["mesh_train_launches"]["delta_mask"]
        + state["examples_launches"]["delta_mask"],
        "launches_by_path": {f"{TRAIN_ARCH} train": state["train_launches"]["delta_mask"],
                             f"{TRAIN_ARCH} mesh train":
                                 state["mesh_train_launches"]["delta_mask"],
                             "examples": state["examples_launches"]["delta_mask"]},
        "max_abs_err": max(state["mask_err"], err),
        "ms": cuda_ms(lambda: delta_mask_cuda(new, old), reps=200),
        "plain_ms": cuda_ms(lambda: ref_delta_mask(new, old), reps=200),
        "bound_ms": max(dm_bytes / HBM_BYTES_PER_S, dm_ops / CUDA_CORE_OP_PER_S) * 1e3,
        "bound_by": "bytes" if dm_bytes / HBM_BYTES_PER_S >= dm_ops / CUDA_CORE_OP_PER_S
        else "operations",
        "library_ms": cuda_ms(lambda: (new != old).any(dim=1), reps=200),
        "shape": [n_pages, 2],
        "dtype": "int32",
        "bound_basis": f"17 B/row over {HBM_BYTES_PER_S:.3g} B/s (H100 SXM HBM3)",
    })
    del new, old

    # attention at one prefill attention of the long serving path: the bf16
    # tensor-core kernel (the bf16 model's path) and the float32 kernel (the
    # float32 long teacher forcing's path), each against SDPA in its dtype
    cfg = get_config(LONG_ARCH)
    qs, ks = long_shapes(cfg)
    B, Hq, Tq, D = qs
    kw = dict(causal=True, window=cfg.window)
    pairs = live_pairs(Tq, ks[2], causal=True, window=cfg.window, q_offset=0) * B * Hq
    fa_ops = 4 * D * pairs              # score dot and value multiply-add per live pair
    by_path = {
        "flash_attention_sm90": {
            f"{LONG_ARCH} serve": state["long_launches"]["flash_attention_sm90"],
            f"{ENCDEC_ARCH} serve": state["encdec_launches"]["flash_attention_sm90"],
            f"{LONG_ARCH} mesh serve": state["mesh_serve_launches"]},
        "flash_attention": {
            f"{LONG_ARCH} teacher forcing": state["long_tf_launches"],
            f"{ENCDEC_ARCH} teacher forcing": state["encdec_tf_launches"],
            f"{LONG_ARCH} float32 mesh serve": state["mesh_serve_f32_launches"]},
    }
    for name, dtype, rate, rate_name in (
            ("flash_attention_sm90", torch.bfloat16, BF16_FLOP_PER_S, "bf16 tensor cores"),
            ("flash_attention", torch.float32, F32_FLOP_PER_S, "float32 outside the tensor cores")):
        q, k, v = attention_inputs(qs[0], qs[1], ks[1], qs[2], ks[2], qs[3], dtype, seed=12)
        err, share = flash_case(q, k, v, **kw)
        kernel = flash_kernel(dtype)
        fa_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        row = {
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": "src/repro/kernels/flash_attention.py:105",
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": max(err, state["flash_err"][dtype]),
            "ms": cuda_ms(lambda: kernel(q, k, v, **kw), reps=10 if share is not None else 5),
            "plain_ms": cuda_ms(lambda: ref_flash_attention(q, k, v, **kw), reps=2),
            "bound_ms": max(fa_bytes / HBM_BYTES_PER_S, fa_ops / rate) * 1e3,
            "bound_by": "bytes" if fa_bytes / HBM_BYTES_PER_S >= fa_ops / rate else "operations",
            "library_ms": sdpa_ms(q, k, v, cfg.window),
            "library_call": "scaled_dot_product_attention, efficient backend, boolean mask, "
                            "kv heads repeated outside the timing",
            "shape": [list(qs), list(ks)],
            "dtype": str(dtype).replace("torch.", ""),
            "window": cfg.window,
            "bound_basis": f"4*D flop per live (q, k) pair ({pairs} pairs) over {rate:.3g} "
                           f"flop/s (H100 SXM {rate_name}); q, k, v read and o written once "
                           f"over {HBM_BYTES_PER_S:.3g} B/s (H100 SXM HBM3)",
        }
        if share is not None:
            row["bf16_limit_share"] = max(share, state["flash_bf16_share"])
        kernels.append(row)
        del q, k, v
        torch.cuda.empty_cache()
        if name == "flash_attention_sm90":
            row["seamless"] = seamless_times()
    state["kernels"] = kernels
    for k in kernels:
        log(f"{k['name']} {k['shape']} {k['dtype']}: kernel {k['ms']:.4f} ms, plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']}, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_ms'] / k['ms']:.1%} of roofline), {k['launches']} launches on the "
            f"path, on {state['smi']}")
    for shape_name, t in next(k for k in kernels if "seamless" in k)["seamless"].items():
        log(f"flash_attention_sm90 seamless {shape_name} {t['shape']} bfloat16 non-causal: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library (SDPA, no mask) "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{t['bound_ms'] / t['ms']:.1%} of roofline), max abs err {t['max_abs_err']:.3e}, "
            f"on {state['smi']}")
    k = kernels[0]
    log(f"linear_scan {k['long_shape']} float32: kernel {k['long_ms']:.4f} ms, plain "
        f"{k['long_plain_ms']:.4f} ms, bound {k['long_bound_ms']:.4f} ms "
        f"({k['long_bound_ms'] / k['long_ms']:.1%} of roofline), on {state['smi']}")


# ------------------------------------------------------------ the mesh paths


def phase_mesh_group(state):
    """A one-rank NCCL group and a (1, 1) ("data", "model") mesh on it."""
    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, device_id=torch.device("cuda", 0))
    state["mesh"] = make_mesh((1, 1), ("data", "model"), device="cuda")
    log(f"mesh: {state['mesh']} over a one-rank NCCL group")


def phase_mesh_train(state):
    """Full-width olmo-1b under ``tp_fsdp`` + ``zero2`` with ``accum=2``:
    two steps from the state and batches of a no-mesh ``accum=2`` run,
    then a full and an incremental checkpoint of the mesh state and a
    restore into its placements."""
    cfg = get_config(TRAIN_ARCH)
    client, reader = corpus_reader(MESH_TRAIN_BATCH, TRAIN_SEQ)
    batches = [dict(zip(("tokens", "labels"), (torch.as_tensor(a, device="cuda")
                                               for a in reader.next_batch())))
               for _ in range(MESH_TRAIN_STEPS)]
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100)

    def run(builder):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        train_state = builder.init_state(torch.Generator(device="cuda").manual_seed(0))
        step_fn, losses, ms = builder.train_step_fn(), [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_state, metrics = step_fn(train_state, batch)
            losses.append(float(metrics["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        return train_state, losses, ms, torch.cuda.max_memory_allocated() / 2**30

    plain = TrainStepBuilder(build_model(cfg), opt=opt, accum=MESH_ACCUM)
    ref_state, ref_losses, ref_ms, ref_peak = run(plain)
    ref_params = [t.clone() for t in tree_leaves(ref_state["params"])]
    del ref_state
    torch.cuda.empty_cache()

    builder = TrainStepBuilder(build_model(cfg), state["mesh"], strategy="tp_fsdp",
                               opt=opt, accum=MESH_ACCUM, zero2=True)
    # -- the main path: counts at 0 just before, read just after
    ops.reset_launch_counts()
    train_state, losses, ms, peak = run(builder)
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the mesh train steps launched {counts}: olmo-1b at 2048 "
                             f"tokens has dense attention")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    p_abs, p_rel = 0.0, 0.0
    for a, b in zip(tree_leaves(train_state["params"]), ref_params):
        d = (whole(a).float() - b.float()).abs()
        p_abs = max(p_abs, float(d.max()))
        p_rel = max(p_rel, float((d / (b.float().abs() + 1e-6)).max()))
        torch.testing.assert_close(whole(a), b, rtol=MESH_PARAM_RTOL, atol=MESH_PARAM_ATOL)
    del ref_params
    if not loss_rel <= MESH_LOSS_RTOL:
        raise AssertionError(f"mesh losses {losses} vs no-mesh {ref_losses}")
    log(f"mesh train: {cfg.name} tp_fsdp + zero2, accum {MESH_ACCUM}, "
        f"{MESH_TRAIN_BATCH}x{TRAIN_SEQ}: losses {losses} vs no-mesh {ref_losses} (max rel "
        f"{loss_rel:.3e}); params max |d| {p_abs:.3e}, max rel {p_rel:.3e} (rtol "
        f"{MESH_PARAM_RTOL}); step ms mesh {', '.join(f'{m:.1f}' for m in ms)} vs no-mesh "
        f"{', '.join(f'{m:.1f}' for m in ref_ms)}; peak {peak:.2f} vs {ref_peak:.2f} GiB; "
        f"on {state['smi']}")

    # -- checkpoints of the mesh state: digests and masks on the gathered leaves
    n_leaves = len(flatten_with_paths(train_state))
    ckpt = BlobCheckpointer(client, psize=CKPT_PSIZE)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    st1 = ckpt.save(train_state, step=MESH_TRAIN_STEPS, extra={"reader": reader.state_dict()})
    save_s = time.perf_counter() - t0
    full_counts = ops.launch_counts()
    if (full_counts["page_digest"], full_counts["delta_mask"]) != (n_leaves, 0) or \
            st1.pages_written != st1.pages_total:
        raise AssertionError(f"full mesh save: {full_counts}, {st1.pages_written}/"
                             f"{st1.pages_total} pages")
    t0 = time.perf_counter()
    restored = builder.distribute_state(ckpt.restore(builder.abstract_state(), device="cuda"))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got, want = flatten_with_paths(restored), flatten_with_paths(train_state)
    if [k for k, _ in got] != [k for k, _ in want]:
        raise AssertionError("restored mesh tree differs")
    for (k, a), (_, b) in zip(got, want):
        if getattr(a, "placements", None) != getattr(b, "placements", None) or \
                not torch.equal(ops.leaf_bytes(whole(a)), ops.leaf_bytes(whole(b))):
            raise AssertionError(f"restored mesh leaf {k} differs")
    del restored, got
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    st2 = ckpt.save(train_state, step=MESH_TRAIN_STEPS,
                    extra={"reader": reader.state_dict(), "note": "extra moved"})
    save2_s = time.perf_counter() - t0
    inc_counts = ops.launch_counts()
    if (inc_counts["page_digest"], inc_counts["delta_mask"]) != (n_leaves, n_leaves) or \
            st2.pages_written != 0:
        raise AssertionError(f"incremental mesh save: {inc_counts}, {st2.pages_written} pages")
    state["mesh_train_launches"] = {k: full_counts[k] + inc_counts[k] for k in full_counts}
    log(f"  mesh checkpoint: full save {st1.pages_written}/{st1.pages_total} pages in "
        f"{save_s:.2f} s ({full_counts['page_digest']} page_digest), restore into the "
        f"mesh placements byte-equal in {restore_s:.2f} s, unchanged save "
        f"{st2.pages_written} pages in {save2_s:.2f} s ({inc_counts['page_digest']} "
        f"page_digest, {inc_counts['delta_mask']} delta_mask); host peak RSS "
        f"{host_rss_gib():.1f} GiB")
    state["mesh_train"] = {"losses": losses, "ref_losses": ref_losses, "loss_rel": loss_rel,
                           "param_abs": p_abs, "param_rel": p_rel, "step_ms": ms,
                           "ref_step_ms": ref_ms, "peak_gib": peak, "ref_peak_gib": ref_peak,
                           "save_s": save_s, "restore_s": restore_s, "save2_s": save2_s}
    # the gradients of the last batch at the trained state, for the collective
    state["mesh_grads"] = builder.grads_fn()(train_state, batches[-1])[1]
    del ckpt, client, reader, train_state
    torch.cuda.empty_cache()


def phase_mesh_collective(state):
    """``compressed_grad_mean`` over the "data" axis's NCCL group on the
    mesh train step's gradients, each leaf within one step of the int8
    grid (scale / 127)."""
    mesh, grads = state["mesh"], state.pop("mesh_grads")
    gen = torch.Generator(device="cuda").manual_seed(11)
    compressed_grad_mean(grads, mesh, "data", gen)          # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = compressed_grad_mean(grads, mesh, "data", gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    worst = 0.0
    for i, (a, g) in enumerate(zip(out, grads)):
        a, g = whole(a).float(), whole(g).float()
        scale = float(g.abs().max()) + 1e-12
        err = float((a - g).abs().max())
        worst = max(worst, err / scale * 127)
        if not err <= scale / 127 * (1 + 1e-6):
            raise AssertionError(f"gradient leaf {i}: |out - g| {err} > scale/127 {scale / 127}")
    n = sum(whole(g).numel() for g in grads)
    state["mesh_collective"] = {"ms": ms, "leaves": len(grads), "elements": n,
                                "worst_in_steps": worst}
    log(f"mesh collective: compressed_grad_mean over NCCL, {len(grads)} gradient leaves "
        f"({n / 1e9:.3f} B elements) in {ms:.2f} ms; worst |out - g| {worst:.3f} int8 steps "
        f"(limit 1); on {state['smi']}")
    del grads, out
    torch.cuda.empty_cache()


def mesh_decode(builder, model, params, tokens, fed, max_len):
    """A ``tp_serve_sm`` prefill of ``tokens`` and teacher-forced decode
    steps on ``fed``: (logits of each, prefill ms, decode ms a step,
    prefill launches)."""
    B, T = tokens.shape
    prefill, decode = builder.prefill_step_fn(), builder.decode_step_fn()
    cache = builder.shard_cache(model.init_cache(B, max_len, device="cuda"))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens}, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre = ops.launch_counts()
    outs = [logits]
    t0 = time.perf_counter()
    for i, tok in enumerate(fed):
        logits, cache = decode(params, tok, T + i, cache)
        outs.append(logits)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / max(len(fed), 1)
    dec = ops.launch_counts()
    if any(dec[k] != pre[k] for k in dec):
        raise AssertionError(f"a sharded decode step launched a kernel: {pre} -> {dec}")
    del cache
    return outs, prefill_ms, step_ms, pre


def phase_mesh_serve(state):
    """Full-width h2o-danube3-4b under ``tp_serve_sm``: the long-serve
    phase's prompts and tokens, its logits the reference; then the
    4-layer float32 copy against its own no-mesh run."""
    cfg = get_config(LONG_ARCH)
    model = build_model(cfg)
    builder = TrainStepBuilder(model, state["mesh"], strategy="tp_serve_sm")
    params = model.init(torch.Generator(device="cuda").manual_seed(3))   # the long phase's
    params = builder.distribute(params, builder.param_shardings(params), src_data_rank=None)
    tokens = torch.as_tensor(np.stack(prompts_for(seed=4, batch=LONG_BATCH,
                                                  length=LONG_PROMPT)).astype(np.int64),
                             device="cuda")
    ref = state.pop("long_ref")
    torch.cuda.reset_peak_memory_stats()
    # -- the main path: counts at 0 just before (in mesh_decode), read just after
    outs, prefill_ms, step_ms, pre = mesh_decode(builder, model, params, tokens, ref["fed"],
                                                 LONG_PROMPT + LONG_NEW)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if pre["flash_attention_sm90"] != cfg.n_layers or pre["flash_attention"] != 0:
        raise AssertionError(f"the mesh prefill launched {pre}, expected {cfg.n_layers} "
                             f"flash_attention_sm90")
    dlogit = max(float((a.float() - b.float()).abs().max()) for a, b in zip(outs, ref["logits"]))
    same = float(torch.stack([(a.argmax(-1) == b.argmax(-1)).float().mean()
                              for a, b in zip(outs, ref["logits"])]).mean())
    if not all(bool(torch.isfinite(a).all()) for a in outs):
        raise AssertionError("non-finite mesh logits")
    prefill_times = [prefill_ms] + [mesh_decode(builder, model, params, tokens, [],
                                                LONG_PROMPT + LONG_NEW)[1] for _ in range(2)]
    state["mesh_serve"] = {"prefill_ms": sorted(prefill_times)[1], "prefill_runs_ms":
                           prefill_times, "decode_ms_per_step": step_ms,
                           "max_dlogit": dlogit, "greedy_same": same, "peak_gib": peak,
                           "no_mesh_prefill_ms": state["serve_long"]["prefill_ms"],
                           "no_mesh_decode_ms_per_step":
                               state["serve_long"]["decode_ms_per_step"]}
    state["mesh_serve_launches"] = pre["flash_attention_sm90"]
    r = state["mesh_serve"]
    log(f"mesh serve: {cfg.name} tp_serve_sm, {LONG_BATCH}x{LONG_PROMPT} prefill "
        f"{r['prefill_ms']:.2f} ms (median of 3: {', '.join(f'{m:.2f}' for m in prefill_times)}; "
        f"no mesh {r['no_mesh_prefill_ms']:.2f}), {pre['flash_attention_sm90']} "
        f"flash_attention_sm90 launches; {LONG_NEW} teacher-forced decode steps through "
        f"sharded_decode_attention {step_ms:.2f} ms/step (no mesh "
        f"{r['no_mesh_decode_ms_per_step']:.2f}); max |dlogit| vs no mesh {dlogit:.3e}, "
        f"greedy tokens equal {same:.4f}; peak {peak:.2f} GiB; on {state['smi']}")
    del params, outs, ref
    torch.cuda.empty_cache()

    # -- the float32 copy: mesh and no mesh on the same parameters and tokens
    cfg = dataclasses.replace(get_config(LONG_ARCH), n_layers=4, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(5))
    B, T0 = 2, LONG_TF_PREFILL
    g = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (B, LONG_PROMPT), generator=g, device="cuda")
    fed = [toks[:, t] for t in range(T0, LONG_PROMPT)]
    plain = TrainStepBuilder(model)
    want, _, _, pre_plain = mesh_decode(plain, model, params, toks[:, :T0], fed, LONG_PROMPT + 4)
    builder = TrainStepBuilder(model, state["mesh"], strategy="tp_serve_sm")
    dparams = builder.distribute(params, builder.param_shardings(params), src_data_rank=None)
    got, _, _, pre = mesh_decode(builder, model, dparams, toks[:, :T0], fed, LONG_PROMPT + 4)
    if (pre["flash_attention"], pre_plain["flash_attention"], pre["flash_attention_sm90"]) != \
            (cfg.n_layers, cfg.n_layers, 0):
        raise AssertionError(f"float32 prefills launched {pre_plain} and {pre}")
    f32_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    for i, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, rtol=MESH_DEC_RTOL, atol=MESH_DEC_ATOL,
                                   msg=lambda m, i=i: f"float32 mesh step {i}: {m}")
    state["mesh_serve"]["f32_max_dlogit"] = f32_err
    state["mesh_serve_f32_launches"] = pre["flash_attention"]
    log(f"  float32 copy ({cfg.n_layers} layers, {B}x{T0} + {len(fed)} steps): mesh vs no "
        f"mesh max |dlogit| {f32_err:.3e} (rtol {MESH_DEC_RTOL}, atol {MESH_DEC_ATOL}); "
        f"flash_attention launches {pre_plain['flash_attention']} + {pre['flash_attention']}")
    del params, dparams, got, want
    torch.cuda.empty_cache()


# ------------------------------------------------- the modules without kernels


def no_launches(counts, what):
    if any(counts.values()):
        raise AssertionError(f"{what} launched kernels: {counts}")


def serve_and_time(state, model, params, prompts, max_new, what):
    """``generate`` once with the launch counts at 0 just before and read
    just after (none may launch), then the prefill three times (median)
    and ``max_new`` decode steps, warm, through the same entry points."""
    cfg = model.cfg
    B, T0 = len(prompts), len(prompts[0])
    max_len = T0 + max_new
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = generate(model, params, prompts, max_new=max_new, max_len=max_len, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    no_launches(ops.launch_counts(), f"{what}: generate")
    peak = torch.cuda.max_memory_allocated()
    for p, o in zip(prompts, outs):
        if o.shape != (max_len,) or not np.array_equal(o[:T0], p):
            raise AssertionError(f"bad output shape {o.shape} or prompt not preserved")
        if not ((o >= 0) & (o < cfg.vocab_size)).all():
            raise AssertionError("token outside the vocabulary")
    tokens = torch.as_tensor(np.stack(prompts).astype(np.int64), device="cuda")
    with torch.inference_mode():
        prefill_ms = []
        for _ in range(3):
            cache = model.init_cache(B, max_len, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, {"tokens": tokens}, cache)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite prefill logits")
        tok = torch.argmax(logits, dim=-1)
        finite = torch.ones((), dtype=torch.bool, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(max_new):   # no host sync inside the loop, as in generate
            logits, cache = model.decode_step(params, tok, T0 + i, cache)
            finite &= torch.isfinite(logits).all()
            tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        if not bool(finite):
            raise AssertionError("non-finite decode logits")
    no_launches(ops.launch_counts(), f"{what}: prefill and decode")
    r = {"prefill_ms": sorted(prefill_ms)[1], "decode_tok_s": B * max_new / decode_s,
         "decode_ms_per_step": decode_s * 1e3 / max_new, "peak_gib": peak / 2**30,
         "generate_first_call_s": wall}
    log(f"  generate: {B}x{T0} prompt + {max_new} new tokens in {wall:.3f} s (first call), "
        f"no kernel launched")
    log(f"  prefill {B}x{T0}: {r['prefill_ms']:.2f} ms (median of 3: "
        f"{', '.join(f'{m:.2f}' for m in prefill_ms)}); decode {r['decode_tok_s']:.1f} tok/s "
        f"({r['decode_ms_per_step']:.2f} ms/step, batch {B}); peak memory "
        f"{r['peak_gib']:.2f} GiB; on {state['smi']}")
    return r, tokens


@contextlib.contextmanager
def recorded_routes(calls):
    """Every ``moe.route`` result, in call order, appended to ``calls``."""
    route = MOE.route

    def recording(p, cfg, x):
        out = route(p, cfg, x)
        calls.append(out)
        return out

    MOE.route = recording
    try:
        yield calls
    finally:
        MOE.route = route


def describe(cfg, params):
    n = sum(t.numel() for t in tree_leaves(params))
    return (f"{cfg.name} {cfg.n_layers} layers {sorted(set(cfg.block_pattern))}, d_model "
            f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, experts "
            f"{cfg.n_experts} top-{cfg.top_k}, d_rnn {cfg.d_rnn}, vocab {cfg.vocab_size}, "
            f"{cfg.dtype}, {n / 1e9:.3f} B params")


def phase_serve_moe(state):
    cfg = get_config(MOE_ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(7))
    log(f"moe serve: {describe(cfg, params)}")
    r, tokens = serve_and_time(state, model, params, prompts_for(seed=8), MAX_NEW, "moe serve")
    # the prefill's routing, once more with every route recorded; and, for
    # comparison, a prefill of token ids drawn from the whole vocabulary
    # (the prompts are printable bytes: 95 distinct ids)
    g = torch.Generator(device="cuda").manual_seed(15)
    spread = torch.randint(0, cfg.vocab_size, tokens.shape, generator=g, device="cuda")
    for name, toks in (("prompts", tokens), ("vocabulary-wide ids", spread)):
        with torch.inference_mode(), recorded_routes([]) as calls:
            model.prefill(params, {"tokens": toks},
                          model.init_cache(BATCH, PROMPT_LEN + 1, device="cuda"))
        if len(calls) != cfg.n_layers:
            raise AssertionError(f"{len(calls)} routed layers, expected {cfg.n_layers}")
        kept = torch.stack([c[4] for c in calls])             # (layers, B, T, K)
        by_layer = (~kept).flatten(1).float().mean(1).tolist()
        log(f"  prefill routing of the {name}: capacity {calls[0][5]} a expert, "
            f"{int((~kept).sum())} of {kept.numel()} (token, choice) pairs dropped over "
            f"{len(calls)} layers; dropped share by layer "
            f"{', '.join(f'{x:.3f}' for x in by_layer)}")
        if name == "prompts":
            r.update(capacity=calls[0][5], dropped_pairs=int((~kept).sum()),
                     pairs=kept.numel(), dropped_by_layer=by_layer)
        else:
            r["spread_dropped_pairs"] = int((~kept).sum())
    state["serve_moe"] = r
    del params, model
    torch.cuda.empty_cache()


def phase_moe_card_vs_cpu(state):
    """The MoE layer has no kernel: the card's torch ops against the CPU's
    on the same parameters and tokens, logits and the chosen experts."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_CMP_LAYERS, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(9))
    host = tree_map(lambda t: t.cpu(), params)
    log(f"moe card vs cpu: {describe(cfg, params)}, TF32 off")
    g = torch.Generator().manual_seed(10)
    T = MOE_CMP_PROMPT + MOE_CMP_DECODE
    toks = torch.randint(0, cfg.vocab_size, (MOE_CMP_BATCH, T), generator=g)
    runs = {}
    for dev, p in (("cuda", params), ("cpu", host)):
        t = toks.to(dev)
        with torch.inference_mode(), recorded_routes([]) as calls:
            cache = model.init_cache(MOE_CMP_BATCH, T, device=dev)
            lg, cache = model.prefill(p, {"tokens": t[:, :MOE_CMP_PROMPT]}, cache)
            logits = [lg]
            for i in range(MOE_CMP_PROMPT, T):
                lg, cache = model.decode_step(p, t[:, i], i, cache)
                logits.append(lg)
        runs[dev] = ([x.float().cpu() for x in logits],
                     [(c[0].cpu(), c[1].cpu()) for c in calls])
    err = max(float((a - b).abs().max()) for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    n_pairs, ties = 0, []
    for call, ((_, i_gpu), (p_cpu, i_cpu)) in enumerate(zip(runs["cuda"][1], runs["cpu"][1])):
        n_pairs += i_cpu.numel()
        for b, t, k in (i_gpu != i_cpu).nonzero().tolist():
            a, c = int(i_gpu[b, t, k]), int(i_cpu[b, t, k])
            gap = abs(float(p_cpu[b, t, a]) - float(p_cpu[b, t, c]))
            ties.append((call, b, t, k, a, c, gap))
            log(f"  route call {call} (b {b}, t {t}, choice {k}): card expert {a}, cpu "
                f"expert {c}, router probabilities {gap:.3e} apart")
    state["moe_card_vs_cpu"] = {"max_abs_logit_err": err, "routed_pairs": n_pairs,
                                "differing_choices": len(ties)}
    log(f"  {len(runs['cuda'][0])} logit rows (prefill {MOE_CMP_BATCH}x{MOE_CMP_PROMPT} + "
        f"{MOE_CMP_DECODE} decode steps): max |dlogit| {err:.3e} (tol {MOE_CMP_TOL}); "
        f"{len(ties)} of {n_pairs} (token, choice) pairs chose another expert")
    if len(runs["cuda"][1]) != len(runs["cpu"][1]) or not runs["cpu"][1]:
        raise AssertionError("the two runs routed a different number of times")
    if any(gap > MOE_TIE for *_, gap in ties):
        raise AssertionError(f"an expert choice differs without a router tie (<= {MOE_TIE})")
    if not err <= MOE_CMP_TOL:
        raise AssertionError(f"card and CPU logits differ by {err}")
    del params, host, model
    torch.cuda.empty_cache()


def corpus_reader(batch, seq):
    """The seeded synthetic byte corpus in a BlobSeer blob, and a reader."""
    client = BlobSeerService(n_providers=4, n_meta_shards=4).client("trainer")
    writer = CorpusWriter(client, psize=16 * 1024)
    synthesize_corpus(writer, ByteTokenizer(), n_docs=400)
    return client, ShardedReader(client, writer.blob_id, batch=batch, seq_len=seq)


def phase_train_moe(state):
    cfg = get_config(MOE_TRAIN_ARCH)
    _, reader = corpus_reader(TRAIN_BATCH, TRAIN_SEQ)
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100)
    full = TrainStepBuilder(build_model(cfg), opt=opt, remat_policy="full")
    dots = TrainStepBuilder(build_model(cfg), opt=opt, remat_policy="dots")

    def next_batch():
        tokens, labels = reader.next_batch()
        return {"tokens": torch.as_tensor(tokens, device="cuda"),
                "labels": torch.as_tensor(labels, device="cuda")}

    def check(metrics, what):
        loss, gnorm, aux = (float(metrics[k]) for k in ("loss", "grad_norm", "aux"))
        if not (np.isfinite(loss) and np.isfinite(gnorm) and aux > 0):
            raise AssertionError(f"{what}: loss {loss}, grad norm {gnorm}, aux {aux}")
        return loss, gnorm, aux

    # -- the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    train_state = full.init_state(torch.Generator(device="cuda").manual_seed(0))
    n_state = sum(t.numel() * t.element_size() for _, t in flatten_with_paths(train_state))
    log(f"moe train: {describe(cfg, train_state['params'])}, state {n_state / 1e9:.2f} GB, "
        f"batch {TRAIN_BATCH}x{TRAIN_SEQ}")
    step_full, step_dots = full.train_step_fn(), dots.train_step_fn()
    full_ms = []
    for _ in range(TRAIN_STEPS):
        batch = next_batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_state, metrics = step_full(train_state, batch)
        loss, gnorm, aux = check(metrics, "full")
        full_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"  step {int(train_state['step'])} (remat full): loss {loss:.4f} grad norm "
            f"{gnorm:.4f} aux {aux:.4f} in {full_ms[-1]:.1f} ms")
    full_peak = torch.cuda.max_memory_allocated()

    # the next batch's forward and backward at each policy, without an
    # update (an AdamW step's peak is its float32 temporaries of the
    # largest leaf, whatever the policy), then the step at "dots" from
    # the same state and batch
    batch = next_batch()
    fb = {}
    for name, builder in (("full", full), ("dots", dots)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss_b, _, grads = builder._grads(train_state["params"], batch)
        gnorm_b = float(global_norm(grads))
        fb[name] = {"loss": float(loss_b), "grad_norm": gnorm_b,
                    "ms": (time.perf_counter() - t0) * 1e3,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del grads
        log(f"  forward + backward at {name}: loss {fb[name]['loss']:.6f} grad norm "
            f"{gnorm_b:.6f} in {fb[name]['ms']:.1f} ms, peak {fb[name]['peak_gib']:.2f} GiB")
    loss_full, gnorm_full = fb["full"]["loss"], fb["full"]["grad_norm"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_state, metrics = step_dots(train_state, batch)
    loss, gnorm, aux = check(metrics, "dots")
    dots_ms = (time.perf_counter() - t0) * 1e3
    dots_peak = torch.cuda.max_memory_allocated()
    no_launches(ops.launch_counts(), "moe train")
    log(f"  step {int(train_state['step'])} (remat dots): loss {loss:.6f} grad norm "
        f"{gnorm:.6f} aux {aux:.4f} in {dots_ms:.1f} ms; the same batch at full: loss "
        f"{loss_full:.6f} grad norm {gnorm_full:.6f}")
    state["train_moe"] = {"full_step_ms": full_ms, "full_peak_gib": full_peak / 2**30,
                          "dots_step_ms": dots_ms, "dots_peak_gib": dots_peak / 2**30,
                          "fwd_bwd": fb, "state_gb": n_state / 1e9}
    log(f"  remat full: step {full_ms[-1]:.1f} ms warm ({', '.join(f'{m:.1f}' for m in full_ms)}),"
        f" peak {full_peak / 2**30:.2f} GiB; remat dots: step {dots_ms:.1f} ms, peak "
        f"{dots_peak / 2**30:.2f} GiB; forward + backward {fb['full']['ms']:.1f} vs "
        f"{fb['dots']['ms']:.1f} ms, peak {fb['full']['peak_gib']:.2f} vs "
        f"{fb['dots']['peak_gib']:.2f} GiB; no kernel launched; on {state['smi']}")
    if abs(loss - loss_full) > REMAT_LOSS_RTOL * abs(loss_full):
        raise AssertionError(f"dots loss {loss} vs full {loss_full}")
    if abs(gnorm - gnorm_full) > REMAT_GNORM_RTOL * gnorm_full:
        raise AssertionError(f"dots grad norm {gnorm} vs full {gnorm_full}")
    del train_state, metrics, batch
    torch.cuda.empty_cache()


def phase_serve_xlstm(state):
    cfg = get_config(XLSTM_ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(11))
    log(f"xlstm serve: {describe(cfg, params)}")
    state["serve_xlstm"], _ = serve_and_time(state, model, params, prompts_for(seed=12),
                                             MAX_NEW, "xlstm serve")
    del params, model
    torch.cuda.empty_cache()


def phase_teacher_forcing_xlstm(state):
    cfg = dataclasses.replace(get_config(XLSTM_ARCH), n_layers=XLSTM_TF_LAYERS, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(13))
    B, T0, T = 2, XLSTM_TF_PREFILL, XLSTM_TF_PREFILL + XLSTM_TF_DECODE
    g = torch.Generator(device="cuda").manual_seed(14)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g, device="cuda")
    ops.reset_launch_counts()
    with torch.inference_mode():
        x = params["embed"]["table"][toks]
        full = LM._logits(params, cfg, LM.apply_stack_train(
            params, cfg, x, torch.arange(T, device="cuda"))[0])
        cache = model.init_cache(B, T + 4, device="cuda")
        lg, cache = model.prefill(params, {"tokens": toks[:, :T0]}, cache)
        errs = [float((lg - full[:, T0 - 1]).abs().max())]
        for t in range(T0, T):
            lg, cache = model.decode_step(params, toks[:, t], t, cache)
            errs.append(float((lg - full[:, t]).abs().max()))
    no_launches(ops.launch_counts(), "xlstm teacher forcing")
    state["teacher_xlstm_err"] = max(errs)
    log(f"xlstm teacher forcing: {cfg.n_layers} layers {cfg.block_pattern}, d_model "
        f"{cfg.d_model}, d_rnn {cfg.d_rnn}, float32, prefill {T0} + {T - T0} decode steps vs "
        f"one forward over {T}: max |dlogit| {max(errs):.3e} (tol {TEACHER_TOL})")
    if not max(errs) < TEACHER_TOL:
        raise AssertionError(f"decode disagrees with the full forward: {errs}")
    del params, model, cache, full
    torch.cuda.empty_cache()


# ------------------------------------------------------ the encoder-decoder


def frame_embeddings(batch, frames, d_model, seed):
    """Stub frontend output (batch, frames, d_model), float32, made with
    numpy from ``seed`` and moved to the card."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((batch, frames, d_model),
                                                dtype=np.float32)).to("cuda")


def median_ms(fn, n=3):
    """The median host ms of ``n`` calls of ``fn``, each ended by a sync."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return sorted(ms)[n // 2], ms


def phase_serve_encdec(state):
    cfg = get_config(ENCDEC_ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(16))
    n_params = sum(t.numel() for t in tree_leaves(params))
    B, S, T0, new = ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_NEW
    log(f"encdec serve: {cfg.name} {cfg.n_enc_layers} encoder + {cfg.n_layers} decoder layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, {n_params / 1e9:.3f} B params; "
        f"{B} x {S} frames, {B} x {T0} prompt tokens, {new} new tokens")
    emb = frame_embeddings(B, S, cfg.d_model, seed=17)
    tokens = torch.as_tensor(np.stack(prompts_for(seed=18, batch=B, length=T0)).astype(np.int64),
                             device="cuda")
    batch = {"enc_embeds": emb, "tokens": tokens}
    max_len = T0 + new
    # attention over more than 4096 frames: each encoder layer and each
    # decoder layer's cross-attention in the prefill, then every decoder
    # layer's in each decode step
    want = cfg.n_enc_layers + cfg.n_layers * new

    # -- the main path: counts at 0 just before, read just after.  The
    # facade's prefill, then greedy decode steps over its memories
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        cache = model.init_cache(B, max_len, device="cuda")
        logits, cache, mem = model.prefill(params, batch, cache)
        finite = torch.isfinite(logits).all()
        out = [torch.argmax(logits, dim=-1)]
        for i in range(new - 1):
            logits, cache = model.decode_step(params, out[-1], T0 + i, cache, mem)
            finite &= torch.isfinite(logits).all()
            out.append(torch.argmax(logits, dim=-1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    state["encdec_launches"] = counts
    log(f"  prefill + {new - 1} decode steps: {new} new tokens a row in {wall:.3f} s (first "
        f"call); launches {counts}")
    if counts["flash_attention_sm90"] != want or counts["flash_attention"] != 0:
        raise AssertionError(f"flash_attention_sm90 launched {counts['flash_attention_sm90']} "
                             f"times and flash_attention {counts['flash_attention']}, expected "
                             f"{want} ({cfg.n_enc_layers} + {cfg.n_layers} in the prefill, "
                             f"{cfg.n_layers} a decode step) and 0")
    new_tokens = torch.stack(out, dim=1)
    if not bool(finite) or new_tokens.shape != (B, new) or \
            not bool(((new_tokens >= 0) & (new_tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"non-finite logits or bad tokens {tuple(new_tokens.shape)}")
    for name, t in (("K", mem[0]), ("V", mem[1])):
        if tuple(t.shape) != (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim) or \
                not t.is_contiguous():
            raise AssertionError(f"memory {name} {tuple(t.shape)} {t.stride()}")
    mem_gb = 2 * mem[0].numel() * mem[0].element_size() / 1e9
    del logits, cache, mem

    # -- timings through the same entry points, warm: the prefill, the
    # encoder alone and the memories alone (medians of 3), then the decode
    with torch.inference_mode():
        held = {}

        def prefill():
            held.clear()
            ops.reset_launch_counts()
            held["out"] = model.prefill(params, batch, model.init_cache(B, max_len, device="cuda"))
            c = ops.launch_counts()
            if c["flash_attention_sm90"] != cfg.n_enc_layers + cfg.n_layers:
                raise AssertionError(f"prefill launched {c}")

        prefill_ms, prefill_all = median_ms(prefill)
        held.clear()
        enc_ms, _ = median_ms(lambda: held.update(enc=ED.encode(params, cfg, emb)))

        def memories():
            held.pop("mem", None)
            held["mem"] = ED.cross_memories(params, cfg, held["enc"])

        mem_ms, _ = median_ms(memories)
        held.clear()
        prefill()
        logits, cache, mem = held.pop("out")
        tok = torch.argmax(logits, dim=-1)
        finite = torch.ones((), dtype=torch.bool, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(new - 1):   # no host sync inside the loop
            logits, cache = model.decode_step(params, tok, T0 + i, cache, mem)
            finite &= torch.isfinite(logits).all()
            tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        if not bool(finite):
            raise AssertionError("non-finite decode logits")
    state["serve_encdec"] = r = {
        "prefill_ms": prefill_ms, "encode_ms": enc_ms, "memories_ms": mem_ms,
        "encoder_share": enc_ms / prefill_ms,
        "decode_tok_s": B * (new - 1) / decode_s, "decode_ms_per_step": decode_s * 1e3 / (new - 1),
        "peak_gib": peak / 2**30, "memories_gb": mem_gb, "first_call_s": wall,
    }
    log(f"  prefill {B}x{S} frames + {B}x{T0} tokens: {prefill_ms:.2f} ms (median of 3: "
        f"{', '.join(f'{m:.2f}' for m in prefill_all)}); encoder {enc_ms:.2f} ms "
        f"({r['encoder_share']:.1%} of the prefill), memories {mem_ms:.2f} ms ({mem_gb:.2f} GB); "
        f"decode {r['decode_tok_s']:.1f} tok/s ({r['decode_ms_per_step']:.2f} ms/step, batch "
        f"{B}); peak memory {r['peak_gib']:.2f} GiB; on {state['smi']}")
    del params, model, cache, logits, mem, emb, held
    torch.cuda.empty_cache()


def phase_teacher_forcing_encdec(state):
    cfg = dataclasses.replace(get_config(ENCDEC_ARCH), n_layers=ENCDEC_TF_LAYERS,
                              n_enc_layers=ENCDEC_TF_LAYERS, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(19))
    T0, T = ENCDEC_PROMPT, ENCDEC_PROMPT + ENCDEC_NEW
    emb = frame_embeddings(1, ENCDEC_TF_FRAMES, cfg.d_model, seed=20)
    g = torch.Generator(device="cuda").manual_seed(21)
    toks = torch.randint(0, cfg.vocab_size, (1, T), generator=g, device="cuda")
    with torch.inference_mode():
        ops.reset_launch_counts()
        full = ED.decode_train(params, cfg, toks, ED.encode(params, cfg, emb))
        fwd = ops.launch_counts()["flash_attention"]
        ops.reset_launch_counts()
        cache = model.init_cache(1, T + 4, device="cuda")
        lg, cache, mem = model.prefill(params, {"enc_embeds": emb, "tokens": toks[:, :T0]},
                                       cache)
        pre = ops.launch_counts()["flash_attention"]
        errs = [float((lg - full[:, T0 - 1]).abs().max())]
        for t in range(T0, T):
            lg, cache = model.decode_step(params, toks[:, t], t, cache, mem)
            errs.append(float((lg - full[:, t]).abs().max()))
        dec = ops.launch_counts()["flash_attention"] - pre
        sm90 = ops.launch_counts()["flash_attention_sm90"]
    state["teacher_encdec_err"] = max(errs)
    state["encdec_tf_launches"] = fwd + pre + dec
    log(f"encdec teacher forcing: {cfg.name} {cfg.n_enc_layers} + {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, float32, {ENCDEC_TF_FRAMES} frames, prefill {T0} + {T - T0} decode "
        f"steps vs one decode_train over {T}: max |dlogit| {max(errs):.3e} (tol {TEACHER_TOL}); "
        f"flash_attention launches: forward {fwd}, prefill {pre}, decode {dec}")
    n = cfg.n_enc_layers + cfg.n_layers
    if (fwd, pre, dec, sm90) != (n, n, cfg.n_layers * (T - T0), 0):
        raise AssertionError(f"expected {n} float32 launches in the forward and the prefill, "
                             f"{cfg.n_layers * (T - T0)} in decode and no bf16 kernel, got "
                             f"{fwd}, {pre}, {dec}, {sm90}")
    if not max(errs) < TEACHER_TOL:
        raise AssertionError(f"decode disagrees with teacher forcing: {errs}")
    del params, model, cache, full, mem, emb
    torch.cuda.empty_cache()


def phase_train_encdec(state):
    cfg = get_config(ENCDEC_ARCH)
    _, reader = corpus_reader(TRAIN_BATCH, TRAIN_SEQ)
    builder = TrainStepBuilder(build_model(cfg), remat_policy="full",
                               opt=AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100))
    step_fn = builder.train_step_fn()

    # -- the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    train_state = builder.init_state(torch.Generator(device="cuda").manual_seed(22))
    n_state = sum(t.numel() * t.element_size() for _, t in flatten_with_paths(train_state))
    n_params = sum(t.numel() for t in tree_leaves(train_state["params"]))
    log(f"encdec train: {cfg.name} {cfg.n_enc_layers} + {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B params, state {n_state / 1e9:.2f} GB, {TRAIN_BATCH} x "
        f"{ENCDEC_TRAIN_FRAMES} frames and {TRAIN_BATCH} x {TRAIN_SEQ} tokens, remat full")
    step_ms = []
    for i in range(TRAIN_STEPS):
        tokens, labels = reader.next_batch()
        batch = {"enc_embeds": frame_embeddings(TRAIN_BATCH, ENCDEC_TRAIN_FRAMES, cfg.d_model,
                                                seed=23 + i),
                 "tokens": torch.as_tensor(tokens, device="cuda"),
                 "labels": torch.as_tensor(labels, device="cuda")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_state, metrics = step_fn(train_state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        step_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"  step {int(train_state['step'])}: loss {loss:.4f} grad norm {gnorm:.4f} in "
            f"{step_ms[-1]:.1f} ms")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"non-finite loss {loss} or grad norm {gnorm}")
    no_launches(ops.launch_counts(), "encdec train")
    peak = torch.cuda.max_memory_allocated()
    state["train_encdec"] = {"step_ms": step_ms, "peak_gib": peak / 2**30,
                             "state_gb": n_state / 1e9}
    log(f"  step: {', '.join(f'{m:.1f}' for m in step_ms)} ms; peak device memory "
        f"{peak / 2**30:.2f} GiB; no kernel launched (attention over {ENCDEC_TRAIN_FRAMES} "
        f"frames stays dense); on {state['smi']}")
    del train_state, metrics, batch
    torch.cuda.empty_cache()


# ------------------------------------------------- launch tooling, examples

# the dry run's cells on the card machine (``repro_torch.launch.dryrun``):
# (arch, shape, mesh); train cells at one microbatch to keep the phase short
DRYRUN_CELLS = [[("qwen3-32b", "train_4k", "single")],
                [("olmo-1b", "train_4k", "single"), ("olmo-1b", "train_4k", "multi")],
                [("h2o-danube-3-4b", "prefill_32k", "single"),
                 ("granite-moe-1b-a400m", "decode_32k", "single"),
                 ("recurrentgemma-2b", "long_500k", "single")]]
DRYRUN_TIMEOUT_S = 300
ARG_BYTES_RTOL = 1e-3      # the (1, 1) record's inputs vs the train phase's state and batch
# one process of the dry run: its cells, then (the last group) the (1, 1)
# record of the train phase's step
_DRYRUN_SCRIPT = """
import functools, json, sys
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch.dryrun import run_cell, trace_cell
from repro_torch.launch.mesh import make_mesh
cells, out, smoke = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3] == "1"
for arch, shape, mesh in cells:
    run_cell(arch, shape, mesh, "auto", out, accum=1 if shape.startswith("train") else None,
             device="cuda", timeout_s=%d)
if smoke:
    rec = trace_cell(get_config(%r), ShapeCell("smoke_train", "train", %d, %d), 1,
                     functools.partial(make_mesh, (1, 1), ("data", "model"), device="cuda"),
                     "tp_fsdp", remat="none", accum=1, device="cuda")
    with open(out + "/smoke_train_1x1.json", "w") as f:
        json.dump(rec, f, default=str)
""" % (DRYRUN_TIMEOUT_S, TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH)


def phase_dry_run(state):
    """The port's dry run of six cells on fake 256- and 512-rank meshes,
    each group of cells in its own process (the fake process group must
    not meet this process's NCCL group), the groups in parallel."""
    out = os.path.join(ROOT, "experiments", "dryrun_torch", "smoke")
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", _DRYRUN_SCRIPT, json.dumps(cells), out,
                               "1" if i == len(DRYRUN_CELLS) - 1 else "0"],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i, cells in enumerate(DRYRUN_CELLS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=2 * DRYRUN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"a dry-run process exited {p.returncode}:\n{text[-3000:]}")
    recs = []
    for arch, shape, mesh in (c for group in DRYRUN_CELLS for c in group):
        strategy = "tp_fsdp" if shape.startswith("train") else "tp_serve"
        with open(os.path.join(out, f"{arch}_{shape}_{mesh}_{strategy}.json")) as f:
            rec = json.load(f)
        recs.append(rec)
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {arch} {shape} {mesh}: {rec['status']} "
                                 f"{rec.get('error', '')[:1000]}")
        m, rf = rec["memory"], rec["roofline"]
        log(f"  dry run {arch} {shape} {mesh} {strategy} (accum {rec['accum']}): ok, build "
            f"{rec['lower_s']} s, trace {rec['compile_s']} s; {(m['argument_bytes'] + m['temp_bytes']) / 2**30:.2f} "
            f"GiB a device (args {m['argument_bytes'] / 2**30:.2f} + temp "
            f"{m['temp_bytes'] / 2**30:.2f}); FLOPs traced {rec['cost_hlo_raw']['flops']:.4e} "
            f"vs analytic {rf['flops_per_device']:.4e} a device; collectives "
            f"{rec['collectives_hlo']['count_by_op']}; roofline {rf['step_time_s'] * 1e3:.2f} ms, "
            f"{rf['bottleneck']} (H100 constants)")
    with open(os.path.join(out, "smoke_train_1x1.json")) as f:
        smoke = json.load(f)
    got, want = smoke["memory"]["argument_bytes"], state["train"]["arg_bytes"]
    log(f"  (1, 1) record of the train step ({TRAIN_ARCH} {TRAIN_BATCH}x{TRAIN_SEQ}, remat none): "
        f"argument bytes {got} vs {want} held by the train phase's state and batch "
        f"({got / want - 1:+.2e}); temp estimate {smoke['memory']['temp_bytes'] / 2**30:.2f} GiB, "
        f"inputs + temp {(got + smoke['memory']['temp_bytes']) / 2**30:.2f} GiB vs the train "
        f"phase's measured step peak {state['train']['step_peak_gib']:.2f} GiB; traced FLOPs "
        f"{smoke['cost_hlo_raw']['flops']:.4e} vs analytic {smoke['roofline']['flops_per_device']:.4e}")
    if abs(got / want - 1) > ARG_BYTES_RTOL:
        raise AssertionError(f"(1, 1) argument bytes {got} vs {want}")
    state["dry_run"] = {"cells": recs, "smoke": smoke}


def phase_roofline_vs_card(state):
    """Model FLOPs, the cost model's roofline at (1, 1) with the H100's
    constants, and the measured time of two cells of this run: the
    olmo-1b train step at 2 x 2048 and the h2o-danube3-4b prefill at
    4 x 8192.  Then the host cost of the custom-op binding of attention
    (``ops.flash_attention``'s fake-tensor check) at a decode step's shape."""
    one = types.SimpleNamespace(shape={"data": 1, "model": 1})    # a (1, 1) mesh's sizes
    cells = [
        (TRAIN_ARCH, ShapeCell("smoke_train", "train", TRAIN_SEQ, TRAIN_BATCH), "tp",
         min(state["train"]["step_ms"][1:]), "train phase, fastest warm step"),
        (LONG_ARCH, ShapeCell("smoke_prefill", "prefill", LONG_PROMPT, LONG_BATCH), "tp_serve",
         state["serve_long"]["prefill_ms"], "long-context serve, median of 3"),
    ]
    rows = []
    for arch, cell, strategy, ms, what in cells:
        cfg = get_config(arch)
        mf = model_flops_for(cfg, cell)
        roof = analytic_roofline(cfg, cell, one, strategy, remat="none", accum=1,
                                 model_flops=mf)
        rows.append({"arch": arch, "cell": dataclasses.asdict(cell), "model_flops": mf,
                     "roofline_ms": roof.step_time_s * 1e3, "bottleneck": roof.bottleneck,
                     "measured_ms": ms, "share": mf / BF16_FLOP_PER_S / (ms / 1e3)})
        r = rows[-1]
        log(f"  {arch} {cell.step} {cell.global_batch}x{cell.seq_len}: model FLOPs {mf:.4e}, "
            f"roofline {r['roofline_ms']:.2f} ms ({r['bottleneck']}), measured {ms:.2f} ms "
            f"({what}); model FLOPs / peak / measured = {r['share']:.2%}; on {state['smi']}")

    # the binding's host cost: a real CUDA tensor goes past the fake check
    # to the kernel; both issue the same launch, timed on the host
    cfg = get_config(ENCDEC_ARCH)
    q = torch.randn(ENCDEC_BATCH, cfg.n_heads, 1, cfg.head_dim, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn(ENCDEC_BATCH, cfg.n_kv_heads, 4096 + 8, cfg.head_dim, device="cuda",
                    dtype=torch.bfloat16)
    kw = dict(causal=False, window=None, q_offset=0, softcap=None)

    def host_us(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / n * 1e6

    with torch.inference_mode():
        direct = [host_us(lambda: flash_attention_sm90_cuda(q, k, k, **kw)) for _ in range(3)]
        bound = [host_us(lambda: ops.flash_attention(q, k, k, **kw)) for _ in range(3)]
    from torch._subclasses.fake_tensor import FakeTensor

    t0 = time.perf_counter()
    for _ in range(100_000):
        isinstance(q, FakeTensor)
    check_ns = (time.perf_counter() - t0) / 100_000 * 1e9
    ops.reset_launch_counts()
    binding = {"direct_us": sorted(direct)[1], "ops_us": sorted(bound)[1], "check_ns": check_ns,
               "shape": [list(q.shape), list(k.shape)],
               "seamless_decode_ms_per_step": state["serve_encdec"]["decode_ms_per_step"]}
    log(f"  binding: ops.flash_attention {binding['ops_us']:.2f} us a call on the host vs the "
        f"kernel's wrapper {binding['direct_us']:.2f} us (median of 3 x 200 calls, q "
        f"{binding['shape'][0]}), of which the fake-tensor check is {check_ns:.1f} ns; x 24 "
        f"a seamless decode step ({binding['seamless_decode_ms_per_step']:.2f} ms a step in "
        f"this run)")
    state["roofline_vs_card"] = {"cells": rows, "binding": binding}


def _example(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(state):
    """The two example twins at their defaults on the card: the crash and
    resume run's losses after the crash equal an uninterrupted run's bit
    for bit; each fork adds no data page, and the trunk restores
    byte-equal after branching.  Their checkpoint saves launch
    ``page_digest`` and ``delta_mask``."""
    train, branch = _example("train_e2e_torch"), _example("branch_experiments_torch")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    crashed = train.main(["--device", "cuda"])
    t1 = time.perf_counter()
    straight = train.main(["--device", "cuda", "--crash-at", "300"])
    t2 = time.perf_counter()
    out = branch.main(["--device", "cuda"])
    t3 = time.perf_counter()
    counts = ops.launch_counts()
    state["examples_launches"] = counts
    after = sorted(s for s in crashed["losses"] if s >= crashed["resumed_at"])
    same = [crashed["losses"][s] == straight["losses"][s] for s in after]
    log(f"  train_e2e_torch: {len(crashed['losses'])} steps, resumed at step "
        f"{crashed['resumed_at']} ({t1 - t0:.1f} s); uninterrupted run ({t2 - t1:.1f} s); "
        f"{sum(same)}/{len(same)} losses after the resume bit-equal; lineage "
        f"{crashed['lineage']}")
    if not after or not all(same) or not np.isfinite(list(crashed["losses"].values())).all():
        raise AssertionError("the resumed losses differ from the uninterrupted run's")
    for name, b in out["branches"].items():
        log(f"  branch_experiments_torch {name}: fork added {b['fork_pages']} pages, saved "
            f"{b['pages_written']}/{b['pages_total']} pages, loss {b['losses'][0]:.3f} -> "
            f"{b['losses'][-1]:.3f}")
        if b["fork_pages"] != 0:
            raise AssertionError(f"{name}: the fork added {b['fork_pages']} pages")
    pairs = list(zip(flatten_with_paths(out["trunk"]["state"]),
                     flatten_with_paths(out["trunk_restored"])))
    if not pairs or not all(ka == kb and torch.equal(ops.leaf_bytes(a), ops.leaf_bytes(b))
                            for (ka, a), (kb, b) in pairs):
        raise AssertionError("the trunk did not restore byte-equal after branching")
    log(f"  trunk restored byte-equal ({out['trunk_elements']} elements) in {t3 - t2:.1f} s; "
        f"launches {counts}")
    if counts["page_digest"] == 0 or counts["delta_mask"] == 0:
        raise AssertionError(f"the examples' saves launched {counts}")
    state["examples"] = {"train_s": t1 - t0, "straight_s": t2 - t1, "branch_s": t3 - t2,
                         "launches": counts}
    torch.cuda.empty_cache()


PHASES = [
    ("device", phase_device),
    ("build", phase_build),
    ("kernel vs plain", phase_scan_vs_plain),
    ("digest and mask vs plain", phase_digest_vs_plain),
    ("flash attention vs plain", phase_flash_vs_plain),
    ("serve", phase_serve),
    ("decode vs teacher forcing", phase_teacher_forcing),
    ("long-context serve", phase_serve_long),
    ("long decode vs teacher forcing", phase_teacher_forcing_long),
    ("train entry point", phase_train_entry),
    ("train and checkpoint", phase_train),
    ("moe serve", phase_serve_moe),
    ("moe card vs cpu", phase_moe_card_vs_cpu),
    ("moe train", phase_train_moe),
    ("xlstm serve", phase_serve_xlstm),
    ("xlstm decode vs teacher forcing", phase_teacher_forcing_xlstm),
    ("encdec serve", phase_serve_encdec),
    ("encdec decode vs teacher forcing", phase_teacher_forcing_encdec),
    ("encdec train", phase_train_encdec),
    ("mesh group", phase_mesh_group),
    ("mesh train and checkpoint", phase_mesh_train),
    ("mesh collective", phase_mesh_collective),
    ("mesh serve", phase_mesh_serve),
    ("dry run", phase_dry_run),
    ("roofline vs card", phase_roofline_vs_card),
    ("examples", phase_examples),
    ("kernel times", phase_kernel_times),
]


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on one H100.")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phase names to run, in order (default: all; a "
                         "phase may need what an earlier one left, and without 'kernel "
                         "times' the run prints no result)")
    args = ap.parse_args()
    names = None if args.phases is None else args.phases.split(",")
    unknown = set(names or ()) - {n for n, _ in PHASES}
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    state = {"cfg": get_config(ARCH)}
    failed = []
    for name, fn in PHASES:
        if names is not None and name not in names:
            continue
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
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
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
