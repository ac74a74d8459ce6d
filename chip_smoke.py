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
   step's (4, 16, 1, 64); the bf16 kernel's split path (its keys cut into
   ranges, merged in the same launch by the last block of each row block
   to finish) at those two cross-attentions and at forced splits with rows
   and ranges that see no key, each within the bf16 limit, its lse within
   1e-5, two calls bit-equal, one split launch a call; then the backward
   against the plain backward
   (``flash_attention_bwd_sm90``, bf16 on the tensor cores, and
   ``flash_attention_bwd``, float32 arithmetic, each on its dtype; the
   same q, k, v, the dtype's forward kernel's o and lse, a seeded do) over
   that sweep in both dtypes and layouts, over bf16 cases at the edges of
   the bf16 kernel's configuration for head widths up to 64 (no mask with
   Tq and Tk off 64 and 128, GQA, causal with ``q_offset`` 100 and -40, a
   24-key window, a softcap, one query row, D = 32; both layouts), over
   bf16 cases of both bf16 kernels' configuration for head widths 65-128
   (D = 72, 96, 120, 128 with causal, ``q_offset`` 100 and -40, windows,
   softcaps, no mask, one query row, Tq and Tk off 64 and 128, GQA groups
   1 and 4, and olmo's plain causal MHA at D = 128 over 1100 keys; the
   up-to-64 and 65-128 cases again under ``FLASH_FP16_SCALES``, whose
   products run on fp16 copies: do times 2^-16, q at 1e5 with k at 1e-5 and
   the other way round, v at 1e-6; the forward's 65-128 cases, and
   ``FLASH_D128_LONG_CASES`` whose rows see 1024 keys or more, again
   under those scales of q, k and v; at widths up to 64
   ``FLASH_D64_LONG_CASES``, ``FLASH_D64_NC3_CASES`` (192-row blocks of
   three consumers), ``FLASH_D64_CASES`` and ``FLASH_SPLIT_CASES`` in both
   layouts and again under ``FLASH_D64_FWD_SCALES``, each case's launches
   by rows a block held to ``block_rows``; ``FLASH_PEAKED_CASES``, scores
   that peak on a few keys, at D = 64 in 192- and 128-row blocks and at D
   = 128) and of
   their configuration for head widths 136-256
   (``FLASH_D256_CASES``: recurrentgemma's 10 query heads over one kv head
   of 256 with windows of 100 and 2048 past 4096 keys, D = 136, 192, 200
   and 224, groups 1, 2, 3, 4 and 10, causal with ``q_offset`` 100 and
   -40, softcaps, no mask, one query row; both layouts, the forward's
   output too), over float32 cases at the float32 backward's tiles
   (``FLASH_BWD_F32_CASES``: D = 1, 33 and 256, a tile-interior case and a
   window edge inside a tile, both with a softcap, GQA, causal rows
   offset back; both layouts), over the
   training phases' shapes (danube (1, 32, 8192, 120) over (1, 8, 8192,
   120), causal, window 4096; seamless (2, 16, 8192, 64) and q (2, 16,
   2048, 64) over 8192 frames, no mask; recurrentgemma (1, 10, 8192, 256)
   over (1, 1, 8192, 256), causal, window 2048; olmo (2, 16, 8192, 128),
   plain causal) and each rank's local shard of
   danube's step over a sequence split four ways (q (1, 32, 2048, 120) at
   ``q_offset`` 0, 2048, 4096 and 6144 over all 8192 keys, both dtypes,
   the forward's output too), per gradient within 1e-4
   max|want| (float32) and 2^-7 |want| + 1e-3 max|want| (bf16), two calls
   bit-equal, fully masked rows' dq exactly 0, each forward kernel's lse
   within 1e-4 of the plain one, and the wrappers' plans of the bf16
   kernels' blocks (``block_config``, ``block_rows``) equal to the compiled
   kernels' own reports at head widths 8 to 256, and the float32
   backward's (``flash_attention_bwd.block_config``) at 8, 33, 64, 120,
   128 and 256; and ``linear_scan``'s gradient through
   the custom op (the reversed scan, two launches) against autograd
   through the plain loop at (4, 512, 2560) and (4, 8192, 2560) within
   1e-5;
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
   run the float32 ``flash_attention``; then recurrentgemma-2b past its
   4096-token dense limit: ``generate`` at full width in bf16, 4 prompts
   of 32768 tokens (the repo's ``prefill_32k`` sequence, its batch cut
   from 32 to 4), 32 new tokens: exactly 8 ``flash_attention_sm90``
   launches (one per local layer, D = 256, MQA, window 2048) and 18
   ``linear_scan`` launches in each prefill, none in decode (the 2048-slot
   window cache); the prefill time (median of 3), the decode rate and the
   peak memory; and its 4-layer float32 copy (rglru, rglru, local, rglru)
   at 2 x 8192, an 8160-token prefill and 32 decodes against one forward
   (2e-2; one float32 ``flash_attention`` launch and 3 scans in the
   forward and in the prefill, none in decode); then olmo-1b the same way
   (full causal attention, 16 heads of 128, no window): 4 x 32768 + 32 in
   bf16, exactly 16 ``flash_attention_sm90`` launches a prefill and none
   in decode (``_cache_attention`` over 32800 slots), and a 4-layer float32
   copy at 2 x 8192 (4 float32 ``flash_attention`` launches in the forward
   and 4 in the prefill, none in decode);
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
   launches); full-width training at 2 x 8192 frames and 2 x 2048 tokens
   (bf16 params, fp32 AdamW state, remat ``"full"``), 3 steps, finite:
   the encoder's self-attention and every cross-attention through
   ``flash_attention_sm90`` twice a layer a step (the forward and its
   recompute) and ``flash_attention_bwd_sm90`` once (3 x 96 and 3 x 48
   launches), the decoder's self-attention over 2048 tokens dense, then
   one more step under the profiler (top kernels, idle share);
   full-width h2o-danube3-4b (24 layers) trained 2 steps at 1 x 8192
   tokens, its published context (bf16 params, fp32 AdamW state, remat
   ``"full"``), once the dry run's one-device record of that step (fake
   tensors) fits the card: 2 x 48 ``flash_attention_sm90`` and 2 x 24
   ``flash_attention_bwd_sm90`` launches, finite, step time, peak memory
   and the device's idle share over one more step; the same model cut to
   4 layers in float32, one step at 1 x 8192 (remat ``"none"``): 4
   ``flash_attention`` and 4 ``flash_attention_bwd`` launches, finite;
   full-width
   recurrentgemma-2b trained at 1 x 8192 (remat ``"full"``), or at the
   longest multiple of 512 past 4096 tokens whose dry-run record (one
   device, fake tensors) leaves 4 GiB of the card free: one batch's
   gradients with the kernels, with the plain scan (loss and gradient norm
   within 1e-4, every RG-LRU layer's gradient of ``wx``, ``conv``,
   ``w_a``, ``w_i``, ``lam`` nonzero and finite) and with the plain
   attention (``ref_flash_attention`` and its plain backward; within
   2^-7); 18 + 16 + 18 ``linear_scan``, 8 + 8 ``flash_attention_sm90`` and
   8 ``flash_attention_bwd_sm90`` launches a step (forward, recompute,
   backward), then 2 steps, one more profiled; full-width olmo-1b trained
   at 2 x 8192 (remat ``"full"``), cut the same way if its record does not
   fit: one batch's gradients with the kernels (every one finite) and with
   the plain attention (loss and gradient norm within 2^-7), then 2 steps
   of 32 ``flash_attention_sm90`` and 16 ``flash_attention_bwd_sm90``
   launches, one more profiled;
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
   the no-mesh ones; the checkpoint of the mesh state is resumed through
   ``launch.train``'s own ``resume_state`` (rank 0 reads it whole,
   ``distribute_state`` places it) and that checkpointer's unchanged save
   launches 34 + 34; full-width seamless-m4t-large-v2 under ``tp_serve``:
   the encdec serve phase's 4 x 32768 frames and prompts, a prefill and
   31 decode steps teacher-forced on that phase's greedy tokens, its
   stacked memories placed on the mesh, exactly 48 + 24 x 31
   ``flash_attention_sm90`` launches on the local shards, logits held to
   that phase's within 1e-3 (max |dlogit| and the share of equal greedy
   tokens reported); ``launch.serve.generate(..., mesh,
   strategy="tp_serve_sm")`` on the long-context phase's prompts (24
   launches), its first new tokens equal to the mesh serve prefill's
   greedy tokens, and to the no-mesh run's in every row whose top-two
   margin there exceeds twice the prefill's |dlogit|; its new tokens
   against that phase's (the share equal reported), its wall time split
   into placement, prefill, decode steps and the rest, beside the same
   call inside ``torch.inference_mode`` (reported); full-width
   recurrentgemma-2b under ``tp_serve_hd``: ``generate`` on the serve
   phase's model and prompts, 4 x 512 + 32 (18 ``linear_scan`` launches,
   all in the prefill, on local shards), its new tokens against that
   phase's (the share equal reported), and the mesh prefill's logits
   within 1e-3 of that phase's (prefill time beside the no-mesh one);
   full-width xlstm-350m under ``tp_fsdp`` takes 2 steps at 2 x 512 from
   the state and batches of a no-mesh run, losses within 1e-4 relative;
   first of them (``mesh long train``), full-width h2o-danube3-4b under
   ``tp_fsdp`` (remat ``"full"``, no ``zero2``) takes the long train
   phase's 2 steps at 1 x 8192, once the dry run's (1, 1) record of that
   step leaves 4 GiB of the card free: as many ``flash_attention_sm90``
   and ``flash_attention_bwd_sm90`` launches as that phase (on the local
   shards), its losses within 1e-4 relative, its peak 4 GiB under the
   card, step times and peak beside the no-mesh ones; the seamless mesh
   serve runs under ``tp_fsdp_sp`` too, its launches the same and its
   greedy tokens all the no-mesh run's;
12. dry run: ``repro_torch.launch.dryrun`` in nine processes at once
   (their fake process groups apart from this one's NCCL group), on fake
   tensors over a fake 256-rank 16 x 16 mesh: olmo-1b ``train_4k``
   (``tp_fsdp``), qwen3-32b ``train_4k`` (both at one microbatch),
   h2o-danube3-4b ``prefill_32k`` (``tp_serve``), granite-moe-1b-a400m
   ``decode_32k``, recurrentgemma-2b ``long_500k``, and olmo-1b
   ``train_4k`` over 512 ranks (2 x 16 x 16); then one cell of each class
   of the mesh path's repaired faults: olmo-1b ``decode_32k`` on
   2 x 16 x 16, olmoe-1b-7b ``prefill_32k``, granite-moe-1b-a400m and
   recurrentgemma-2b ``train_4k``, xlstm-350m ``decode_32k``,
   internvl2-76b ``prefill_32k``, seamless-m4t-large-v2 ``prefill_32k``
   (on 16 x 16 and 2 x 16 x 16, its temporaries under 3 GiB a device: the
   meta tensor that asks for the memories' axis names holds no bytes) and
   ``train_4k``; then the reference's last three strategies:
   qwen1.5-32b ``train_4k`` under ``tp_fsdp_uneven``, ``prefill_32k``
   under ``tp_serve_uneven`` (traced FLOPs at most 1.3 x the analytic
   count, both), ``decode_32k`` under ``tp_serve_hd`` (temporaries and
   all-gathers under 1 GiB a device: no cache gathered),
   recurrentgemma-2b ``decode_32k`` (``tp_serve_hd``) and ``train_4k``
   (``tp_fsdp_uneven``), h2o-danube3-4b ``long_500k`` (``tp_fsdp_sp``);
   then the configurations the port once did not run under a mesh:
   h2o-danube3-4b ``train_1x8k`` (1 x 8192, ``tp_fsdp_sp``: 512 q rows a
   rank), seamless-m4t-large-v2 ``decode_32k`` (``tp_serve_hd``), and
   seamless, olmoe-1b-7b and xlstm-350m ``prefill_1x32k`` (1 x 32768,
   ``tp_fsdp_sp``), the two shapes not in ``configs/shapes.py``
   (``DRYRUN_SHAPES``) (train cells at one microbatch): each must be
   ``ok`` and within its ``DRYRUN_BOUNDS``; and a
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
   recurrentgemma-2b, without and with a mesh, and training it for
   ``linear_scan``, training, mesh training and the
   examples for ``page_digest`` and ``delta_mask``, long-context, encoder-decoder,
   mesh serving, mesh encoder-decoder serving (``tp_serve``,
   ``tp_fsdp_sp``), mesh ``generate``, recurrentgemma's and olmo's long
   serving and training, danube's training with and without a mesh for
   ``flash_attention_sm90``, the float32 long, recurrentgemma, olmo and
   encoder-decoder teacher forcing, the
   float32 mesh serve and the float32 training step for
   ``flash_attention``, the bf16 training steps (danube's also under a
   mesh, recurrentgemma's, olmo's) for ``flash_attention_bwd_sm90`` and the
   float32 one for
   ``flash_attention_bwd``; ``launches_by_path``),
   its error against
   the plain version, its time, the plain version's time, the least time
   the card could take and, where one PyTorch call computes the same
   function, that call's time, at the path's shape (``linear_scan`` also
   at (4, 8192, 2560): ``long_ms``, ``long_plain_ms``, ``long_bound_ms``;
   for both attention
   kernels, ``scaled_dot_product_attention`` with the window-causal
   boolean mask in the kernel's dtype, which the port never calls);
   ``flash_attention_sm90`` also at recurrentgemma's serving and training
   shapes (``recurrentgemma``: error, time, plain time, bound, SDPA with
   the window mask), at olmo's (``olmo``: error, time, plain time, bound,
   and ``scaled_dot_product_attention(is_causal=True)`` with no mask tensor
   under each of the cuDNN, flash and memory-efficient backends alone,
   each one's time or "refused", the fastest as ``library_ms``) and at the
   encoder-decoder's three shapes
   (``seamless``: error, time, plain time, bound, and
   ``scaled_dot_product_attention`` with no mask) and, at its two split
   cross-attentions, the split call (the merge in the same launch) beside
   the same call with ``splits=1`` (``split``, with the split launches by
   serving path); both forward rows also
   time the call that writes the lse (``lse_ms``); a
   ``flash_attention_bwd_sm90`` row at the training phases' five shapes
   in bf16 and a ``flash_attention_bwd`` row at danube's and at
   seamless's encoder (2, 16, 8192, 64) in float32
   (bound 10 D flops a live pair at the dtype's rate; library: SDPA's
   backward with the same mask, at olmo's plain causal mask under each
   backend as above), their launches by training path.

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
from repro_torch.kernels import flash_attention_bwd as fa_bwd_f32  # noqa: E402
from repro_torch.kernels.delta_mask import delta_mask_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda  # noqa: E402
from repro_torch.kernels.flash_attention_bwd_sm90 import (  # noqa: E402
    block_config, converts_to_fp16, flash_attention_bwd_sm90_cuda, kernel_blocks)
from repro_torch.kernels.flash_attention_sm90 import (  # noqa: E402
    block_rows, flash_attention_sm90_cuda, split_count)
from repro_torch.kernels.linear_scan import linear_scan_cuda  # noqa: E402
from repro_torch.kernels.page_digest import padded_page_words, page_digest_cuda  # noqa: E402
from repro_torch.kernels.ref import (ref_delta_mask, ref_flash_attention,  # noqa: E402
                                     ref_flash_attention_backward,
                                     ref_linear_scan, ref_page_digest)
from repro_torch.configs.shapes import ShapeCell  # noqa: E402
from repro_torch.launch.costmodel import analytic_roofline  # noqa: E402
from repro_torch.launch.hlo import F32_FLOPS, HBM_BW, PEAK_FLOPS  # noqa: E402
from repro_torch.launch import serve as serve_module  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.specs import model_flops_for  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.launch.train import resume_state  # noqa: E402
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
MESH_ENCDEC_DLOGIT = 1e-3     # seamless on the (1, 1) mesh: the no-mesh products, bit-equal
CKPT_PSIZE = 256 * 1024                     # BlobCheckpointer's default page
MOE_ARCH = "olmoe-1b-7b"                    # served: 4 x 512 keeps the dispatch O(T^2) small
MOE_CMP_LAYERS, MOE_CMP_BATCH, MOE_CMP_PROMPT, MOE_CMP_DECODE = 2, 2, 128, 8
MOE_CMP_TOL, MOE_TIE = 2e-3, 1e-6           # logits card vs CPU; a router near-tie
MOE_TRAIN_ARCH = "granite-moe-1b-a400m"
REMAT_LOSS_RTOL, REMAT_GNORM_RTOL = 1e-5, 1e-3
XLSTM_ARCH = "xlstm-350m"
XLSTM_TF_LAYERS, XLSTM_TF_PREFILL, XLSTM_TF_DECODE = 8, 500, 12
XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ, XLSTM_TRAIN_STEPS = 2, 512, 2   # the mesh xLSTM phase
ENCDEC_ARCH = "seamless-m4t-large-v2"
# the repo's prefill_32k cell feeds 32768 encoder frames; one card holds a
# batch of 4 of them (12.9 GB of cross memories), not the cell's 32
ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_NEW = 4, 32768, 512, 32
ENCDEC_TF_LAYERS, ENCDEC_TF_FRAMES = 4, 8192   # teacher forcing: 4 + 4 layers, float32
# training over 8192 frames: the encoder's self-attention and every
# cross-attention take the kernels' forward and backward
ENCDEC_TRAIN_FRAMES = 8192
# training through the kernels: h2o-danube3-4b at its published context
# (twice its window), recurrentgemma-2b's RG-LRU scan and its gradient
LONG_TRAIN_BATCH, LONG_TRAIN_SEQ, LONG_TRAIN_STEPS = 1, 8192, 2
LONG_F32_LAYERS = 4       # the float32 backward's path: danube cut to 4 layers in float32
# recurrentgemma-2b past its 4096-token dense limit: served at the repo's
# prefill_32k sequence (configs/shapes.py) with the batch cut from 32 to 4,
# as seamless's is; teacher forcing at 2 x 8192 on 4 layers, (rglru, rglru,
# local, rglru), in float32; trained at 1 x 8192
RG_LONG_BATCH, RG_LONG_PROMPT, RG_LONG_NEW = 4, 32768, 32
RG_TF_LAYERS, RG_TF_LEN, RG_TF_PREFILL = 4, 8192, 8160
RG_TRAIN_BATCH, RG_TRAIN_SEQ, RG_TRAIN_STEPS = 1, 8192, 2
# what the dry run's record of that step must leave free of the card's
# 79.18 GiB: at 1 x 7680 its 78.23 GiB left 0.95 and the first gradients ran
# out of memory; at 1 x 7168 its 75.54 left 3.64, and the second step ran out
# (6.84 GiB asked for, 6.95 GiB reserved by PyTorch but unallocated)
RG_TRAIN_HEADROOM_GIB = 4.0
# olmo-1b past its 4096-token dense limit, full causal attention at D = 128
# (16 heads over 16 kv heads, no window): served at the repo's prefill_32k
# sequence with the batch cut from 32 to 4, as recurrentgemma's is; teacher
# forcing at 2 x 8192 on 4 layers in float32; trained at 2 x 8192, or the
# longest multiple of 512 whose dry-run record leaves RG_TRAIN_HEADROOM_GIB free
OLMO_LONG_BATCH, OLMO_LONG_PROMPT, OLMO_LONG_NEW = 4, 32768, 32
OLMO_TF_LAYERS, OLMO_TF_LEN, OLMO_TF_PREFILL = 4, 8192, 8160
OLMO_TRAIN_BATCH, OLMO_TRAIN_SEQ, OLMO_TRAIN_STEPS = 2, 8192, 2
RG_PLAIN_RTOL = 1e-4            # loss and grad norm, kernel scan vs the plain scan
# loss and grad norm of one batch, the bf16 attention kernels vs the plain
# attention: the two round float32 sums of the same products to bf16 at the
# attention's output and gradients, one bf16 ulp apart at most per element
# (the kernels' own gate, 2^-7 |want|); a loss and a norm average such
# differences, so they are held to the same relative bound
RG_ATTN_RTOL = 2.0 ** -7
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
# The backward against its plain version, per gradient: float32 within
# 1e-4 x max|want|; bf16 gradients are one rounding of float32 sums taken
# in another order, within 2^-7 |want| + 1e-3 x max|want| per element.  The
# row log-sum-exp of either forward kernel against the plain one: float32
# sums of the same products in another order, within 1e-4.
FLASH_BWD_F32_REL = 1e-4
FLASH_BWD_BF16_REL, FLASH_BWD_BF16_FLOOR = 2.0 ** -7, 1e-3
FLASH_LSE_TOL = 1e-4
# The bf16 kernel's split path (key ranges merged in the same launch): its
# row lse against the plain one's, float32 sums of the same products over
# shorter ranges
FLASH_SPLIT_LSE_TOL = 1e-5
# bf16 cases of the kernel's configurations at a head width up to 64, each
# at the wrapper's own key split (B, Hq, Hkv, Tq, Tk, D, causal, window,
# softcap, q_offset): more than 64 rows (the producer/consumer kernel,
# 128-key tiles; a window, softcap, GQA, D = 48 and 16, Tq off the 128-row
# block, rows that see no key), and up to 64 rows (one warpgroup a block)
FLASH_D64_CASES = [
    (2, 8, 2, 300, 1500, 64, True, 100, None, 1200),
    (1, 4, 2, 200, 4200, 64, True, 64, 30.0, 4000),
    (1, 4, 1, 130, 300, 48, False, None, None, 0),
    (2, 4, 4, 129, 129, 64, False, 17, None, 0),
    (1, 4, 2, 300, 300, 64, True, None, None, -40),
    (1, 2, 2, 1000, 1000, 16, True, None, None, 0),
    (2, 4, 2, 64, 3000, 64, True, None, None, 2936),
]
# forced key splits (B, Hq, Hkv, Tq, Tk, D, causal, window, q_offset,
# softcap, ranges): a causal window with rows before the first key and
# ranges some rows see nothing of, a window past the last key (rows that
# see no key at all), one warpgroup's causal window, a decode step with a
# softcap, and GQA at D = 48 (the kernel splits keys at widths up to 64);
# then more ranges of 128 rows than the merge stages in shared memory (its
# path from L2), with a row block of 72 rows
FLASH_SPLIT_CASES = [
    (1, 4, 2, 1500, 1600, 64, True, 600, -20, None, 2),
    (1, 4, 2, 1200, 2048, 64, False, 1024, 2000, None, 3),
    (2, 4, 2, 37, 5000, 64, True, 3000, 4963, None, 4),
    (1, 4, 1, 1, 4100, 32, False, None, 0, 25.0, 8),
    (2, 8, 2, 200, 3000, 48, False, None, 0, None, 5),
    (1, 4, 2, 200, 4000, 64, False, None, 0, None, 6),
]
# bf16 forward cases at head widths up to 64 whose rows see 1024 keys or
# more (name, B, Hq, Hkv, Tq, Tk, D, mask and key ranges), each with k, v
# contiguous and strided: D = 64, 48 and 32, no mask over 1100 keys with Tq
# off the 128-row block, causal rows offset forward, a window of 1500 with
# GQA 4, a softcap, a window that the last rows' keys fall out of past Tk,
# and two forced splits, one whose ranges all hold 1024 keys or more and one
# whose first ranges hold fewer
FLASH_D64_LONG_CASES = [
    ("D 64 no mask over 1100 keys", 2, 4, 4, 130, 1100, 64, dict(causal=False, splits=1)),
    ("D 64 causal q_offset 950, G 1", 1, 4, 4, 200, 1150, 64,
     dict(causal=True, q_offset=950, splits=1)),
    ("D 48 window 1500, GQA 4", 1, 8, 2, 2500, 2500, 48, dict(causal=True, window=1500, splits=1)),
    ("D 32 softcap 20 q_offset 1000", 1, 8, 2, 300, 1300, 32,
     dict(causal=True, q_offset=1000, softcap=20.0, splits=1)),
    ("D 64 window 1200 past the last key", 1, 4, 2, 1500, 1300, 64,
     dict(causal=False, window=1200, splits=1)),
    ("D 64 2 ranges of 1024 keys or more", 1, 4, 2, 300, 2600, 64, dict(causal=False, splits=2)),
    ("D 64 4 ranges, 3 under 1024 keys", 1, 4, 2, 300, 2600, 64, dict(causal=False, splits=4)),
]
# bf16 forward cases at head widths up to 64 whose calls take blocks of
# 192 rows, three consumer warpgroups (``block_rows``: their waves hold
# fewer rows of an SM's time than 128-row blocks'), run as
# FLASH_D64_LONG_CASES (contiguous and strided, then under
# FLASH_D64_FWD_SCALES): no mask with the last block's third consumer past
# Tq, the last block cut inside its third consumer over fewer than 1024
# keys, GQA 4 with causal rows offset forward, D = 48 with a window and a
# softcap, a causal mask over twelve tiles (the ring wrapped), and two
# calls the wrapper splits (3 and 2 key ranges)
FLASH_D64_NC3_CASES = [
    ("192 rows, no mask, the third consumer past Tq", 4, 16, 16, 300, 1100, 64,
     dict(causal=False, splits=None)),
    ("192 rows, the last block cut at 360", 4, 16, 16, 360, 900, 64,
     dict(causal=False, splits=None)),
    ("192 rows, GQA 4 causal q_offset 900", 4, 16, 4, 384, 1284, 64,
     dict(causal=True, q_offset=900, splits=None)),
    ("192 rows, D 48 window 1100 softcap 20", 4, 16, 16, 384, 2000, 48,
     dict(causal=True, window=1100, q_offset=1616, softcap=20.0, splits=None)),
    ("192 rows, causal over 12 tiles", 4, 16, 4, 1536, 1536, 64, dict(causal=True, splits=None)),
    ("192 rows, split in 3", 1, 40, 40, 960, 1600, 64, dict(causal=False, splits=None)),
    ("192 rows, split in 2", 4, 16, 16, 513, 2048, 64, dict(causal=False, splits=None)),
]
# peaked scores (``peaked_inputs``: each query row a low-temperature
# multiple of a few keys of its kv head, so that its weight sits on them,
# as trained models' scores do), no mask over 2048 keys (name, B, Hq, Hkv,
# Tq, Tk, D): at D = 64 in 192-row blocks and in 128-row blocks, and at
# D = 128; each at temperatures 1 and 2 and 2 and 4 chosen keys
FLASH_PEAKED_CASES = [
    ("D 64, 192-row blocks", 4, 16, 16, 384, 2048, 64),
    ("D 64, 128-row blocks", 1, 4, 4, 512, 2048, 64),
    ("D 128", 1, 4, 4, 512, 2048, 128),
]
FLASH_PEAKED_DRAWS = [(1.0, 2), (1.0, 4), (2.0, 2), (2.0, 4)]
# bf16 backward cases at the edges of the kernel's configuration for head
# widths up to 64 (name, B, Hq, Hkv, Tq, Tk, D, mask), each with k, v
# contiguous and strided: Tq and Tk off the 64-row tile and the 128-row
# block, GQA, causal rows offset forward and back (rows before the first
# key: dq exactly 0), a window inside one tile, a softcap, one query row,
# D = 32; query tiles that wrap the dK/dV pass's ring of eight stages more
# than once (with the GQA group's loop, and at D = 48), and fewer tiles than
# stages
FLASH_BWD_D64_CASES = [
    ("no mask", 1, 4, 4, 200, 300, 64, dict(causal=False)),
    ("GQA 4", 1, 8, 2, 200, 300, 64, dict(causal=False)),
    ("causal q_offset 100", 1, 4, 2, 200, 300, 64, dict(causal=True, q_offset=100)),
    ("causal q_offset -40", 1, 4, 2, 200, 300, 64, dict(causal=True, q_offset=-40)),
    ("window 24", 1, 4, 2, 300, 300, 64, dict(causal=True, window=24)),
    ("softcap 20", 1, 4, 2, 200, 300, 64, dict(causal=True, q_offset=100, softcap=20.0)),
    ("one query row", 1, 8, 2, 1, 1000, 64, dict(causal=False)),
    ("D 32", 1, 4, 2, 200, 300, 32, dict(causal=True, q_offset=100)),
    ("GQA 4 causal, the ring wrapped", 1, 8, 2, 1100, 1100, 64, dict(causal=True)),
    ("D 48, the ring wrapped", 1, 4, 4, 700, 1300, 48, dict(causal=False)),
    ("fewer tiles than stages", 1, 4, 4, 64, 300, 64, dict(causal=False)),
]
# bf16 cases of the kernels for head widths 65-128 (name, B, Hq, Hkv, Tq,
# Tk, D, mask), forward and backward, each with k, v contiguous and strided:
# D = 72, 96, 120 and 128 (columns past D read as zeros), Tq and Tk off the
# 64- and 128-row tiles, GQA groups 1 and 4, causal rows offset forward and
# back (rows before the first key: zeros, dq exactly 0), windows inside and
# across tiles, softcaps, one query row; one case at 136, the first width of
# the next configuration; olmo-1b's plain causal MHA at D = 128 over nine
# 128-key tiles (row blocks walking 1 to 9 live tiles); and for the dK/dV
# pass's ring of four stages, fewer query tiles than stages, as many, and a
# ring that wraps many times under a GQA group of 4
FLASH_D128_CASES = [
    ("D 72 causal q_offset 100, G 1", 1, 4, 4, 200, 300, 72, dict(causal=True, q_offset=100)),
    ("D 96 window 24, G 4", 1, 8, 2, 300, 300, 96, dict(causal=True, window=24)),
    ("D 120 softcap 20", 1, 8, 2, 200, 300, 120, dict(causal=True, q_offset=100, softcap=20.0)),
    ("D 128 no mask", 2, 4, 4, 130, 333, 128, dict(causal=False)),
    ("D 120 causal q_offset -40", 1, 8, 2, 200, 300, 120, dict(causal=True, q_offset=-40)),
    ("D 128 window 100 softcap 30", 1, 8, 2, 321, 1500, 128,
     dict(causal=True, window=100, q_offset=1179, softcap=30.0)),
    ("D 96 one query row", 1, 8, 2, 1, 1000, 96, dict(causal=False)),
    ("D 136 causal q_offset 100", 1, 4, 2, 200, 300, 136, dict(causal=True, q_offset=100)),
    ("D 128 causal, G 1", 1, 4, 4, 1100, 1100, 128, dict(causal=True)),
    ("D 128 fewer query tiles than stages", 1, 4, 4, 128, 700, 128, dict(causal=False)),
    ("D 96 as many query tiles as stages", 1, 4, 4, 256, 300, 96, dict(causal=False)),
    ("D 120 GQA 4 causal, the ring wrapped", 1, 8, 2, 900, 900, 120, dict(causal=True)),
]
# bf16 forward cases at head widths 65-128 whose rows see 1024 keys or more
# (name, B, Hq, Hkv, Tq, Tk, D, mask), each with k, v contiguous and
# strided: D = 72, 96, 120 and 128, GQA groups 1 and 4, causal rows offset
# forward, a window, a softcap, no mask, and a window that the last rows'
# keys fall out of past Tk; 1024 keys (8 tiles), twelve tiles, and a ring
# wrapped many times under a GQA group of 4 with a window
FLASH_D128_LONG_CASES = [
    ("D 72 causal q_offset 950, G 1", 1, 4, 4, 200, 1150, 72, dict(causal=True, q_offset=950)),
    ("D 96 window 1500, G 4", 1, 8, 2, 2500, 2500, 96, dict(causal=True, window=1500)),
    ("D 120 softcap 20 q_offset 1000", 1, 8, 2, 300, 1300, 120,
     dict(causal=True, q_offset=1000, softcap=20.0)),
    ("D 128 no mask over 1100 keys", 2, 4, 4, 130, 1100, 128, dict(causal=False)),
    ("D 128 window 1200 past the last key", 1, 4, 2, 1500, 1300, 128,
     dict(causal=False, window=1200)),
    ("D 128 no mask over 1024 keys, the fewest tiles", 1, 4, 4, 130, 1024, 128,
     dict(causal=False)),
    ("D 128 softcap 30 over 1536 keys, 12 tiles", 1, 4, 2, 256, 1536, 128,
     dict(causal=True, q_offset=1280, softcap=30.0)),
    ("D 120 GQA 4 window 1100, the rings wrapped", 1, 8, 2, 2200, 2200, 120,
     dict(causal=True, window=1100)),
]
# input scales (q, k, v, do) under which the backward runs FLASH_D128_CASES'
# head widths 65-128 again (their products on fp16 copies, each times a
# power of two of its own): do at a mean loss's gradient size; q above
# fp16's largest value (65504) with k below its normal range (6.1e-5), the
# scores unchanged, and the other way round; v below fp16's normal range
FLASH_FP16_SCALES = {"do 2^-16": (1, 1, 1, 2.0 ** -16), "q 1e5, k 1e-5": (1e5, 1e-5, 1, 1),
                     "q 1e-5, k 1e5": (1e-5, 1e5, 1, 1), "v 1e-6": (1, 1, 1e-6, 1)}
# and those of q, k and v under which the forward runs them again (products
# of far-apart magnitudes)
FLASH_FWD_FP16_SCALES = {name: c[:3] for name, c in FLASH_FP16_SCALES.items() if c[:3] != (1, 1, 1)}
# and those under which the forward runs its cases at widths up to 64 again,
# with v far above fp16's largest value too: the output scales with v, so its limit
# there is 2^-7 |want| + 1e-4 in v's units (1e-4 of an output near 1e5 is
# under float32's resolution)
FLASH_D64_FWD_SCALES = {**FLASH_FWD_FP16_SCALES, "v 1e5": (1, 1, 1e5)}
# bf16 cases of the kernels for head widths 136-256 (name, B, Hq, Hkv, Tq,
# Tk, D, mask), forward and backward, each with k, v contiguous and strided:
# recurrentgemma's MQA (10 query heads over one kv head, D = 256) with a
# window inside a 64-key tile and with its own 2048 window past 4096 keys;
# D = 192, 200 and 224 (atoms past D zeroed, columns past D read as zeros),
# Tq and Tk off the 64- and 128-row tiles, groups 1, 3 (the forward's
# blocks of one head), 4 and 10 (two heads a block), causal rows offset
# forward and back (rows before the first key: zeros, dq exactly 0), a
# softcap, one query row
FLASH_D256_CASES = [
    ("D 256 MQA 10, window 100", 1, 10, 1, 300, 300, 256, dict(causal=True, window=100)),
    ("D 256 MQA 10, window 2048", 1, 10, 1, 4200, 4200, 256, dict(causal=True, window=2048)),
    ("D 256 no mask, GQA 4", 2, 8, 2, 130, 333, 256, dict(causal=False)),
    ("D 192 softcap 20", 1, 8, 2, 200, 300, 192, dict(causal=True, q_offset=100, softcap=20.0)),
    ("D 200 window 24 q_offset -40", 1, 4, 2, 300, 300, 200,
     dict(causal=True, window=24, q_offset=-40)),
    ("D 256 window 100 softcap 30", 1, 8, 2, 321, 1500, 256,
     dict(causal=True, window=100, q_offset=1179, softcap=30.0)),
    ("D 256 one query row", 1, 10, 1, 1, 1000, 256, dict(causal=False)),
    ("D 256 GQA 3 causal q_offset 100", 1, 6, 2, 200, 300, 256, dict(causal=True, q_offset=100)),
    ("D 224 no mask, G 1", 1, 4, 4, 130, 200, 224, dict(causal=False)),
]
# float32 backward cases at the edges of its tiles (name, B, Hq, Hkv, Tq,
# Tk, D, mask), each with k, v contiguous and strided (4-byte copies where
# a stride or D is off 16 bytes): D = 1 and 33 (columns past D zero), 256
# (32-key tiles) with a window and a softcap; a softcap on tiles every row
# sees whole (no mask, Tq and Tk multiples of 64: no mask test runs) and on
# a window whose edge falls inside a tile; GQA 4 with Tq and Tk off the
# tile; causal rows offset back (rows before the first key: dq exactly 0)
FLASH_BWD_F32_CASES = [
    ("D 1 causal", 1, 4, 2, 130, 150, 1, dict(causal=True, q_offset=20)),
    ("D 33 causal q_offset 100", 1, 4, 2, 200, 300, 33, dict(causal=True, q_offset=100)),
    ("D 256 window 40 softcap 25", 1, 4, 2, 100, 160, 256,
     dict(causal=True, window=40, q_offset=60, softcap=25.0)),
    ("interior softcap 20", 2, 4, 2, 128, 192, 64, dict(causal=False, softcap=20.0)),
    ("window edge 100 in a tile, softcap 30", 1, 8, 2, 321, 700, 120,
     dict(causal=True, window=100, q_offset=379, softcap=30.0)),
    ("GQA 4 no mask", 1, 8, 2, 77, 333, 120, dict(causal=False)),
    ("causal q_offset -40", 1, 4, 2, 200, 300, 128, dict(causal=True, q_offset=-40)),
]
# head widths at which the bf16 backward's block plan is held to the
# kernel's own; and those of the float32 backward's plan
BWD_BLOCK_WIDTHS = (8, 32, 64, 72, 96, 120, 128, 136, 256)
F32_BWD_BLOCK_WIDTHS = (8, 33, 64, 120, 128, 256)
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
            if any(w in line for w in ("registers", "spill", "entry function", "warning",
                                       "setmaxnreg")):
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


def attention_inputs(B, Hq, Hkv, Tq, Tk, D, dtype, seed, strided=False, scales=(1, 1, 1)):
    """q (B, Hq, Tq, D); k, v (B, Hkv, Tk, D), as views of (B, Tk, Hkv, D)
    tensors when ``strided`` (the layout a projection einsum hands over);
    standard normal times ``scales`` (q, k, v)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = (torch.randn((B, Hq, Tq, D), generator=g, device="cuda") * scales[0]).to(dtype)
    kv_shape = (B, Tk, Hkv, D) if strided else (B, Hkv, Tk, D)
    k = (torch.randn(kv_shape, generator=g, device="cuda") * scales[1]).to(dtype)
    v = (torch.randn(kv_shape, generator=g, device="cuda") * scales[2]).to(dtype)
    if strided:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    return q, k, v


def peaked_inputs(B, Hq, Hkv, Tq, Tk, D, temp, hits, seed):
    """bf16 q (B, Hq, Tq, D), k, v (B, Hkv, Tk, D): k and v standard normal,
    each query row ``temp`` times the sum of ``hits`` keys of its kv head
    drawn at random, so that its scores peak on them (a score of about
    ``temp`` sqrt(D) there against ``temp`` N(0, hits) elsewhere)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn((B, Hkv, Tk, D), generator=g, device="cuda")
    v = torch.randn((B, Hkv, Tk, D), generator=g, device="cuda")
    idx = torch.randint(0, Tk, (B, Hq, Tq * hits), generator=g, device="cuda")
    kq = k.repeat_interleave(Hq // Hkv, dim=1)
    q = torch.gather(kq, 2, idx[..., None].expand(-1, -1, -1, D)).unflatten(2, (Tq, hits))
    return (q.sum(3) * temp).bfloat16(), k.bfloat16(), v.bfloat16()


def flash_kernel(dtype):
    """The attention kernel ``ops.flash_attention`` runs for ``dtype``."""
    return flash_attention_sm90_cuda if dtype == torch.bfloat16 else flash_attention_cuda


def flash_bwd_kernel(dtype):
    """The attention backward kernel ``ops`` runs for ``dtype``."""
    return flash_attention_bwd_sm90_cuda if dtype == torch.bfloat16 else flash_attention_bwd_cuda


def held_to_plain(got, want, what, unit=1.0):
    """An attention output against its plain version's: the largest
    absolute difference and, for bf16, the largest share of the scaled
    limit ``FLASH_BF16_REL * |want| + FLASH_BF16_FLOOR`` (None for
    float32), raising past either limit; both absolute terms in units of
    ``unit`` (v's scale, where the output scales with it)."""
    if got.shape != want.shape or got.dtype != want.dtype or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: {got.shape} {got.dtype} vs {want.shape} {want.dtype}, "
                             f"finite {bool(torch.isfinite(got).all())}")
    diff = (got.float() - want.float()).abs() / unit
    err = float(diff.max())
    if not err <= FLASH_TOL[got.dtype]:
        raise AssertionError(f"{what}: max abs err {err:.3e} > {FLASH_TOL[got.dtype]}")
    if got.dtype != torch.bfloat16:
        return err, None
    share = float((diff / (FLASH_BF16_REL * want.float().abs() / unit + FLASH_BF16_FLOOR)).max())
    if not share <= 1.0:
        raise AssertionError(f"{what}: |got - want| reaches {share:.3f} x ({FLASH_BF16_REL:.3g} "
                             f"|want| + {FLASH_BF16_FLOOR})")
    return err, share


def flash_case(q, k, v, **kw):
    """``ops.flash_attention`` on the card (the dtype's kernel) against the
    plain version on the same inputs: ``held_to_plain``'s error and share."""
    got = ops.flash_attention(q, k, v, **kw)
    want = ref_flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    return held_to_plain(got, want, f"flash_attention {tuple(q.shape)} {q.dtype} {kw}")


def lse_held_to_plain(lse, want, what):
    """A row lse against the plain one: -inf exactly where the plain one's
    is, the rest within ``FLASH_SPLIT_LSE_TOL``; returns the largest
    difference."""
    dead = torch.isinf(want)
    if not torch.equal(torch.isneginf(lse), dead) or torch.isnan(lse).any():
        raise AssertionError(f"{what}: lse -inf at {int(torch.isneginf(lse).sum())} rows, the "
                             f"plain version's at {int(dead.sum())}")
    err = float((lse - want)[~dead].abs().max()) if bool((~dead).any()) else 0.0
    if not err <= FLASH_SPLIT_LSE_TOL:
        raise AssertionError(f"{what}: lse off by {err:.3e} > {FLASH_SPLIT_LSE_TOL}")
    return err


def sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


def split_case(q, k, v, splits=None, unit=1.0, **kw):
    """The bf16 kernel with ``splits`` key ranges (None: the wrapper's own
    choice) against the plain version: the output within the bf16 limit
    (in units of ``unit``, ``held_to_plain``), the lse by
    ``lse_held_to_plain``, rows that see no key exactly zero, two calls
    bit-equal, and one split launch a call when it splits (the merge runs
    in that launch).  Returns (max abs err, limit share, lse err, ranges)."""
    B, Hq, Tq, D = q.shape
    ranges = splits or split_count(B, Hq, Tq, k.shape[2], D, causal=kw["causal"],
                                   window=kw.get("window"), q_offset=kw.get("q_offset", 0),
                                   sm_count=sm_count())
    what = f"flash_attention_sm90 {tuple(q.shape)} kv {tuple(k.shape)} {kw}, {ranges} ranges"
    before = ops.split_launches()
    got, lse = flash_attention_sm90_cuda(q, k, v, return_lse=True, splits=splits, **kw)
    again, lse_again = flash_attention_sm90_cuda(q, k, v, return_lse=True, splits=splits, **kw)
    split_calls = ops.split_launches() - before
    want, want_lse = ref_flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    if split_calls != (2 if ranges > 1 else 0):
        raise AssertionError(f"{what}: {split_calls} split launches in two calls")
    if not (torch.equal(got, again) and torch.equal(lse, lse_again)):
        raise AssertionError(f"{what}: two calls differ")
    err, share = held_to_plain(got, want, what, unit)
    lse_err = lse_held_to_plain(lse, want_lse, what)
    dead = torch.isinf(want_lse)
    if bool(dead.any()) and bool(got[dead].any()):
        raise AssertionError(f"{what}: rows that see no key are not zero")
    return err, share, lse_err, ranges


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
    # bf16 at the edges of the configurations for head widths 65-128 and
    # 136-256 and on rows that see 1024 keys, then the 65-128 cases under
    # FLASH_FWD_FP16_SCALES (k and v contiguous and strided in turns)
    cases = FLASH_D128_CASES + FLASH_D256_CASES + FLASH_D128_LONG_CASES
    runs = [(name, case, False, (1, 1, 1), strided, 290 + i)
            for i, (name, *case) in enumerate(cases) for strided in (False, True)]
    runs += [(f"{name}, {scale_name}", case, True, scales, (i + j) % 2 == 1, 290 + i)
             for i, (name, *case) in enumerate(cases) if 64 < case[5] <= 128
             for j, (scale_name, scales) in enumerate(FLASH_FWD_FP16_SCALES.items())]
    for name, (B, Hq, Hkv, Tq, Tk, D, kw), scaled, scales, strided, seed in runs:
        q, k, v = attention_inputs(B, Hq, Hkv, Tq, Tk, D, torch.bfloat16, seed=seed,
                                   strided=strided, scales=scales)
        err, share = flash_case(q, k, v, **kw)
        # a scaled case's error is in its inputs' units: its share counts
        worst[torch.bfloat16] = worst[torch.bfloat16] if scaled else max(worst[torch.bfloat16],
                                                                          err)
        n, worst_share = n + 1, max(worst_share, share)
        log(f"  flash_attention_sm90 {name}: {tuple(q.shape)} kv {tuple(k.shape)} {kw} "
            f"strided={strided}: max abs err {err:.3e}, bf16 limit share {share:.3f}")
    # widths up to 64: the split path (key ranges merged in the same launch)
    # and blocks of 64, 128 and 192 rows: seamless's two cross-attentions at
    # the wrapper's own split, then FLASH_D64_LONG_CASES, FLASH_D64_NC3_CASES,
    # FLASH_D64_CASES (the wrapper's own split) and FLASH_SPLIT_CASES (forced
    # splits), each contiguous and strided, then under FLASH_D64_FWD_SCALES
    # (the layouts in turns); each call's launches by rows a block held to
    # block_rows
    worst_lse = 0.0
    cfg = get_config(ENCDEC_ARCH)
    d64 = [(f"seamless {name}", (qs[0], qs[1], ks[1], qs[2], ks[2], qs[3]), dict(causal=False),
            None) for name, qs, ks, _ in seamless_cases(cfg)[1:]]
    d64 += [(name, tuple(case[:6]), {k: x for k, x in case[6].items() if k != "splits"},
             case[6]["splits"]) for name, *case in FLASH_D64_LONG_CASES + FLASH_D64_NC3_CASES]
    nc3 = {name for name, *_ in FLASH_D64_NC3_CASES}
    d64 += [(f"D <= 64 case {i}", (B, Hq, Hkv, Tq, Tk, D),
             dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset), None)
            for i, (B, Hq, Hkv, Tq, Tk, D, causal, window, softcap, q_offset)
            in enumerate(FLASH_D64_CASES)]
    d64 += [(f"forced split {i}", (B, Hq, Hkv, Tq, Tk, D),
             dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset), ranges)
            for i, (B, Hq, Hkv, Tq, Tk, D, causal, window, q_offset, softcap, ranges)
            in enumerate(FLASH_SPLIT_CASES)]
    runs = [(case, "plain", strided, 254 + i) for i, case in enumerate(d64)
            for strided in ((False,) if case[0].startswith("seamless") else (False, True))]
    runs += [(case, scale, (i + j) % 2 == 1, 254 + i) for i, case in enumerate(d64)
             if not case[0].startswith("seamless") for j, scale in enumerate(FLASH_D64_FWD_SCALES)]
    d64_worst = {}
    for (name, (B, Hq, Hkv, Tq, Tk, D), kw, splits), scale, strided, seed in runs:
        scales = FLASH_D64_FWD_SCALES.get(scale, (1, 1, 1))
        q, k, v = attention_inputs(B, Hq, Hkv, Tq, Tk, D, torch.bfloat16, seed=seed,
                                   strided=strided, scales=scales)
        rows_before = ops.fwd_d64_launches()
        err, share, lse_err, ranges = split_case(q, k, v, splits=splits, unit=max(1.0, scales[2]),
                                                 **kw)
        rows = block_rows(B, Hq, Tq, D, sm_count())
        by_rows = {r: n - rows_before[r] for r, n in ops.fwd_d64_launches().items()}
        if by_rows != {r: 2 * (r == rows) for r in by_rows} or (name in nc3 and rows != 192):
            raise AssertionError(f"flash_attention_sm90 {name}: two calls launched {by_rows} by "
                                 f"rows a block, the wrapper plans {rows}")
        if name == "seamless cross decode" and ranges == 1:
            raise AssertionError(f"{name} {(B, Hq, Tq, D)}: the wrapper does not split its keys")
        blocks = -(-Tq // rows) * ranges
        # a scaled case's error is in its inputs' units: its share counts
        worst[torch.bfloat16] = max(worst[torch.bfloat16], err) if scale == "plain" \
            else worst[torch.bfloat16]
        n, worst_share, worst_lse = n + 1, max(worst_share, share), max(worst_lse, lse_err)
        by_scale = d64_worst.setdefault(name, [rows, blocks, {}])[2]
        by_scale[scale] = max(share, by_scale.get(scale, 0.0))
        log(f"  flash_attention_sm90 {name}, {scale}: {(B, Hq, Tq, D)} kv {(B, Hkv, Tk, D)} {kw} "
            f"strided={strided}, {rows} rows a block, {ranges} key ranges, {blocks} blocks: "
            f"max abs err {err:.3e}, bf16 limit share {share:.3f}, lse err {lse_err:.3e}, two "
            f"calls bit-equal")
        del q, k, v
        torch.cuda.empty_cache()
    for name, (rows, blocks, by_scale) in d64_worst.items():
        log(f"  flash_attention_sm90 at D <= 64, {name}: {blocks} blocks of {rows} rows (over "
            f"the key ranges); worst share of the limit "
            + ", ".join(f"{scale} {x:.3f}" for scale, x in by_scale.items()))
    # peaked scores, each draw's worst share of the limit
    for i, (name, B, Hq, Hkv, Tq, Tk, D) in enumerate(FLASH_PEAKED_CASES):
        shares = []
        for j, (temp, hits) in enumerate(FLASH_PEAKED_DRAWS):
            q, k, v = peaked_inputs(B, Hq, Hkv, Tq, Tk, D, temp, hits, seed=330 + 8 * i + j)
            got = flash_attention_sm90_cuda(q, k, v, causal=False)
            again = flash_attention_sm90_cuda(q, k, v, causal=False)
            want = ref_flash_attention(q, k, v, causal=False)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"flash_attention_sm90 peaked {name}: two calls differ")
            err, share = held_to_plain(got, want, f"flash_attention_sm90 peaked {name}, "
                                                  f"temperature {temp}, {hits} keys")
            shares.append(share)
            n, worst_share = n + 1, max(worst_share, share)
            worst[torch.bfloat16] = max(worst[torch.bfloat16], err)
        log(f"  flash_attention_sm90 peaked scores, {name}: {(B, Hq, Tq, D)} over {Tk} keys, "
            f"{block_rows(B, Hq, Tq, D, sm_count()) if D <= 64 else 128} rows a block, bf16 limit "
            f"share by (temperature, keys) "
            + ", ".join(f"{d} {x:.3f}" for d, x in zip(FLASH_PEAKED_DRAWS, shares)))
    state["flash_split_lse_err"] = worst_lse
    state["flash_err"] = worst
    state["flash_bf16_share"] = worst_share
    log(f"kernel vs plain: attention in {n} cases, flash_attention (float32) worst "
        f"{worst[torch.float32]:.3e} (tol {FLASH_TOL[torch.float32]}), "
        f"flash_attention_sm90 (bf16) worst "
        f"{worst[torch.bfloat16]:.3e} (tol {FLASH_TOL[torch.bfloat16]}) and "
        f"{worst_share:.3f} of {FLASH_BF16_REL:.3g} |want| + {FLASH_BF16_FLOOR}, split lse "
        f"within {worst_lse:.3e} (tol {FLASH_SPLIT_LSE_TOL})")


def flash_bwd_case(q, k, v, seed, do_scale=1.0, **kw):
    """The dtype's backward kernel (``flash_attention_bwd_sm90`` for bf16,
    ``flash_attention_bwd`` for float32) against the plain backward on the
    same q, k, v, o, lse and a seeded do (standard normal times
    ``do_scale``), o and lse from the dtype's forward
    kernel (``return_lse``), whose lse is held to the plain forward's.  Two
    calls must be bit-equal, and rows that see no key must get a dq of
    exactly 0.  Returns (largest absolute error over the three gradients,
    largest share of the per-gradient limit, lse error, the gradients)."""
    o, lse = flash_kernel(q.dtype)(q, k, v, return_lse=True, **kw)
    _, lse_want = ref_flash_attention(q, k, v, return_lse=True, **kw)
    g = torch.Generator(device="cuda").manual_seed(seed)
    do = (torch.randn(q.shape, generator=g, device="cuda") * do_scale).to(q.dtype)
    kernel = flash_bwd_kernel(q.dtype)
    got = kernel(q, k, v, o, lse, do, **kw)
    again = kernel(q, k, v, o, lse, do, **kw)
    want = ref_flash_attention_backward(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    what = f"{kernel.__name__} {tuple(q.shape)} kv {tuple(k.shape)} {q.dtype} {kw}"
    dead = torch.isinf(lse_want)
    if not torch.equal(torch.isinf(lse), dead) or bool((lse[dead] > 0).any()):
        raise AssertionError(f"{what}: lse's -inf rows differ from the plain version's")
    lse_err = float((lse[~dead] - lse_want[~dead]).abs().max()) if bool((~dead).any()) else 0.0
    if not lse_err <= FLASH_LSE_TOL:
        raise AssertionError(f"{what}: lse max abs err {lse_err:.3e} > {FLASH_LSE_TOL}")
    if bool(dead.any()) and bool(got[0][dead].any()):
        raise AssertionError(f"{what}: the dq of rows that see no key is not exactly 0")
    err, share = 0.0, 0.0
    for name, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
        if a.shape != w.shape or a.dtype != w.dtype or not torch.isfinite(a).all():
            raise AssertionError(f"{what}: {name} {a.shape} {a.dtype} vs {w.shape} {w.dtype}, "
                                 f"finite {bool(torch.isfinite(a).all())}")
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs between two calls")
        diff, wf = (a.float() - w.float()).abs(), w.float().abs()
        top = float(wf.max())
        if q.dtype == torch.bfloat16:
            s = float((diff / (FLASH_BWD_BF16_REL * wf + FLASH_BWD_BF16_FLOOR * top)).max()) \
                if top > 0 else float(diff.max() > 0)
        else:
            s = float(diff.max()) / (FLASH_BWD_F32_REL * top) if top > 0 else float(diff.max() > 0)
        if not s <= 1.0:
            raise AssertionError(f"{what}: {name} reaches {s:.3f} of its limit "
                                 f"(max abs err {float(diff.max()):.3e}, max |want| {top:.3e})")
        err, share = max(err, float(diff.max())), max(share, s)
    return err, share, lse_err, got


def train_attention_shapes():
    """(name, q shape, k/v shape, mask) of the attention calls of the
    training phases: danube's self-attention at 1 x 8192 (causal, window
    4096), seamless's encoder self-attention at 2 x 8192 frames and its
    cross-attention of 2 x 2048 tokens over them (no mask),
    recurrentgemma's local attention at 1 x 8192 (10 query heads over one kv
    head of 256, causal, window 2048) and olmo-1b's at 2 x 8192 (16 heads of
    128, plain causal)."""
    dn, sm, rg = get_config(LONG_ARCH), get_config(ENCDEC_ARCH), get_config(ARCH)
    om = get_config(TRAIN_ARCH)
    kv = (TRAIN_BATCH, sm.n_kv_heads, ENCDEC_TRAIN_FRAMES, sm.head_dim)
    return [("danube", (LONG_TRAIN_BATCH, dn.n_heads, LONG_TRAIN_SEQ, dn.head_dim),
             (LONG_TRAIN_BATCH, dn.n_kv_heads, LONG_TRAIN_SEQ, dn.head_dim),
             dict(causal=True, window=dn.window)),
            ("seamless encoder", (kv[0], sm.n_heads, ENCDEC_TRAIN_FRAMES, sm.head_dim), kv,
             dict(causal=False)),
            ("seamless cross", (kv[0], sm.n_heads, TRAIN_SEQ, sm.head_dim), kv,
             dict(causal=False)),
            ("recurrentgemma", (RG_TRAIN_BATCH, rg.n_heads, RG_TRAIN_SEQ, rg.head_dim),
             (RG_TRAIN_BATCH, rg.n_kv_heads, RG_TRAIN_SEQ, rg.head_dim),
             dict(causal=True, window=rg.window)),
            ("olmo", (OLMO_TRAIN_BATCH, om.n_heads, OLMO_TRAIN_SEQ, om.head_dim),
             (OLMO_TRAIN_BATCH, om.n_kv_heads, OLMO_TRAIN_SEQ, om.head_dim),
             dict(causal=True))]


SPLIT_RANKS = 4          # danube's 1 x 8192 sequence split over a 4-way "data" axis


def split_sequence_cases():
    """(q offset, q shape, k/v shape, mask) of each rank's local attention
    in danube's 1 x 8192 step with its sequence split over ``SPLIT_RANKS``
    ranks (``tp_fsdp_sp``, ``layers._local_attention``): the rank's q rows,
    offset by their first position, over all 8192 keys, so that the causal
    mask hides keys after the rows and the window keys before them."""
    dn = get_config(LONG_ARCH)
    rows = LONG_TRAIN_SEQ // SPLIT_RANKS
    return [(r * rows, (LONG_TRAIN_BATCH, dn.n_heads, rows, dn.head_dim),
             (LONG_TRAIN_BATCH, dn.n_kv_heads, LONG_TRAIN_SEQ, dn.head_dim),
             dict(causal=True, window=dn.window, q_offset=r * rows))
            for r in range(SPLIT_RANKS)]


def phase_flash_bwd_vs_plain(state):
    """The backward kernel and both forward kernels' lse against their
    plain versions over the forward's sweep (both dtypes, both layouts),
    the training shapes and each rank's local shard of danube's step over
    a sequence split four ways (the forward's output too); then the scan's
    gradient through the custom op against autograd through the plain
    loop."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    share_by = {torch.float32: 0.0, torch.bfloat16: 0.0}   # the largest share of the limit
    worst_lse, n = 0.0, 0

    def record(dt, err, share, lse_err, what=None, scaled=False):
        # a scaled case's error is in its inputs' units: its share counts, its
        # absolute error does not enter the dtype's worst
        nonlocal worst_lse, n
        worst[dt], n = (worst[dt] if scaled else max(worst[dt], err)), n + 1
        share_by[dt], worst_lse = max(share_by[dt], share), max(worst_lse, lse_err)
        if what is not None:
            log(f"  {flash_bwd_kernel(dt).__name__} {what} {dt}: max abs err {err:.3e}, "
                f"{share:.3f} of the limit")

    for i, (B, Hq, Hkv, Tq, Tk, D, causal, window, softcap, dtype) in enumerate(FLASH_CASES):
        for dt in (dtype,) if dtype == torch.bfloat16 else (dtype, torch.bfloat16):
            for strided in (False, True):
                q, k, v = attention_inputs(B, Hq, Hkv, Tq, Tk, D, dt, seed=300 + i,
                                           strided=strided)
                kw = dict(causal=causal, window=window, softcap=softcap,
                          q_offset=Tk - Tq if causal else 0)
                record(dt, *flash_bwd_case(q, k, v, seed=400 + i, **kw)[:3],
                       what=f"{tuple(q.shape)} kv {tuple(k.shape)} {kw} strided={strided}")
    for i, (B, Hq, Hkv, Tq, Tk, D, causal, window, softcap) in enumerate(FLASH_F32_CASES):
        for strided in (False, True):
            q, k, v = attention_inputs(B, Hq, Hkv, Tq, Tk, D, torch.float32, seed=360 + i,
                                       strided=strided)
            kw = dict(causal=causal, window=window, softcap=softcap,
                      q_offset=Tk - Tq if causal else 0)
            record(torch.float32, *flash_bwd_case(q, k, v, seed=460 + i, **kw)[:3])
    # rows before the first key (q_offset < 0) see nothing: their dq is exactly 0
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = attention_inputs(1, 4, 2, 100, 100, 120, dt, seed=350)
        err, share, lse_err, (dq, _, _) = flash_bwd_case(q, k, v, seed=450, causal=True,
                                                         q_offset=-40)
        record(dt, err, share, lse_err, what="(1, 4, 100, 120) q_offset -40")
        if not torch.equal(dq[:, :, :40], torch.zeros_like(dq[:, :, :40])):
            raise AssertionError(f"{dt}: the dq of fully masked rows is not zero")
    # bf16 at the edges of the configuration for head widths up to 64
    for i, (name, B, Hq, Hkv, Tq, Tk, D, kw) in enumerate(FLASH_BWD_D64_CASES):
        for strided in (False, True):
            q, k, v = attention_inputs(B, Hq, Hkv, Tq, Tk, D, torch.bfloat16, seed=380 + i,
                                       strided=strided)
            record(torch.bfloat16, *flash_bwd_case(q, k, v, seed=480 + i, **kw)[:3],
                   what=f"D <= 64, {name}: {tuple(q.shape)} kv {tuple(k.shape)} {kw} "
                        f"strided={strided}")
    # bf16 at the edges of the configurations for head widths 65-128 and 136-256
    for i, (name, B, Hq, Hkv, Tq, Tk, D, kw) in enumerate(FLASH_D128_CASES + FLASH_D256_CASES):
        for strided in (False, True):
            q, k, v = attention_inputs(B, Hq, Hkv, Tq, Tk, D, torch.bfloat16, seed=390 + i,
                                       strided=strided)
            record(torch.bfloat16, *flash_bwd_case(q, k, v, seed=490 + i, **kw)[:3],
                   what=f"{name}: {tuple(q.shape)} kv {tuple(k.shape)} {kw} strided={strided}")
    # bf16 up to 64 and at 65-128 again under FLASH_FP16_SCALES' input
    # scales, k and v contiguous and strided in turns
    scaled_cases = [(name, case, 380 + i, 480 + i) for i, (name, *case) in
                    enumerate(FLASH_BWD_D64_CASES)]
    scaled_cases += [(name, case, 390 + i, 490 + i) for i, (name, *case) in
                     enumerate(FLASH_D128_CASES)]
    for i, (name, (B, Hq, Hkv, Tq, Tk, D, kw), seed, do_seed) in enumerate(scaled_cases):
        if not converts_to_fp16(D):
            continue
        for j, (scale_name, (cq, ck, cv, cdo)) in enumerate(FLASH_FP16_SCALES.items()):
            strided = (i + j) % 2 == 1
            q, k, v = attention_inputs(B, Hq, Hkv, Tq, Tk, D, torch.bfloat16, seed=seed,
                                       strided=strided, scales=(cq, ck, cv))
            record(torch.bfloat16, *flash_bwd_case(q, k, v, seed=do_seed, do_scale=cdo,
                                                   **kw)[:3],
                   what=f"{name}, {scale_name}: {tuple(q.shape)} kv {tuple(k.shape)} {kw} "
                        f"strided={strided}", scaled=True)
    # float32 at the edges of the float32 backward's tiles
    for i, (name, B, Hq, Hkv, Tq, Tk, D, kw) in enumerate(FLASH_BWD_F32_CASES):
        for strided in (False, True):
            q, k, v = attention_inputs(B, Hq, Hkv, Tq, Tk, D, torch.float32, seed=600 + i,
                                       strided=strided)
            record(torch.float32, *flash_bwd_case(q, k, v, seed=620 + i, **kw)[:3],
                   what=f"{name}: {tuple(q.shape)} kv {tuple(k.shape)} {kw} strided={strided}")
    for D in BWD_BLOCK_WIDTHS:
        if kernel_blocks(D) != block_config(D):
            raise AssertionError(f"flash_attention_bwd_sm90 at D = {D}: the kernel runs "
                                 f"{kernel_blocks(D)}, the wrapper plans {block_config(D)}")
    log(f"  flash_attention_bwd_sm90's blocks as planned at D in {BWD_BLOCK_WIDTHS}: "
        + "; ".join(f"{D}: {tuple(block_config(D))}" for D in BWD_BLOCK_WIDTHS))
    for D in F32_BWD_BLOCK_WIDTHS:
        if fa_bwd_f32.kernel_blocks(D) != fa_bwd_f32.block_config(D):
            raise AssertionError(f"flash_attention_bwd at D = {D}: the kernel runs "
                                 f"{fa_bwd_f32.kernel_blocks(D)}, the wrapper plans "
                                 f"{fa_bwd_f32.block_config(D)}")
    log(f"  flash_attention_bwd's blocks as planned at D in {F32_BWD_BLOCK_WIDTHS}: "
        + "; ".join(f"{D}: {tuple(fa_bwd_f32.block_config(D))}" for D in F32_BWD_BLOCK_WIDTHS))
    log(f"  backward sweep: {n} cases")
    # the training phases' shapes, in both dtypes, k and v strided as the
    # projection hands them over
    for name, qs, ks, kw in train_attention_shapes():
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = attention_inputs(qs[0], qs[1], ks[1], qs[2], ks[2], qs[3], dt, seed=353,
                                       strided=True)
            err, share, lse_err, _ = flash_bwd_case(q, k, v, seed=453, **kw)
            record(dt, err, share, lse_err)
            log(f"  {flash_bwd_kernel(dt).__name__} {name} q {qs} kv {ks} {dt} {kw}: max abs err "
                f"{err:.3e}, {share:.3f} of the limit, lse err {lse_err:.3e}")
            del q, k, v
            torch.cuda.empty_cache()
    # each rank's local shard of danube's step over a split sequence: the
    # forward kernel (o against the plain version too), its lse and the
    # backward at the rank's q offset
    for r, (off, qs, ks, kw) in enumerate(split_sequence_cases()):
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = attention_inputs(qs[0], qs[1], ks[1], qs[2], ks[2], qs[3], dt,
                                       seed=354 + r, strided=True)
            ferr, _ = flash_case(q, k, v, **kw)
            fwd_err = state.setdefault("flash_err", {torch.float32: 0.0, torch.bfloat16: 0.0})
            fwd_err[dt] = max(fwd_err[dt], ferr)
            err, share, lse_err, _ = flash_bwd_case(q, k, v, seed=454 + r, **kw)
            record(dt, err, share, lse_err)
            log(f"  {flash_kernel(dt).__name__} and {flash_bwd_kernel(dt).__name__} danube rank "
                f"{r} of {SPLIT_RANKS} (q rows from {off}) q {qs} kv {ks} {dt}: forward max abs "
                f"err {ferr:.3e}; backward {err:.3e}, {share:.3f} of the limit, lse err "
                f"{lse_err:.3e}")
            del q, k, v
            torch.cuda.empty_cache()
    state["flash_bwd_err"] = worst
    state["flash_bwd_share"] = share_by
    log(f"kernel vs plain: attention backward in {n} cases, float32 (flash_attention_bwd) worst "
        f"{worst[torch.float32]:.3e} and {share_by[torch.float32]:.3f} of its limit "
        f"({FLASH_BWD_F32_REL} max|want|), bf16 (flash_attention_bwd_sm90) worst "
        f"{worst[torch.bfloat16]:.3e} and {share_by[torch.bfloat16]:.3f} of its limit "
        f"({FLASH_BWD_BF16_REL:.3g} |want| + {FLASH_BWD_BF16_FLOOR} max|want|); lse worst "
        f"{worst_lse:.3e} (tol {FLASH_LSE_TOL}); two calls bit-equal everywhere")

    # the scan's gradient: the custom op (the reversed CUDA scan) against
    # autograd through the plain loop
    scan_worst = 0.0
    for shape in scan_shapes(state["cfg"]):
        a, x = scan_inputs(shape, seed=110)
        w = torch.randn(shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(111))
        a.requires_grad_()
        x.requires_grad_()
        before = linear_scan_launches()
        h = ops.linear_scan(a, x)
        got = torch.autograd.grad((h * w).sum(), (a, x))
        if linear_scan_launches() - before != 2:
            raise AssertionError(f"linear_scan {shape} under autograd launched "
                                 f"{linear_scan_launches() - before} times, expected 2")
        want = torch.autograd.grad((ref_linear_scan(a, x) * w).sum(), (a, x))
        torch.cuda.synchronize()
        for name, g, ww in zip(("da", "dx"), got, want):
            torch.testing.assert_close(g, ww, rtol=SCAN_TOL, atol=SCAN_TOL)
            err = float((g - ww).abs().max())
            scan_worst = max(scan_worst, err)
            log(f"  linear_scan gradient {shape} {name}: max abs err {err:.3e}")
        del a, x, w, h, got, want
        torch.cuda.empty_cache()
    state["scan_grad_err"] = scan_worst
    log(f"kernel vs plain: linear_scan's gradient within rtol=atol={SCAN_TOL} "
        f"(worst {scan_worst:.3e})")


def linear_scan_launches() -> int:
    return ops.launch_counts()["linear_scan"]


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
        prefill_logits = logits.float()
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
    state["serve_ref"] = {"logits": prefill_logits, "outs": outs}
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


def phase_mesh_serve_rg(state):
    """Full-width recurrentgemma-2b under ``tp_serve_hd``: ``generate`` on
    the serve phase's model and prompts through the mesh (18 ``linear_scan``
    launches, all in the prefill, on local shards), its new tokens against
    that phase's; then the mesh prefill's logits against that phase's."""
    cfg = state["cfg"]
    n_rglru = sum(1 for i in range(cfg.n_layers)
                  if cfg.block_pattern[i % len(cfg.block_pattern)] == "rglru")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))   # the serve phase's
    prompts = prompts_for(seed=1)
    ref = state.pop("serve_ref")
    max_len = PROMPT_LEN + MAX_NEW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # -- the main path: counts at 0 just before, read just after
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = generate(model, params, prompts, max_new=MAX_NEW, max_len=max_len, device="cuda",
                    mesh=state["mesh"], strategy="tp_serve_hd")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if counts["linear_scan"] != n_rglru:
        raise AssertionError(f"generate under tp_serve_hd launched {counts}, expected "
                             f"{n_rglru} linear_scan (the prefill)")
    got, want = np.stack(outs)[:, PROMPT_LEN:], np.stack(ref["outs"])[:, PROMPT_LEN:]
    if got.shape != want.shape or not ((got >= 0) & (got < cfg.vocab_size)).all():
        raise AssertionError(f"bad new tokens {got.shape}")
    same = float((got == want).mean())
    # the prefill alone, through the builder's step, timed (median of 3)
    builder = TrainStepBuilder(model, state["mesh"], strategy="tp_serve_hd")
    dparams = builder.distribute(params, builder.param_shardings(params), src_data_rank=None)
    tokens = torch.as_tensor(np.stack(prompts).astype(np.int64), device="cuda")
    prefill_ms = []
    for _ in range(3):
        cache = builder.shard_cache(model.init_cache(BATCH, max_len, device="cuda"))
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = builder.prefill_step_fn()(dparams, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        if ops.launch_counts()["linear_scan"] != n_rglru:
            raise AssertionError(f"the mesh prefill launched {ops.launch_counts()}")
    dlogit = float((logits.float() - ref["logits"]).abs().max())
    if not (bool(torch.isfinite(logits).all()) and dlogit <= MESH_ENCDEC_DLOGIT):
        raise AssertionError(f"mesh prefill logits: max |dlogit| {dlogit:.3e} vs no mesh")
    state["mesh_serve_rg"] = {"generate_s": wall, "prefill_ms": sorted(prefill_ms)[1],
                              "prefill_runs_ms": prefill_ms, "max_dlogit": dlogit,
                              "new_tokens_same": same, "peak_gib": peak,
                              "no_mesh_prefill_ms": state["serve"]["prefill_ms"],
                              "no_mesh_generate_s": state["serve"]["generate_first_call_s"]}
    state["mesh_serve_rg_launches"] = counts["linear_scan"]
    r = state["mesh_serve_rg"]
    log(f"mesh recurrentgemma serve: {cfg.name} generate(mesh, tp_serve_hd), {BATCH}x"
        f"{PROMPT_LEN} + {MAX_NEW} new tokens in {wall:.2f} s (no mesh, first call "
        f"{r['no_mesh_generate_s']:.2f} s), launches {counts}; new tokens equal to the no-mesh "
        f"run's {same:.4f}; prefill {r['prefill_ms']:.2f} ms (median of 3: "
        f"{', '.join(f'{m:.2f}' for m in prefill_ms)}; no mesh {r['no_mesh_prefill_ms']:.2f}), "
        f"{n_rglru} linear_scan launches each, max |dlogit| vs no mesh {dlogit:.3e}; peak "
        f"{peak:.2f} GiB; on {state['smi']}")
    del params, dparams, cache, logits
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


def serve_long_path(state, cfg, batch, prompt, new, seed, want, what):
    """``generate`` on ``batch`` x ``prompt``-token prompts + ``new`` tokens of
    ``cfg`` at full width, bf16 weights from ``seed``: the main path's launch
    counts (at 0 just before, read just after) must be ``want`` in the
    prefill and none in decode, which runs over the cache (``_cache_attention``,
    a window's slots or all ``prompt + new``); then the
    prefill timed warm (median of 3) and the decode steps, teacher-forced
    on their own greedy tokens.  Returns (generate's launches, its outputs,
    the prefill's and each decode step's logits with the tokens fed, the
    phase's record)."""
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"{what}: {cfg.name} {cfg.n_layers} layers ({', '.join(cfg.block_pattern)}, window "
        f"{cfg.window}), d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B params")
    prompts = prompts_for(seed=seed + 1, batch=batch, length=prompt)
    max_len = prompt + new

    # -- the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = generate(model, params, prompts, max_new=new, max_len=max_len, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  generate: {batch}x{prompt} prompt + {new} new tokens in {wall:.3f} s (first call); "
        f"launches {counts}")
    expect_launches(counts, want, f"{what}: generate (bf16: the attention kernel once a "
                                  f"local layer, in the prefill)")
    for p, o in zip(prompts, outs):
        if o.shape != (prompt + new,) or not np.array_equal(o[:prompt], p):
            raise AssertionError(f"bad output shape {o.shape} or prompt not preserved")
        if not ((o >= 0) & (o < cfg.vocab_size)).all():
            raise AssertionError("token outside the vocabulary")

    # -- timings through the same entry points, warm
    tokens = torch.as_tensor(np.stack(prompts).astype(np.int64), device="cuda")
    with torch.inference_mode():
        prefill_ms = []
        for _ in range(3):
            cache = model.init_cache(batch, max_len, device="cuda")
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, {"tokens": tokens}, cache)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
            expect_launches(ops.launch_counts(), want, f"{what}: prefill")
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite prefill logits")
        tok = torch.argmax(logits, dim=-1)
        finite = torch.ones((), dtype=torch.bool, device="cuda")
        ref = {"logits": [logits], "fed": []}
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(new):   # no host sync inside the loop, as in generate
            ref["fed"].append(tok)
            logits, cache = model.decode_step(params, tok, prompt + i, cache)
            ref["logits"].append(logits)
            finite &= torch.isfinite(logits).all()
            tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        if not bool(finite):
            raise AssertionError("non-finite decode logits")
        expect_launches(ops.launch_counts(), {}, f"{what}: decode over the cache")
    rec = {
        "prefill_ms": sorted(prefill_ms)[1],
        "decode_tok_s": batch * new / decode_s,
        "decode_ms_per_step": decode_s * 1e3 / new,
        "peak_gib": peak / 2**30,
        "generate_first_call_s": wall,
        "launches": counts,
    }
    log(f"  prefill {batch}x{prompt}: {rec['prefill_ms']:.2f} ms (median of 3: "
        f"{', '.join(f'{m:.2f}' for m in prefill_ms)}); decode {rec['decode_tok_s']:.1f} tok/s "
        f"({rec['decode_ms_per_step']:.2f} ms/step, batch {batch}, cache of "
        f"{cfg.window or max_len} slots); peak memory {rec['peak_gib']:.2f} GiB; on {state['smi']}")
    del params, model, cache, logits
    torch.cuda.empty_cache()
    return counts, outs, ref, rec


def phase_serve_long(state):
    """Full-width h2o-danube3-4b at 4 x 8192 + 32: every layer's attention
    through ``flash_attention_sm90`` in the prefill."""
    cfg = get_config(LONG_ARCH)
    counts, outs, ref, rec = serve_long_path(
        state, cfg, LONG_BATCH, LONG_PROMPT, LONG_NEW, seed=3,
        want={"flash_attention_sm90": cfg.n_layers}, what="long serve")
    state["long_launches"] = counts
    state["long_outs"] = outs        # the mesh generate phase's reference
    state["long_ref"] = ref          # the mesh serve phase is teacher-forced on these
    state["serve_long"] = rec


def attention_layers(cfg, kind):
    """The layers of ``kind`` in ``cfg``'s pattern, repeated over its depth."""
    return sum(1 for i in range(cfg.n_layers)
               if cfg.block_pattern[i % len(cfg.block_pattern)] == kind)


def phase_serve_long_rg(state):
    """Full-width recurrentgemma-2b at 4 x 32768 + 32: each local layer's
    attention (10 query heads of 256 over one kv head, window 2048) through
    ``flash_attention_sm90`` once in the prefill, each RG-LRU's scan through
    ``linear_scan``; decode over the 2048-slot window cache launches none."""
    cfg = state["cfg"]
    counts, _, _, rec = serve_long_path(
        state, cfg, RG_LONG_BATCH, RG_LONG_PROMPT, RG_LONG_NEW, seed=70,
        want={"flash_attention_sm90": attention_layers(cfg, "local"),
              "linear_scan": attention_layers(cfg, "rglru")},
        what="recurrentgemma long serve")
    state["serve_long_rg"] = rec


def phase_serve_long_olmo(state):
    """Full-width olmo-1b at 4 x 32768 + 32: every layer's attention (16
    heads of 128, MHA, plain causal, no window) through
    ``flash_attention_sm90`` once in the prefill; decode over the
    32800-slot cache launches none."""
    cfg = get_config(TRAIN_ARCH)
    counts, _, _, rec = serve_long_path(
        state, cfg, OLMO_LONG_BATCH, OLMO_LONG_PROMPT, OLMO_LONG_NEW, seed=80,
        want={"flash_attention_sm90": attention_layers(cfg, "attn")},
        what="olmo long serve")
    state["serve_long_olmo"] = rec


def teacher_forcing_path(cfg, B, T, T0, seed, what):
    """``cfg`` (float32) prefilled on T0 tokens of a seeded batch and decoded
    on the rest, each step's logits against one forward over all T: the
    largest |dlogit| and the launch counts of the forward, the prefill and
    the decode steps."""
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g, device="cuda")
    with torch.inference_mode():
        ops.reset_launch_counts()
        x = params["embed"]["table"][toks]
        h = LM.apply_stack_train(params, cfg, x, torch.arange(T, device="cuda"))[0]
        full = LM._logits(params, cfg, h[:, T0 - 1:])      # positions T0-1 .. T-1
        del x, h
        fwd = ops.launch_counts()
        cache = model.init_cache(B, T + 4, device="cuda")
        ops.reset_launch_counts()
        lg, cache = model.prefill(params, {"tokens": toks[:, :T0]}, cache)
        pre = ops.launch_counts()
        errs = [float((lg - full[:, 0]).abs().max())]
        ops.reset_launch_counts()
        for t in range(T0, T):
            lg, cache = model.decode_step(params, toks[:, t], t, cache)
            errs.append(float((lg - full[:, t - T0 + 1]).abs().max()))
        dec = ops.launch_counts()
    log(f"{what}: {cfg.name} {cfg.n_layers} layers ({', '.join(cfg.block_pattern)}), d_model "
        f"{cfg.d_model}, float32, prefill {T0} + {T - T0} decode steps vs one forward over {T}: "
        f"max |dlogit| {max(errs):.3e} (tol {TEACHER_TOL}); launches: forward {fwd}, prefill "
        f"{pre}, decode {dec}")
    if not max(errs) < TEACHER_TOL:
        raise AssertionError(f"decode disagrees with the full forward: {errs}")
    del params, model, cache, full
    torch.cuda.empty_cache()
    return max(errs), fwd, pre, dec


def phase_teacher_forcing_long(state):
    """h2o-danube3-4b cut to 4 layers in float32 at 2 x 8192: every layer's
    attention through the float32 ``flash_attention`` in the forward and
    the prefill, none in decode."""
    cfg = dataclasses.replace(get_config(LONG_ARCH), n_layers=4, dtype="float32")
    err, fwd, pre, dec = teacher_forcing_path(cfg, 2, LONG_PROMPT, LONG_TF_PREFILL, seed=5,
                                              what="long teacher forcing")
    for counts, where in ((fwd, "forward"), (pre, "prefill")):
        expect_launches(counts, {"flash_attention": cfg.n_layers}, f"long teacher forcing {where}")
    expect_launches(dec, {}, "long teacher forcing decode")
    state["teacher_long_err"] = err
    state["long_tf_launches"] = fwd["flash_attention"] + pre["flash_attention"]


def phase_teacher_forcing_long_rg(state):
    """recurrentgemma-2b cut to (rglru, rglru, local, rglru) in float32 at
    2 x 8192: the local layer's attention (D = 256, MQA, window 2048)
    through the float32 ``flash_attention`` in the forward and the prefill,
    the RG-LRUs' scans through ``linear_scan``, none in decode."""
    cfg = dataclasses.replace(state["cfg"], n_layers=RG_TF_LAYERS, dtype="float32")
    err, fwd, pre, dec = teacher_forcing_path(cfg, 2, RG_TF_LEN, RG_TF_PREFILL, seed=72,
                                              what="recurrentgemma long teacher forcing")
    want = {"flash_attention": attention_layers(cfg, "local"),
            "linear_scan": attention_layers(cfg, "rglru")}
    for counts, where in ((fwd, "forward"), (pre, "prefill")):
        expect_launches(counts, want, f"recurrentgemma long teacher forcing {where}")
    expect_launches(dec, {}, "recurrentgemma long teacher forcing decode")
    state["teacher_long_rg_err"] = err
    state["rg_tf_launches"] = fwd["flash_attention"] + pre["flash_attention"]


def phase_teacher_forcing_long_olmo(state):
    """olmo-1b cut to 4 layers in float32 at 2 x 8192: every layer's
    attention (D = 128, plain causal) through the float32 ``flash_attention``
    in the forward and the prefill, none in decode."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=OLMO_TF_LAYERS, dtype="float32")
    err, fwd, pre, dec = teacher_forcing_path(cfg, 2, OLMO_TF_LEN, OLMO_TF_PREFILL, seed=82,
                                              what="olmo long teacher forcing")
    for counts, where in ((fwd, "forward"), (pre, "prefill")):
        expect_launches(counts, {"flash_attention": cfg.n_layers},
                        f"olmo long teacher forcing {where}")
    expect_launches(dec, {}, "olmo long teacher forcing decode")
    state["teacher_long_olmo_err"] = err
    state["olmo_tf_launches"] = fwd["flash_attention"] + pre["flash_attention"]


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


SDPA_CAUSAL_BACKENDS = ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa_causal_ms(q, k, v, do=None, reps=3):
    """Device ms of ``scaled_dot_product_attention(q, k, v, is_causal=True)``
    with no mask tensor (its backward where ``do`` is given) under each of
    SDPA's cuDNN, flash and memory-efficient backends alone, the kv heads
    repeated to the query heads outside the timing: {backend: ms, or
    "refused" where it does not take the call}.  ``is_causal`` aligns the
    mask top-left, which is the port's causal mask only at Tq = Tk and
    ``q_offset`` 0: the caller's to hold.  The yardstick only: the port
    never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"is_causal aligns top-left: Tq {q.shape[2]} != Tk {k.shape[2]}")
    group = q.shape[1] // k.shape[1]
    qq, kk, vv = (t.detach().clone().requires_grad_(do is not None) for t in (
        q, k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name in SDPA_CAUSAL_BACKENDS:
        with sdpa_kernel([getattr(SDPBackend, name)]):
            try:
                if do is None:
                    out[name] = cuda_ms(lambda: sdpa(qq, kk, vv, is_causal=True), reps)
                else:
                    o = sdpa(qq, kk, vv, is_causal=True)
                    out[name] = cuda_ms(lambda: torch.autograd.grad(
                        o, (qq, kk, vv), do, retain_graph=True), reps)
            except RuntimeError as e:        # "No available kernel", or the backend's own refusal
                out[name] = "refused"
                log(f"  SDPA {name} refused {tuple(q.shape)} is_causal=True"
                    f"{' backward' if do is not None else ''}: {str(e).splitlines()[0][:160]}")
        torch.cuda.empty_cache()
    return out


def sdpa_line(times):
    """``sdpa_causal_ms``'s result as text: each backend's ms or refusal."""
    return ", ".join(f"{name} {ms if ms == 'refused' else f'{ms:.4f} ms'}"
                     for name, ms in times.items())


def fastest(times):
    """(backend, ms) of the fastest backend that ran in ``sdpa_causal_ms``'s
    result."""
    ran = {name: ms for name, ms in times.items() if ms != "refused"}
    if not ran:
        raise AssertionError(f"every SDPA backend refused the call: {times}")
    name = min(ran, key=ran.get)
    return name, ran[name]


def is_plain_causal(qs, ks, kw):
    """True where SDPA's ``is_causal`` is the port's mask: causal, no window,
    no softcap, Tq = Tk and ``q_offset`` 0."""
    return bool(kw.get("causal") and kw.get("window") is None and kw.get("softcap") is None
                and kw.get("q_offset", 0) == 0 and qs[2] == ks[2])


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
            "splits": split_count(B, Hq, Tq, ks[2], D, causal=False, window=None, q_offset=0,
                                  sm_count=sm_count()),
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


def serve_train_shapes(cfg, serve, train):
    """(name, q shape, k/v shape) of ``cfg``'s attention over more than
    4096 keys: a long serve phase's prefill at ``serve`` = (batch, tokens)
    and a training step's forward at ``train``."""
    return [(name, (B, cfg.n_heads, T, cfg.head_dim), (B, cfg.n_kv_heads, T, cfg.head_dim))
            for name, (B, T) in (("serve prefill", serve), ("train forward", train))]


def long_times(shapes, kw, seed):
    """``flash_attention_sm90`` at each (name, q shape, k/v shape) of
    ``shapes`` (bf16) under the causal mask ``kw``: its error against the
    plain version, its time, the plain version's, the bound (4 D flops a
    live pair), and ``scaled_dot_product_attention`` on the same inputs:
    ``is_causal=True`` under each backend where that is the mask
    (``sdpa_causal_ms``, the fastest as ``library_ms``), else the
    window-causal boolean mask (``sdpa_ms``)."""
    out = {}
    for i, (name, qs, ks) in enumerate(shapes):
        B, Hq, Tq, D = qs
        q, k, v = attention_inputs(B, Hq, ks[1], Tq, ks[2], D, torch.bfloat16, seed=seed + i)
        err, share = flash_case(q, k, v, **kw)
        pairs = live_pairs(Tq, ks[2], causal=True, window=kw["window"], q_offset=0) * B * Hq
        ops_s = 4 * D * pairs / BF16_FLOP_PER_S
        bytes_s = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() / HBM_BYTES_PER_S
        row = out[name] = {
            "shape": [list(qs), list(ks)], "window": kw["window"], "live_pairs": pairs,
            "max_abs_err": err, "bf16_limit_share": share,
            "ms": cuda_ms(lambda: flash_attention_sm90_cuda(q, k, v, **kw), reps=5),
            "plain_ms": cuda_ms(lambda: ref_flash_attention(q, k, v, **kw), reps=1),
            "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        }
        if is_plain_causal(qs, ks, kw):
            row["library_backends"] = sdpa_causal_ms(q, k, v)
            row["library_backend"], row["library_ms"] = fastest(row["library_backends"])
        else:
            row["library_ms"] = sdpa_ms(q, k, v, kw["window"])
        del q, k, v
        torch.cuda.empty_cache()
    return out


def split_times():
    """``flash_attention_sm90`` at the seamless serve path's two
    cross-attentions, a decode step's q (4, 16, 1, 64) (split) and the
    prefill's q (4, 16, 512, 64) (unsplit: two full waves) over 32768 frames,
    unmasked: ``split_case``'s check of the call at the wrapper's own key
    ranges (a split launch also merges them), its time, and the time of
    the same call with ``splits=1``."""
    out = {}
    cfg = get_config(ENCDEC_ARCH)
    for i, name in enumerate(("cross decode", "cross prefill")):
        (B, Hq, Tq, D), ks = seamless_shapes(cfg)[name]
        q, k, v = attention_inputs(B, Hq, ks[1], Tq, ks[2], D, torch.bfloat16, seed=60 + i)
        err, share, lse_err, ranges = split_case(q, k, v, causal=False)
        out[name] = {
            "shape": [[B, Hq, Tq, D], list(ks)], "splits": ranges, "max_abs_err": err,
            "bf16_limit_share": share, "lse_err": lse_err,
            "ms": cuda_ms(lambda: flash_attention_sm90_cuda(q, k, v, causal=False), reps=50),
            "unsplit_ms": cuda_ms(lambda: flash_attention_sm90_cuda(q, k, v, causal=False,
                                                                    splits=1), reps=50),
        }
        del q, k, v
        torch.cuda.empty_cache()
    return out


def sdpa_bwd_ms(q, k, v, do, causal, window=None) -> float:
    """Device ms of the backward of ``scaled_dot_product_attention`` on
    the same inputs and the same mask (the window-causal boolean mask on
    its memory-efficient backend; with no mask PyTorch picks its backend),
    the kv heads repeated to the query heads outside the timing.  The
    yardstick only: the port never calls it."""
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
                       reps=3)


def bwd_times(qs, ks, kw, dtype, seed):
    """The dtype's backward kernel at one shape (``flash_attention_bwd_sm90``
    for bf16, ``flash_attention_bwd`` for float32): its error against the
    plain backward, its time, the plain version's, the bound (10 D flops a
    live pair, S recomputed, over the dtype's peak, or each input read and
    each gradient written once over the memory rate), SDPA's backward with
    the same mask (a plain causal mask: ``is_causal`` with no mask tensor
    under each backend, the fastest that ran), and the forward's time with
    and without its lse."""
    B, Hq, Tq, D = qs
    q, k, v = attention_inputs(B, Hq, ks[1], Tq, ks[2], D, dtype, seed=seed)
    err, share, lse_err, _ = flash_bwd_case(q, k, v, seed=seed + 1, **kw)
    kernel = flash_kernel(dtype)
    o, lse = kernel(q, k, v, return_lse=True, **kw)
    do = torch.randn(q.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed + 1)).to(dtype)
    pairs = live_pairs(Tq, ks[2], causal=kw["causal"], window=kw.get("window"),
                       q_offset=0) * B * Hq
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    ops_s = 10 * D * pairs / rate
    bytes_s = ((4 * q.numel() + 4 * k.numel()) * q.element_size()
               + 4 * lse.numel()) / HBM_BYTES_PER_S
    row = {
        "shape": [list(qs), list(ks)],
        "dtype": str(dtype).replace("torch.", ""),
        "mask": {key: val for key, val in kw.items()},
        "max_abs_err": err, "limit_share": share, "lse_err": lse_err,
        "ms": cuda_ms(lambda: flash_bwd_kernel(dtype)(q, k, v, o, lse, do, **kw), reps=3),
        "plain_ms": cuda_ms(lambda: ref_flash_attention_backward(q, k, v, o, lse, do, **kw),
                            reps=1),
        "bound_ms": max(ops_s, bytes_s) * 1e3,
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "forward_ms": cuda_ms(lambda: kernel(q, k, v, **kw), reps=3),
        "forward_lse_ms": cuda_ms(lambda: kernel(q, k, v, return_lse=True, **kw), reps=3),
        "live_pairs": pairs,
    }
    if is_plain_causal(qs, ks, kw):
        row["library_backends"] = sdpa_causal_ms(q, k, v, do)
        row["library_backend"], row["library_ms"] = fastest(row["library_backends"])
    else:
        row["library_ms"] = sdpa_bwd_ms(q, k, v, do, kw["causal"], kw.get("window"))
    del q, k, v, o, lse, do
    torch.cuda.empty_cache()
    return row


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
        "launches": state["launches"]["linear_scan"] + state["mesh_serve_rg_launches"]
        + state["train_rg"]["launches"]["linear_scan"],
        "launches_by_path": {f"{ARCH} serve": state["launches"]["linear_scan"],
                             f"{ARCH} mesh serve (tp_serve_hd)":
                                 state["mesh_serve_rg_launches"],
                             f"{ARCH} train (forward, recompute, backward)":
                                 state["train_rg"]["launches"]["linear_scan"]},
        "max_abs_err": max(t["err"], t_long["err"], state["scan_err"], state["scan_grad_err"]),
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
            f"{LONG_ARCH} mesh serve": state["mesh_serve_launches"],
            **{f"{ENCDEC_ARCH} mesh serve ({k})": n
               for k, n in state["mesh_encdec_launches"].items()},
            f"{LONG_ARCH} mesh generate": state["mesh_generate_launches"],
            f"{LONG_ARCH} train": state["train_long"]["launches"]["flash_attention_sm90"],
            f"{LONG_ARCH} mesh train (tp_fsdp)":
                state["mesh_train_long"]["launches"]["flash_attention_sm90"],
            f"{ENCDEC_ARCH} train": state["train_encdec"]["launches"]["flash_attention_sm90"],
            f"{ARCH} serve ({RG_LONG_BATCH} x {RG_LONG_PROMPT})":
                state["serve_long_rg"]["launches"]["flash_attention_sm90"],
            f"{ARCH} train ({RG_TRAIN_BATCH} x {state['train_rg']['seq']})":
                state["train_rg"]["launches"]["flash_attention_sm90"],
            f"{TRAIN_ARCH} serve ({OLMO_LONG_BATCH} x {OLMO_LONG_PROMPT})":
                state["serve_long_olmo"]["launches"]["flash_attention_sm90"],
            f"{TRAIN_ARCH} train ({OLMO_TRAIN_BATCH} x {state['train_olmo']['seq']})":
                state["train_olmo"]["launches"]["flash_attention_sm90"]},
        "flash_attention": {
            f"{LONG_ARCH} teacher forcing": state["long_tf_launches"],
            f"{ENCDEC_ARCH} teacher forcing": state["encdec_tf_launches"],
            f"{LONG_ARCH} float32 mesh serve": state["mesh_serve_f32_launches"],
            f"{LONG_ARCH} train float32 ({LONG_F32_LAYERS} layers)":
                state["train_long_f32"]["launches"]["flash_attention"],
            f"{ARCH} teacher forcing ({RG_TF_LAYERS} layers, D = 256)": state["rg_tf_launches"],
            f"{TRAIN_ARCH} teacher forcing ({OLMO_TF_LAYERS} layers, D = 128)":
                state["olmo_tf_launches"]},
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
            "lse_ms": cuda_ms(lambda: kernel(q, k, v, return_lse=True, **kw),
                              reps=10 if share is not None else 5),
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
            row["kernels_by_width"] = {
                "8-64": "flash_attention_d64_kernel<1, 2 or 3 consumers (block_rows), split>",
                "65-128": "flash_attention_d128_kernel<softcap>",
                "136-256": "flash_attention_d256_kernel<softcap>"}
            # the exponentials on the FMA pipe: none (PERF.md: with no
            # exponential at all the D <= 64 forward ran no faster)
            row["exp_fma_share"] = {"flash_attention_d64_kernel (every instantiation)": "0/8",
                                    "flash_attention_d128_kernel, flash_attention_d256_kernel":
                                        "0/8"}
            # the speech serve's calls at D <= 64 by the kernel's rows a
            # block (64: one consumer warpgroup, 128: two, 192: three)
            row["d64_launches_by_rows"] = {
                f"{ENCDEC_ARCH} serve": state["serve_encdec"]["d64_launches_by_rows"]}
        kernels.append(row)
        del q, k, v
        torch.cuda.empty_cache()
        if name == "flash_attention_sm90":
            rg, om = get_config(ARCH), get_config(TRAIN_ARCH)
            row["recurrentgemma"] = long_times(
                serve_train_shapes(rg, (RG_LONG_BATCH, RG_LONG_PROMPT),
                                   (RG_TRAIN_BATCH, RG_TRAIN_SEQ)),
                dict(causal=True, window=rg.window), seed=64)
            row["olmo"] = long_times(
                serve_train_shapes(om, (OLMO_LONG_BATCH, OLMO_LONG_PROMPT),
                               (OLMO_TRAIN_BATCH, OLMO_TRAIN_SEQ)),
                dict(causal=True, window=om.window), seed=88)
            row["seamless"] = seamless_times()
            row["split"] = split_times()
            row["split_launches_by_path"] = {
                f"{ENCDEC_ARCH} serve": state["encdec_splits"],
                **{f"{ENCDEC_ARCH} mesh serve ({k})": n
                   for k, n in state["mesh_encdec_splits"].items()}}

    # the backward: the bf16 tensor-core kernel at the training phases'
    # three shapes (their dtype), the float32 kernel at danube's and at
    # seamless's encoder
    train = {name: bwd_times(qs, ks, kw, torch.bfloat16, seed=40 + i)
             for i, (name, qs, ks, kw) in enumerate(train_attention_shapes())}
    (_, dn_q, dn_kv, dn_kw), (_, enc_q, enc_kv, enc_kw), *_ = train_attention_shapes()
    f32 = {"danube float32": bwd_times(dn_q, dn_kv, dn_kw, torch.float32, seed=50),
           "seamless encoder float32": bwd_times(enc_q, enc_kv, enc_kw, torch.float32, seed=51)}
    bwd_paths = {
        "flash_attention_bwd_sm90": {
            f"{LONG_ARCH} train": state["train_long"]["launches"]["flash_attention_bwd_sm90"],
            f"{LONG_ARCH} mesh train (tp_fsdp)":
                state["mesh_train_long"]["launches"]["flash_attention_bwd_sm90"],
            f"{ENCDEC_ARCH} train":
                state["train_encdec"]["launches"]["flash_attention_bwd_sm90"],
            f"{ARCH} train ({RG_TRAIN_BATCH} x {state['train_rg']['seq']})":
                state["train_rg"]["launches"]["flash_attention_bwd_sm90"],
            f"{TRAIN_ARCH} train ({OLMO_TRAIN_BATCH} x {state['train_olmo']['seq']})":
                state["train_olmo"]["launches"]["flash_attention_bwd_sm90"]},
        "flash_attention_bwd": {
            f"{LONG_ARCH} train float32 ({LONG_F32_LAYERS} layers)":
                state["train_long_f32"]["launches"]["flash_attention_bwd"]},
    }
    for name, shapes, dtype, rate, rate_name in (
            ("flash_attention_bwd_sm90", train, torch.bfloat16, BF16_FLOP_PER_S,
             "bf16 tensor cores"),
            ("flash_attention_bwd", f32, torch.float32, F32_FLOP_PER_S,
             "float32 outside the tensor cores")):
        main = next(iter(shapes.values()))   # danube's shape
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": "src/repro/models/layers.py:159",
            "replaces_note": "no TPU kernel: flash_attention_pallas (src/repro/kernels/"
                             "flash_attention.py:105) is forward only; the reference trains "
                             "through jax.grad of _blockwise_attention",
            "launches": sum(bwd_paths[name].values()),
            "launches_by_path": bwd_paths[name],
            "max_abs_err": max(main["max_abs_err"], state["flash_bwd_err"][dtype]),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "library_call": "the backward of scaled_dot_product_attention with the same mask "
                            "(efficient backend with the window-causal boolean mask; no mask: "
                            "PyTorch's pick), kv heads repeated outside the timing",
            "shape": main["shape"],
            "dtype": main["dtype"],
            "window": dn_kw.get("window"),
            "limit_share": max([t["limit_share"] for t in shapes.values()]
                               + [state["flash_bwd_share"][dtype]]),
            "bound_basis": f"10*D flop per live (q, k) pair over {rate:.3g} flop/s (H100 SXM "
                           f"{rate_name}); q, k, v, o, do, lse read and dq, dk, dv written once "
                           f"over {HBM_BYTES_PER_S:.3g} B/s (H100 SXM HBM3)",
            "train_shapes": shapes,
        })
        if dtype == torch.bfloat16:
            kernels[-1]["kernels_by_width"] = {
                "8-64": "absmax_kernel, convert_kernel, stats_kernel (with do's conversion), "
                        "d64::dkdv_kernel<softcap> (256 threads, no producer), "
                        "d64::dq_kernel<softcap> (288 threads) (fp16 operands)",
                "65-128": "absmax_kernel, convert_kernel, stats_kernel (with do's conversion), "
                          "d128::dkdv_kernel<softcap>, d128::dq_kernel<softcap> (fp16 operands)",
                "136-256": "stats_kernel, d256::dkdv_kernel<softcap>, d256::dq_kernel<softcap>"}
            # the exponentials on the FMA pipe: none (PERF.md: a polynomial on
            # 1/8 to 1/2 of them slowed both passes)
            kernels[-1]["exp_fma_share"] = {"d64::dkdv_kernel, d64::dq_kernel": "0/8",
                                            "d128, d256": "0/8"}
            # the calls among ``launches`` that ran on fp16 copies (five launches each)
            kernels[-1]["fp16_launches_by_path"] = {
                path: state[key]["bwd_fp16_launches"] for path, key in zip(
                    bwd_paths[name], ("train_long", "mesh_train_long", "train_encdec",
                                      "train_rg", "train_olmo"))}
            kernels[-1]["fp16_launches"] = sum(kernels[-1]["fp16_launches_by_path"].values())
    state["kernels"] = kernels
    for k in kernels:
        log(f"{k['name']} {k['shape']} {k['dtype']}: kernel {k['ms']:.4f} ms, plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']}, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_ms'] / k['ms']:.1%} of roofline), {k['launches']} launches on the "
            f"path, on {state['smi']}")
    for shape_name, t in next(k for k in kernels if "split" in k)["split"].items():
        log(f"flash_attention_sm90 seamless {shape_name} {t['shape']} bfloat16 non-causal: "
            f"{t['splits']} key ranges merged in the launch {t['ms']:.4f} ms, unsplit "
            f"{t['unsplit_ms']:.4f} ms; max abs err {t['max_abs_err']:.3e}, lse err "
            f"{t['lse_err']:.3e}, on {state['smi']}")
    sm90 = next(k for k in kernels if "olmo" in k)
    for arch, shape_name, t in [(arch, n, t) for arch in ("recurrentgemma", "olmo")
                                for n, t in sm90[arch].items()]:
        library = (f"SDPA is_causal {sdpa_line(t['library_backends'])}: fastest "
                   f"{t['library_backend']}" if "library_backends" in t else "SDPA, window mask")
        log(f"flash_attention_sm90 {arch} {shape_name} {t['shape']} bfloat16 causal, window "
            f"{t['window']}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
            f"({library}) {t['library_ms']:.4f} ms ({t['ms'] / t['library_ms']:.2f} x its time), "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bound_ms'] / t['ms']:.1%} of "
            f"roofline), max abs err {t['max_abs_err']:.3e}, on {state['smi']}")
    for shape_name, t in next(k for k in kernels if "seamless" in k)["seamless"].items():
        log(f"flash_attention_sm90 seamless {shape_name} {t['shape']} bfloat16 non-causal, "
            f"{t['splits']} key ranges: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library (SDPA, no mask) "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{t['bound_ms'] / t['ms']:.1%} of roofline), max abs err {t['max_abs_err']:.3e}, "
            f"on {state['smi']}")
    for shape_name, t in list(train.items()) + list(f32.items()):
        backends = (f", is_causal {sdpa_line(t['library_backends'])}"
                    if "library_backends" in t else "")
        log(f"{flash_bwd_kernel(getattr(torch, t['dtype'])).__name__} {shape_name} {t['shape']} "
            f"{t['dtype']} {t['mask']}: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library (SDPA backward{backends}) "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{t['bound_ms'] / t['ms']:.1%} of roofline, {t['ms'] / t['library_ms']:.2f} x "
            f"SDPA's); forward {t['forward_ms']:.4f} ms, with lse {t['forward_lse_ms']:.4f} ms; "
            f"max abs err {t['max_abs_err']:.3e}, {t['limit_share']:.3f} of the limit; "
            f"on {state['smi']}")
    # the forward kernels against PERF.md's kernel table before the kernels
    # for head widths 65-128 (the first design's 5.7025 ms bf16; 48.09 ms
    # float32, unchanged), danube shape
    for name, before in (("flash_attention_sm90", 5.7025), ("flash_attention", 48.09)):
        k = next(k for k in kernels if k["name"] == name)
        log(f"{name} at the danube serving shape: {k['ms']:.4f} ms ({k['ms'] / before:.3f} x "
            f"{before} ms in PERF.md's table before), with lse {k['lse_ms']:.4f} ms")
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
    # the resume of ``launch.train``: a checkpointer on the blob, rank 0
    # reading the state whole, ``distribute_state`` placing it
    resumed = BlobCheckpointer(client, ckpt.blob_id, psize=CKPT_PSIZE)
    t0 = time.perf_counter()
    restored, step, reader_state = resume_state(types.SimpleNamespace(device="cuda"), builder,
                                                resumed, state["mesh"], 0)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if step != MESH_TRAIN_STEPS or reader_state != reader.state_dict():
        raise AssertionError(f"resumed at step {step}, reader {reader_state}")
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
    st2 = resumed.save(train_state, step=MESH_TRAIN_STEPS,
                       extra={"reader": reader.state_dict(), "note": "extra moved"})
    save2_s = time.perf_counter() - t0
    inc_counts = ops.launch_counts()
    if (inc_counts["page_digest"], inc_counts["delta_mask"]) != (n_leaves, n_leaves) or \
            st2.pages_written != 0:
        raise AssertionError(f"incremental mesh save: {inc_counts}, {st2.pages_written} pages")
    state["mesh_train_launches"] = {k: full_counts[k] + inc_counts[k] for k in full_counts}
    log(f"  mesh checkpoint: full save {st1.pages_written}/{st1.pages_total} pages in "
        f"{save_s:.2f} s ({full_counts['page_digest']} page_digest), resumed through "
        f"launch.train.resume_state into the mesh placements byte-equal in {restore_s:.2f} s, "
        f"its checkpointer's unchanged save "
        f"{st2.pages_written} pages in {save2_s:.2f} s ({inc_counts['page_digest']} "
        f"page_digest, {inc_counts['delta_mask']} delta_mask); host peak RSS "
        f"{host_rss_gib():.1f} GiB")
    state["mesh_train"] = {"losses": losses, "ref_losses": ref_losses, "loss_rel": loss_rel,
                           "param_abs": p_abs, "param_rel": p_rel, "step_ms": ms,
                           "ref_step_ms": ref_ms, "peak_gib": peak, "ref_peak_gib": ref_peak,
                           "save_s": save_s, "restore_s": restore_s, "save2_s": save2_s}
    # the gradients of the last batch at the trained state, for the collective
    state["mesh_grads"] = builder.grads_fn()(train_state, batches[-1])[1]
    del ckpt, resumed, client, reader, train_state
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
    top2 = ref["logits"][0].float().topk(2, dim=-1).values
    state["mesh_prefill_first"] = {
        "mesh": outs[0].argmax(-1).cpu().numpy(), "no_mesh": ref["logits"][0].argmax(-1)
        .cpu().numpy(), "margin": (top2[:, 0] - top2[:, 1]).cpu().numpy(),
        "dlogit": float((outs[0].float() - ref["logits"][0].float()).abs().max())}
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


MESH_ENCDEC_STRATEGIES = ("tp_serve", "tp_fsdp_sp")


def phase_mesh_serve_encdec(state):
    """Full-width seamless-m4t-large-v2 under ``tp_serve`` and under
    ``tp_fsdp_sp``: the encdec serve phase's frames and prompts, its
    memories placed on the mesh, teacher-forced on that phase's greedy
    tokens and held to its logits; every attention over the 32768 frames
    on the local shards (``tp_fsdp_sp``: the q rows' sequence named by the
    rules, whole on the (1, 1) mesh), its greedy tokens the no-mesh run's."""
    cfg = get_config(ENCDEC_ARCH)
    model = build_model(cfg)
    B, S, T0 = ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_PROMPT
    batch = {"enc_embeds": frame_embeddings(B, S, cfg.d_model, seed=17),
             "tokens": torch.as_tensor(np.stack(prompts_for(seed=18, batch=B, length=T0))
                                       .astype(np.int64), device="cuda")}
    ref = state.pop("encdec_ref")
    state["mesh_serve_encdec"], state["mesh_encdec_launches"] = {}, {}
    state["mesh_encdec_splits"] = {}
    for strategy in MESH_ENCDEC_STRATEGIES:
        builder = TrainStepBuilder(model, state["mesh"], strategy=strategy)
        params = model.init(torch.Generator(device="cuda").manual_seed(16))   # the serve phase's
        params = builder.distribute(params, builder.param_shardings(params), src_data_rank=None)
        prefill, decode = builder.prefill_step_fn(), builder.decode_step_fn()
        cache = builder.shard_cache(model.init_cache(B, T0 + ENCDEC_NEW, device="cuda"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # -- the main path: counts at 0 just before, read just after
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache, mem = prefill(params, batch, cache)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        pre = ops.launch_counts()
        outs = [logits]
        t0 = time.perf_counter()
        for i, tok in enumerate(ref["fed"]):
            logits, cache = decode(params, tok, T0 + i, cache, mem)
            outs.append(logits)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / len(ref["fed"])
        counts, split_calls = ops.launch_counts(), ops.split_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = (cfg.n_enc_layers + cfg.n_layers,
                cfg.n_enc_layers + cfg.n_layers * (1 + len(ref["fed"])))
        splits = encdec_splits(cfg, len(ref["fed"]))
        if (pre["flash_attention_sm90"], counts["flash_attention_sm90"]) != want or \
                counts["flash_attention"] != 0 or split_calls != splits:
            raise AssertionError(f"the {strategy} mesh prefill launched {pre}, with the decode "
                                 f"steps {counts} and {split_calls} split calls; expected "
                                 f"{want} flash_attention_sm90, {splits} of them split")
        if not all(t.to_local().is_contiguous() and t.placements == mem[0].placements
                   for t in mem):
            raise AssertionError(f"memories {[t.placements for t in mem]}")
        if not all(bool(torch.isfinite(a).all()) for a in outs):
            raise AssertionError("non-finite mesh logits")
        dlogit = max(float((a.float() - b.float()).abs().max())
                     for a, b in zip(outs, ref["logits"]))
        same = float(torch.stack([(a.argmax(-1) == b.argmax(-1)).float().mean()
                                  for a, b in zip(outs, ref["logits"])]).mean())
        if not dlogit <= MESH_ENCDEC_DLOGIT:
            raise AssertionError(f"seamless {strategy} mesh logits off the no-mesh run's by "
                                 f"{dlogit:.3e} (limit {MESH_ENCDEC_DLOGIT})")
        if strategy == "tp_fsdp_sp" and same != 1.0:
            raise AssertionError(f"seamless tp_fsdp_sp greedy tokens equal the no-mesh run's "
                                 f"in {same:.4f} of positions")
        state["mesh_serve_encdec"][strategy] = r = {
            "prefill_ms": prefill_ms, "decode_ms_per_step": step_ms, "max_dlogit": dlogit,
            "greedy_same": same, "peak_gib": peak, "launches": counts["flash_attention_sm90"],
            "no_mesh_prefill_ms": state["serve_encdec"]["prefill_ms"],
            "no_mesh_decode_ms_per_step": state["serve_encdec"]["decode_ms_per_step"]}
        state["mesh_encdec_launches"][strategy] = counts["flash_attention_sm90"]
        state["mesh_encdec_splits"][strategy] = split_calls
        log(f"mesh encdec serve: {cfg.name} {strategy}, {B}x{S} frames + {B}x{T0} tokens "
            f"prefill {prefill_ms:.2f} ms (first call; no mesh {r['no_mesh_prefill_ms']:.2f}, "
            f"median of 3), {pre['flash_attention_sm90']} flash_attention_sm90 launches on the "
            f"local shards; {len(ref['fed'])} teacher-forced decode steps {step_ms:.2f} ms/step "
            f"(no mesh {r['no_mesh_decode_ms_per_step']:.2f}), {counts['flash_attention_sm90']} "
            f"launches in all; memories placed {mem[0].placements}; max |dlogit| vs no mesh "
            f"{dlogit:.3e} (limit {MESH_ENCDEC_DLOGIT}), greedy tokens equal {same:.4f}; peak "
            f"{peak:.2f} GiB; on {state['smi']}")
        del params, outs, cache, mem, logits
        torch.cuda.empty_cache()
    del ref, batch
    torch.cuda.empty_cache()


class _TimedBuilder(TrainStepBuilder):
    """``TrainStepBuilder`` that adds the seconds of each of its steps,
    each closed by a device sync, to ``seconds``: where ``generate``'s
    time under a mesh goes."""

    seconds: dict = {}

    def _timed(self, what, fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds[what] = self.seconds.get(what, 0.0) + time.perf_counter() - t0
        return out

    def distribute(self, *args, **kwargs):
        return self._timed("place", super().distribute, *args, **kwargs)

    def shard_cache(self, *args, **kwargs):
        return self._timed("place", super().shard_cache, *args, **kwargs)

    def prefill_step_fn(self):
        fn = super().prefill_step_fn()
        return lambda *args: self._timed("prefill", fn, *args)

    def decode_step_fn(self):
        fn = super().decode_step_fn()
        return lambda *args: self._timed("decode", fn, *args)


def phase_mesh_generate(state):
    """``launch.serve.generate(..., mesh, strategy="tp_serve_sm")`` on the
    long-context phase's model and prompts: its first new tokens against
    the mesh serve phase's prefill, its tokens against the long phase's
    (no mesh), its wall time split by a builder that syncs each step."""
    cfg = get_config(LONG_ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(3))   # the long phase's
    prompts = prompts_for(seed=4, batch=LONG_BATCH, length=LONG_PROMPT)
    want = state.pop("long_outs")
    first = state.pop("mesh_prefill_first")
    torch.cuda.synchronize()
    _TimedBuilder.seconds = {}
    # -- the main path: counts at 0 just before, read just after
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with _swap(serve_module, "TrainStepBuilder", _TimedBuilder):
        outs = generate(model, params, prompts, max_new=LONG_NEW,
                        max_len=LONG_PROMPT + LONG_NEW, device="cuda", mesh=state["mesh"],
                        strategy="tp_serve_sm")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    split = dict(_TimedBuilder.seconds)
    split["rest"] = wall - sum(split.values())
    if counts["flash_attention_sm90"] != cfg.n_layers or counts["flash_attention"] != 0:
        raise AssertionError(f"generate under the mesh launched {counts}, expected "
                             f"{cfg.n_layers} flash_attention_sm90 (the prefill)")
    for p, o in zip(prompts, outs):
        if o.shape != (LONG_PROMPT + LONG_NEW,) or not np.array_equal(o[:LONG_PROMPT], p) or \
                not ((o >= 0) & (o < cfg.vocab_size)).all():
            raise AssertionError(f"bad output {o.shape} or prompt not preserved")
    got, ref = np.stack(outs)[:, LONG_PROMPT:], np.stack(want)[:, LONG_PROMPT:]
    # the first new token comes from the prefill: the mesh serve phase's
    # exactly (the same steps on the same mesh), and the no-mesh run's
    # wherever no |dlogit| of that prefill could swap its top two
    clear = first["margin"] > 2 * first["dlogit"]
    if not (np.array_equal(got[:, 0], first["mesh"]) and
            np.array_equal(got[clear, 0], first["no_mesh"][clear])):
        raise AssertionError(f"first new tokens {got[:, 0]}: mesh prefill {first['mesh']}, no "
                             f"mesh {first['no_mesh']} (margins {first['margin']}, |dlogit| "
                             f"{first['dlogit']:.3e})")
    same = float((got == ref).mean())
    # greedy decoding from bf16 logits summed in another order: after the
    # first token that flips, a row continues from another prefix
    agree = [int(np.argmin(np.append(g == r, False))) for g, r in zip(got, ref)]
    # the same call inside torch.inference_mode, which generate keeps for
    # one device only: its split says what DTensor's dispatch costs there
    _TimedBuilder.seconds = {}
    t0 = time.perf_counter()
    with _swap(serve_module, "TrainStepBuilder", _TimedBuilder), torch.inference_mode():
        inf_outs = generate(model, params, prompts, max_new=LONG_NEW,
                            max_len=LONG_PROMPT + LONG_NEW, device="cuda", mesh=state["mesh"],
                            strategy="tp_serve_sm")
    torch.cuda.synchronize()
    inf_split = dict(_TimedBuilder.seconds, wall=time.perf_counter() - t0)
    inf_same = float(np.mean([np.array_equal(a, b) for a, b in zip(inf_outs, outs)]))
    state["mesh_generate"] = {"wall_s": wall, "split_s": split, "tokens_same": same,
                              "rows_agree_for": agree, "first_rows_held": int(clear.sum()),
                              "inference_mode_split_s": inf_split,
                              "inference_mode_rows_same": inf_same,
                              "no_mesh_wall_s": state["serve_long"]["generate_first_call_s"]}
    state["mesh_generate_launches"] = counts["flash_attention_sm90"]
    log(f"mesh generate: {cfg.name} generate(mesh, tp_serve_sm), {LONG_BATCH}x{LONG_PROMPT} + "
        f"{LONG_NEW} new tokens in {wall:.2f} s (no mesh, first call "
        f"{state['serve_long']['generate_first_call_s']:.2f} s): "
        f"{', '.join(f'{k} {v:.3f} s' for k, v in split.items())} ({LONG_NEW - 1} decode "
        f"steps); launches {counts}; first new tokens equal to the mesh prefill's, and to the "
        f"no-mesh run's in {int(clear.sum())} of {LONG_BATCH} rows whose top-two margin "
        f"exceeds 2 x |dlogit| {first['dlogit']:.3e}; new tokens equal to the no-mesh run's "
        f"{same:.4f}; each row agrees for its first {agree} new tokens; inside "
        f"torch.inference_mode: {', '.join(f'{k} {v:.3f} s' for k, v in inf_split.items())}, "
        f"rows equal to the no_grad call's {inf_same:.2f}; on {state['smi']}")
    del params, model
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _swap(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def phase_mesh_train_xlstm(state):
    """Full-width xlstm-350m under ``tp_fsdp``: two steps at 2 x 512 from
    the state and batches of a no-mesh run, losses within 1e-4 relative."""
    cfg = get_config(XLSTM_ARCH)
    _, reader = corpus_reader(XLSTM_TRAIN_BATCH, XLSTM_TRAIN_SEQ)
    batches = [dict(zip(("tokens", "labels"), (torch.as_tensor(a, device="cuda")
                                               for a in reader.next_batch())))
               for _ in range(XLSTM_TRAIN_STEPS)]
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100)

    def run(builder):
        train_state = builder.init_state(torch.Generator(device="cuda").manual_seed(0))
        step_fn, losses, ms = builder.train_step_fn(), [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_state, metrics = step_fn(train_state, batch)
            losses.append(float(metrics["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms

    ref_losses, ref_ms = run(TrainStepBuilder(build_model(cfg), opt=opt))
    builder = TrainStepBuilder(build_model(cfg), state["mesh"], strategy="tp_fsdp", opt=opt)
    # -- the main path: counts at 0 just before, read just after
    ops.reset_launch_counts()
    losses, ms = run(builder)
    no_launches(ops.launch_counts(), "the xLSTM mesh train steps")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    if not (all(np.isfinite(losses)) and rel <= MESH_LOSS_RTOL):
        raise AssertionError(f"xLSTM mesh losses {losses} vs no-mesh {ref_losses}")
    state["mesh_train_xlstm"] = {"losses": losses, "ref_losses": ref_losses, "loss_rel": rel,
                                 "step_ms": ms, "ref_step_ms": ref_ms}
    log(f"mesh xlstm train: {cfg.name} tp_fsdp, {XLSTM_TRAIN_BATCH}x{XLSTM_TRAIN_SEQ}: losses "
        f"{losses} vs no-mesh {ref_losses} (max rel {rel:.3e}, limit {MESH_LOSS_RTOL}); step ms "
        f"mesh {', '.join(f'{m:.1f}' for m in ms)} vs no-mesh "
        f"{', '.join(f'{m:.1f}' for m in ref_ms)}; on {state['smi']}")
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


def encdec_splits(cfg, decode_steps):
    """``flash_attention_sm90`` launches of a seamless serve run over
    ``ENCDEC_FRAMES`` frames that split their keys (and merge them in the
    launch): one for each cross-attention whose shape the wrapper splits
    (the prefill's, then each decode step's)."""
    def splits(name):
        (B, Hq, Tq, D), ks = seamless_shapes(cfg)[name]
        return split_count(B, Hq, Tq, ks[2], D, causal=False, window=None, q_offset=0,
                           sm_count=sm_count()) > 1
    return cfg.n_layers * (splits("cross prefill") + decode_steps * splits("cross decode"))


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
        ref_logits = [logits]
        for i in range(new - 1):
            logits, cache = model.decode_step(params, out[-1], T0 + i, cache, mem)
            ref_logits.append(logits)
            finite &= torch.isfinite(logits).all()
            out.append(torch.argmax(logits, dim=-1))
        # the mesh encdec phase is teacher-forced on these tokens and held
        # to these logits
        state["encdec_ref"] = {"logits": ref_logits, "fed": out[:new - 1]}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    state["encdec_splits"] = ops.split_launches()
    d64_rows = ops.fwd_d64_launches()
    peak = torch.cuda.max_memory_allocated()
    state["encdec_launches"] = counts
    log(f"  prefill + {new - 1} decode steps: {new} new tokens a row in {wall:.3f} s (first "
        f"call); launches {counts}; flash_attention_sm90 at D <= 64 by rows a block {d64_rows}")
    if counts["flash_attention_sm90"] != want or counts["flash_attention"] != 0:
        raise AssertionError(f"flash_attention_sm90 launched {counts['flash_attention_sm90']} "
                             f"times and flash_attention {counts['flash_attention']}, expected "
                             f"{want} ({cfg.n_enc_layers} + {cfg.n_layers} in the prefill, "
                             f"{cfg.n_layers} a decode step) and 0")
    splits = encdec_splits(cfg, new - 1)
    if state["encdec_splits"] != splits or splits == 0:
        raise AssertionError(f"{state['encdec_splits']} flash_attention_sm90 launches split their "
                             f"keys, expected {splits} (a split cross-attention each)")
    # the configurations by rows a block: the encoder's, the prefill's
    # cross-attention's and a decode step's, as block_rows plans them
    planned = {64: 0, 128: 0, 192: 0}
    for name, n in (("encoder", cfg.n_enc_layers), ("cross prefill", cfg.n_layers),
                    ("cross decode", cfg.n_layers * (new - 1))):
        (qB, qH, qT, qD), _ = seamless_shapes(cfg)[name]
        planned[block_rows(qB, qH, qT, qD, sm_count())] += n
    if d64_rows != planned:
        raise AssertionError(f"flash_attention_sm90 launches by rows a block {d64_rows}, "
                             f"planned {planned}")
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
        "d64_launches_by_rows": d64_rows,
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
    """Full-width seamless-m4t-large-v2 trained at 2 x 8192 frames and
    2 x 2048 tokens: the encoder's self-attention and every cross-attention
    go through ``flash_attention_sm90`` (forward, again in the recompute of
    remat "full") and ``flash_attention_bwd_sm90``; then one more step
    under the profiler."""
    cfg = get_config(ENCDEC_ARCH)
    _, reader = corpus_reader(TRAIN_BATCH, TRAIN_SEQ)
    batches = []
    for i in range(TRAIN_STEPS):
        tokens, labels = reader.next_batch()
        batches.append({"enc_embeds": frame_embeddings(TRAIN_BATCH, ENCDEC_TRAIN_FRAMES,
                                                       cfg.d_model, seed=23 + i),
                        "tokens": torch.as_tensor(tokens, device="cuda"),
                        "labels": torch.as_tensor(labels, device="cuda")})
    builder = TrainStepBuilder(build_model(cfg), remat_policy="full",
                               opt=AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100))
    counts, rec = run_train_steps(
        state, builder, batches, f"encdec train ({cfg.n_enc_layers} + {cfg.n_layers} layers, "
        f"{TRAIN_BATCH} x {ENCDEC_TRAIN_FRAMES} frames and {TRAIN_BATCH} x {TRAIN_SEQ} tokens)",
        seed=22)
    # every encoder layer and every decoder layer (its cross-attention) is
    # checkpointed: two forwards and one backward a layer a step
    n_att = cfg.n_enc_layers + cfg.n_layers
    expect_launches(counts, {"flash_attention_sm90": TRAIN_STEPS * 2 * n_att,
                             "flash_attention_bwd_sm90": TRAIN_STEPS * n_att}, "encdec train")
    expect_fp16_launches(rec["bwd_fp16_launches"], TRAIN_STEPS * n_att, cfg.head_dim,
                         "encdec train")
    state["train_encdec"] = rec
    log(f"  {TRAIN_STEPS * 2 * n_att} flash_attention_sm90 and {TRAIN_STEPS * n_att} "
        f"flash_attention_bwd_sm90 launches (the encoder's self-attention and the "
        f"cross-attention over {ENCDEC_TRAIN_FRAMES} frames, forward twice under remat "
        f"\"full\", and backward; the decoder's self-attention stays dense), as expected")
    del batches
    torch.cuda.empty_cache()


def train_launches(cfg, kind, steps, remat):
    """(forward, backward) kernel launches of the ``kind`` layers of a
    decoder-only ``cfg`` over ``steps`` steps: each such layer runs its
    forward once and its backward once a step, and its forward again in
    the backward's recompute when its pattern group is checkpointed (remat
    other than "none"; the ``rest`` layers are not, ``lm.apply_stack_train``)."""
    n_groups, rest = LM._pattern_layout(cfg)
    in_groups = n_groups * sum(1 for k in cfg.block_pattern if k == kind)
    n = in_groups + sum(1 for k in rest if k == kind)
    return steps * (n + (in_groups if remat != "none" else 0)), steps * n


def device_idle_share(fn, top=6):
    """(output, wall ms, device ms, idle share, the ``top`` kernels as
    (name, count, ms)) of one ``fn()`` under ``torch.profiler``: device
    time summed over kernels, memcpys and memsets."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    rows = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:top]
    return (out, wall_ms, dev_ms, max(0.0, 1.0 - dev_ms / wall_ms),
            [(e.key[:80], e.count, e.self_device_time_total / 1e3) for e in rows])


def run_train_steps(state, builder, batches, what, seed):
    """A fresh state, then one step a batch with the launch counts at 0
    just before and read just after; then one more step of the last batch
    under the profiler (its idle share).  Returns the counts and the
    phase's record."""
    step_fn = builder.train_step_fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    train_state = builder.init_state(torch.Generator(device="cuda").manual_seed(seed))
    n_state = sum(t.numel() * t.element_size() for _, t in flatten_with_paths(train_state))
    n_params = sum(t.numel() for t in tree_leaves(train_state["params"]))
    cfg = builder.model.cfg
    log(f"{what}: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}, {n_params / 1e9:.3f} B params, state "
        f"{n_state / 1e9:.2f} GB, remat {builder.remat_policy}")
    step_ms, losses = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_state, metrics = step_fn(train_state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        log(f"  step {int(train_state['step'])}: loss {loss:.4f} grad norm {gnorm:.4f} in "
            f"{step_ms[-1]:.1f} ms")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"non-finite loss {loss} or grad norm {gnorm}")
    counts = ops.launch_counts()
    fp16 = ops.bwd_fp16_launches()
    peak = torch.cuda.max_memory_allocated()
    (train_state, _), wall_ms, dev_ms, idle, top = device_idle_share(
        lambda: step_fn(train_state, batches[-1]))
    rec = {"step_ms": step_ms, "losses": losses, "peak_gib": peak / 2**30,
           "state_gb": n_state / 1e9,
           "params_b": n_params / 1e9, "profiled_step_ms": wall_ms, "device_ms": dev_ms,
           "idle_share": idle, "top_kernels": top, "launches": counts,
           "bwd_fp16_launches": fp16}
    log(f"  step: {', '.join(f'{m:.1f}' for m in step_ms)} ms; peak device memory "
        f"{rec['peak_gib']:.2f} GiB; profiled step {wall_ms:.1f} ms, device {dev_ms:.1f} ms, "
        f"idle {idle:.1%}; launches {counts}, {fp16} of the backward's on fp16 copies; on "
        f"{state['smi']}")
    for name, n, ms in top:
        log(f"    {ms:9.2f} ms ({ms / dev_ms:.1%})  x{n:<5d} {name}")
    del train_state, metrics
    torch.cuda.empty_cache()
    return counts, rec


def expect_launches(counts, want, what):
    full = {name: want.get(name, 0) for name in counts}
    if counts != full:
        raise AssertionError(f"{what}: launches {counts}, expected {full}")


def expect_fp16_launches(fp16, bwd, head_dim, what):
    """``flash_attention_bwd_sm90``'s calls on fp16 copies (``fp16``, from
    ``ops.bwd_fp16_launches``) out of its ``bwd`` calls at ``head_dim``:
    every one at head widths up to 128, none at the others."""
    want = bwd if converts_to_fp16(head_dim) else 0
    if fp16 != want:
        raise AssertionError(f"{what}: {fp16} flash_attention_bwd_sm90 calls on fp16 copies, "
                             f"expected {want} of {bwd} at head width {head_dim}")


def train_memory_estimate(cfg, batch, seq, remat):
    """The dry run's one-device record of a train step (fake tensors,
    ``launch.specs.build_cell`` with no mesh, ``hlo.StepTrace``): the
    bytes of its inputs and the peak of its temporaries."""
    from repro_torch.launch import hlo as H
    from repro_torch.launch.specs import build_cell

    prog = build_cell(cfg, ShapeCell("smoke_train", "train", seq, batch), None,
                      remat_policy=remat, accum=1, device="cuda")
    with prog.fake_mode:
        leaves = [t for t in tree_leaves(prog.placed_args()) if isinstance(t, torch.Tensor)]
        trace = H.StepTrace(leaves)
        with trace:
            prog.fn(*prog.placed_args())
    return sum(t.numel() * t.element_size() for t in leaves), trace.peak_bytes


def phase_train_long(state):
    """Full-width h2o-danube3-4b trained at 1 x 8192 tokens, its published
    context and twice its window: every layer's attention goes through
    ``flash_attention_sm90`` (forward, again in the recompute of remat
    "full") and ``flash_attention_bwd_sm90``.  First the dry run's one-device
    record of the step must fit the card."""
    cfg = get_config(LONG_ARCH)
    arg_b, temp_b = train_memory_estimate(cfg, LONG_TRAIN_BATCH, LONG_TRAIN_SEQ, "full")
    card_b = torch.cuda.get_device_properties(0).total_memory
    log(f"  dry run, one device: inputs {arg_b / 1e9:.2f} GB + temporaries {temp_b / 1e9:.2f} "
        f"GB = {(arg_b + temp_b) / 2**30:.2f} GiB of the card's {card_b / 2**30:.2f} GiB")
    if arg_b + temp_b > card_b:
        raise AssertionError(f"{cfg.name} at {LONG_TRAIN_BATCH} x {LONG_TRAIN_SEQ} does not fit "
                             f"one card by the dry run's estimate")
    _, reader = corpus_reader(LONG_TRAIN_BATCH, LONG_TRAIN_SEQ)
    batches = [dict(zip(("tokens", "labels"), (torch.as_tensor(a, device="cuda")
                                               for a in reader.next_batch())))
               for _ in range(LONG_TRAIN_STEPS)]
    builder = TrainStepBuilder(build_model(cfg), remat_policy="full",
                               opt=AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100))
    counts, rec = run_train_steps(state, builder, batches,
                                  f"long train ({LONG_TRAIN_BATCH} x {LONG_TRAIN_SEQ})", seed=24)
    fwd, bwd = train_launches(cfg, "swa", LONG_TRAIN_STEPS, builder.remat_policy)
    expect_launches(counts, {"flash_attention_sm90": fwd, "flash_attention_bwd_sm90": bwd},
                    "long train")
    expect_fp16_launches(rec["bwd_fp16_launches"], bwd, cfg.head_dim, "long train")
    rec.update(estimate_gib=(arg_b + temp_b) / 2**30)
    state["train_long"] = rec
    log(f"  {fwd} flash_attention_sm90 and {bwd} flash_attention_bwd_sm90 launches over "
        f"{LONG_TRAIN_STEPS} steps of {cfg.n_layers} layers, as expected")


def phase_train_long_f32(state):
    """The float32 backward's path: h2o-danube3-4b at full width cut to
    ``LONG_F32_LAYERS`` layers in float32 takes one step at 1 x 8192 (remat
    "none"): every layer's attention through the float32 ``flash_attention``
    and ``flash_attention_bwd``, finite loss and grad norm."""
    cfg = dataclasses.replace(get_config(LONG_ARCH), n_layers=LONG_F32_LAYERS, dtype="float32")
    _, reader = corpus_reader(LONG_TRAIN_BATCH, LONG_TRAIN_SEQ)
    batches = [dict(zip(("tokens", "labels"), (torch.as_tensor(a, device="cuda")
                                               for a in reader.next_batch())))]
    builder = TrainStepBuilder(build_model(cfg), remat_policy="none",
                               opt=AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100))
    counts, rec = run_train_steps(state, builder, batches,
                                  f"long train float32 ({LONG_TRAIN_BATCH} x {LONG_TRAIN_SEQ})",
                                  seed=25)
    fwd, bwd = train_launches(cfg, "swa", len(batches), builder.remat_policy)
    expect_launches(counts, {"flash_attention": fwd, "flash_attention_bwd": bwd},
                    "long train float32")
    state["train_long_f32"] = rec
    log(f"  {fwd} flash_attention and {bwd} flash_attention_bwd launches, as expected")


MESH_LONG_HEADROOM_GIB = 4.0     # the mesh long step's record and peak leave this much free
_MESH_RECORD_SCRIPT = """
import functools, json, sys
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch.dryrun import trace_cell
from repro_torch.launch.mesh import make_mesh
arch, seq, batch, strategy, remat = sys.argv[1:6]
rec = trace_cell(get_config(arch), ShapeCell("smoke_train", "train", int(seq), int(batch)), 1,
                 functools.partial(make_mesh, (1, 1), ("data", "model"), device="cuda"),
                 strategy, remat=remat, accum=1, device="cuda")
print(json.dumps(rec["memory"]))
"""


def mesh_train_record(cfg, batch, seq, strategy, remat):
    """The dry run's (1, 1) record of a train step under ``strategy``
    (fake tensors over a fake one-rank group, traced in a process of its
    own: the fake group must not meet this process's NCCL group): the
    bytes of its inputs and the peak of its temporaries."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    run = subprocess.run([sys.executable, "-c", _MESH_RECORD_SCRIPT, cfg.name, str(seq),
                          str(batch), strategy, remat], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=DRYRUN_TIMEOUT_S)
    if run.returncode != 0:
        raise AssertionError(f"the (1, 1) record of {cfg.name} exited {run.returncode}:\n"
                             f"{run.stderr[-3000:]}")
    mem = json.loads(run.stdout.strip().splitlines()[-1])
    return mem["argument_bytes"], mem["temp_bytes"]


def phase_mesh_train_long(state):
    """Full-width h2o-danube3-4b trained at 1 x 8192 under ``tp_fsdp`` on the
    (1, 1) mesh (remat "full", no zero2): the long train phase's seed and
    batches, every layer's attention through ``flash_attention_sm90`` and
    ``flash_attention_bwd_sm90`` on the local shards of ``_local_attention``,
    as many launches as that phase and its losses.  First the dry run's
    (1, 1) record of the step must leave ``MESH_LONG_HEADROOM_GIB`` of the
    card free; so must the run's peak."""
    cfg = get_config(LONG_ARCH)
    arg_b, temp_b = mesh_train_record(cfg, LONG_TRAIN_BATCH, LONG_TRAIN_SEQ, "tp_fsdp", "full")
    card_b = torch.cuda.get_device_properties(0).total_memory
    headroom = MESH_LONG_HEADROOM_GIB * 2**30
    log(f"  dry run, (1, 1) mesh, tp_fsdp: inputs {arg_b / 1e9:.2f} GB + temporaries "
        f"{temp_b / 1e9:.2f} GB = {(arg_b + temp_b) / 2**30:.2f} GiB of the card's "
        f"{card_b / 2**30:.2f} GiB")
    if arg_b + temp_b > card_b - headroom:
        raise AssertionError(f"{cfg.name} at {LONG_TRAIN_BATCH} x {LONG_TRAIN_SEQ} under a mesh "
                             f"leaves under {MESH_LONG_HEADROOM_GIB} GiB of the card by the dry "
                             f"run's estimate")
    _, reader = corpus_reader(LONG_TRAIN_BATCH, LONG_TRAIN_SEQ)
    batches = [dict(zip(("tokens", "labels"), (torch.as_tensor(a, device="cuda")
                                               for a in reader.next_batch())))
               for _ in range(LONG_TRAIN_STEPS)]
    builder = TrainStepBuilder(build_model(cfg), state["mesh"], strategy="tp_fsdp",
                               remat_policy="full",
                               opt=AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100))
    # the main path (run_train_steps: counts at 0 just before, read just after)
    counts, rec = run_train_steps(state, builder, batches,
                                  f"mesh long train ({LONG_TRAIN_BATCH} x {LONG_TRAIN_SEQ}, "
                                  f"tp_fsdp)", seed=24)       # the long train phase's seed
    fwd, bwd = train_launches(cfg, "swa", LONG_TRAIN_STEPS, builder.remat_policy)
    ref = state["train_long"]
    expect_launches(counts, {"flash_attention_sm90": fwd, "flash_attention_bwd_sm90": bwd},
                    "mesh long train")
    expect_fp16_launches(rec["bwd_fp16_launches"], bwd, cfg.head_dim, "mesh long train")
    if counts != ref["launches"]:
        raise AssertionError(f"mesh long train launched {counts}, the long train phase "
                             f"{ref['launches']}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"], ref["losses"]))
    if not loss_rel <= MESH_LOSS_RTOL:
        raise AssertionError(f"mesh long losses {rec['losses']} vs no-mesh {ref['losses']}")
    if rec["peak_gib"] * 2**30 > card_b - headroom:
        raise AssertionError(f"mesh long train peak {rec['peak_gib']:.2f} GiB leaves under "
                             f"{MESH_LONG_HEADROOM_GIB} GiB of the card")
    rec.update(estimate_gib=(arg_b + temp_b) / 2**30, loss_rel=loss_rel)
    state["mesh_train_long"] = rec
    log(f"  mesh long train: losses {rec['losses']} vs no-mesh {ref['losses']} (max rel "
        f"{loss_rel:.3e}); step ms {', '.join(f'{m:.1f}' for m in rec['step_ms'])} vs no-mesh "
        f"{', '.join(f'{m:.1f}' for m in ref['step_ms'])}; peak {rec['peak_gib']:.2f} vs "
        f"{ref['peak_gib']:.2f} GiB; {fwd} flash_attention_sm90 and {bwd} "
        f"flash_attention_bwd_sm90 launches, as the long train phase's; on {state['smi']}")


class _PlainAttention(torch.autograd.Function):
    """``ops.flash_attention`` under autograd with the kernels' plain
    versions on the card: the forward ``ref_flash_attention`` (keeping o and
    lse), the backward ``ref_flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, softcap):
        kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        o, lse = ref_flash_attention(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ref_flash_attention_backward(q, k, v, o, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None


def plain_attention(q, k, v, **kw):
    """``ops.flash_attention``'s signature over ``_PlainAttention``."""
    return _PlainAttention.apply(q, k, v, kw["causal"], kw["window"], kw["q_offset"],
                                 kw["softcap"])


def plain_grads(grads_fn, probe, batch, name, fn, want, what):
    """Loss and global gradient norm of ``batch`` with ops.``name`` swapped
    for its plain version ``fn``, the other kernels' launches ``want``."""
    with _swap(ops, name, fn):
        ops.reset_launch_counts()
        loss, grads = grads_fn(probe, batch)
        expect_launches(ops.launch_counts(), want, f"{what}, plain {name}")
    norm = float(global_norm(grads))
    del grads
    torch.cuda.empty_cache()
    return float(loss), norm


def fit_train_seq(cfg, batch, seq):
    """``seq``, or the longest multiple of 512 past 4096 tokens below it,
    whose dry-run record (one device) of a ``batch`` x seq step at remat
    "full" leaves ``RG_TRAIN_HEADROOM_GIB`` of the card free; returns (seq,
    the record's input bytes, its temporaries)."""
    budget = torch.cuda.get_device_properties(0).total_memory - RG_TRAIN_HEADROOM_GIB * 2**30
    first, temp_first = seq, None
    while True:
        arg_b, temp_b = train_memory_estimate(cfg, batch, seq, "full")
        temp_first = temp_first or temp_b
        log(f"  dry run, one device, {batch} x {seq}: inputs {arg_b / 1e9:.2f} GB + "
            f"temporaries {temp_b / 1e9:.2f} GB = {(arg_b + temp_b) / 2**30:.2f} GiB, "
            f"{RG_TRAIN_HEADROOM_GIB} GiB to stay free of the card's "
            f"{(budget / 2**30 + RG_TRAIN_HEADROOM_GIB):.2f} GiB")
        if arg_b + temp_b <= budget:
            break
        # the longest multiple of 512 past the dense limit that fits: the
        # temporaries grow in proportion to the sequence (the logits and the
        # activations of one batch row), so the first record predicts it
        # and the next one checks it
        fit = int((budget - arg_b) / temp_first * first) // 512 * 512
        seq = min(seq - 512, fit)
        if seq <= 4096:
            raise AssertionError(f"{cfg.name} does not fit one card past 4096 tokens by the "
                                 f"dry run's estimate")
    if seq != first:
        log(f"  cut to {batch} x {seq}: {first} does not fit by the estimate")
    return seq, arg_b, temp_b


def phase_train_rg(state):
    """Full-width recurrentgemma-2b trained at 1 x 8192, or the longest
    multiple of 512 past 4096 tokens whose dry-run record (one device) of
    the step leaves ``RG_TRAIN_HEADROOM_GIB`` of the card free (remat
    "full", bf16 params, float32 AdamW
    state): every RG-LRU's scan and its gradient go
    through ``linear_scan``'s kernel, every local layer's attention (10
    query heads of 256 over one kv head, window 2048) through
    ``flash_attention_sm90`` (again in the recompute) and
    ``flash_attention_bwd_sm90``.  Then the gradients of one batch with the
    kernels, with the plain scan (loss and gradient norm within 1e-4, every
    RG-LRU leaf's gradient nonzero and finite) and with the plain attention
    (within ``RG_ATTN_RTOL``); then the steps."""
    cfg = state["cfg"]
    seq, arg_b, temp_b = fit_train_seq(cfg, RG_TRAIN_BATCH, RG_TRAIN_SEQ)
    _, reader = corpus_reader(RG_TRAIN_BATCH, seq)
    batches = [dict(zip(("tokens", "labels"), (torch.as_tensor(a, device="cuda")
                                               for a in reader.next_batch())))
               for _ in range(RG_TRAIN_STEPS)]
    builder = TrainStepBuilder(build_model(cfg), remat_policy="full",
                               opt=AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100))
    fwd, bwd = train_launches(cfg, "rglru", 1, builder.remat_policy)
    fa_fwd, fa_bwd = train_launches(cfg, "local", 1, builder.remat_policy)
    scans = {"linear_scan": fwd + bwd}
    attention = {"flash_attention_sm90": fa_fwd, "flash_attention_bwd_sm90": fa_bwd}

    grads_fn = builder.grads_fn()
    probe = builder.init_state(torch.Generator(device="cuda").manual_seed(25))
    ops.reset_launch_counts()
    loss_k, grads_k = grads_fn(probe, batches[0])
    expect_launches(ops.launch_counts(), {**scans, **attention}, "recurrentgemma gradients")
    expect_fp16_launches(ops.bwd_fp16_launches(), fa_bwd, cfg.head_dim,
                         "recurrentgemma gradients")
    norm_k = float(global_norm(grads_k))
    paths = [p for p, _ in flatten_with_paths(probe["params"])]
    rglru = [(p, g) for p, g in zip(paths, grads_k)
             if p.split("/")[-1] in ("wx", "conv", "w_a", "w_i", "lam") and "mixer" in p]
    n_rglru = attention_layers(cfg, "rglru")
    n_leaves = sum(k == "rglru" for k in cfg.block_pattern + LM._pattern_layout(cfg)[1])
    if len(rglru) != 5 * n_leaves:
        raise AssertionError(f"RG-LRU leaves {[p for p, _ in rglru]}")
    for p, g in rglru:
        per_layer = g.float().abs().reshape(g.shape[0], -1).amax(1) if g.ndim > 1 and \
            p.startswith("groups/") else g.float().abs().max().reshape(1)
        if not (bool(torch.isfinite(g).all()) and bool((per_layer > 0).all())):
            raise AssertionError(f"RG-LRU gradient {p}: finite {bool(torch.isfinite(g).all())}, "
                                 f"per-layer max |g| {per_layer.tolist()}")
    del grads_k, rglru
    loss_k = float(loss_k)

    loss_p, norm_p = plain_grads(grads_fn, probe, batches[0], "linear_scan",
                                 lambda a, x: ref_linear_scan(a, x), attention,
                                 "recurrentgemma gradients")
    loss_a, norm_a = plain_grads(grads_fn, probe, batches[0], "flash_attention",
                                 plain_attention, scans, "recurrentgemma gradients")
    del probe
    torch.cuda.empty_cache()
    loss_rel, norm_rel = abs(loss_k - loss_p) / abs(loss_p), abs(norm_k - norm_p) / norm_p
    attn_loss_rel, attn_norm_rel = abs(loss_k - loss_a) / abs(loss_a), abs(norm_k - norm_a) / norm_a
    log(f"  {n_rglru} RG-LRU layers: loss {loss_k:.6f} (plain scan {loss_p:.6f}, rel "
        f"{loss_rel:.2e}), grad norm {norm_k:.6f} (plain scan {norm_p:.6f}, rel {norm_rel:.2e}); "
        f"{5 * n_leaves} RG-LRU leaves, every layer's gradient nonzero and finite")
    log(f"  {attention_layers(cfg, 'local')} local attention layers: plain attention loss "
        f"{loss_a:.6f} (rel {attn_loss_rel:.2e}), grad norm {norm_a:.6f} (rel "
        f"{attn_norm_rel:.2e}), tol {RG_ATTN_RTOL:.3g}")
    if not (loss_rel <= RG_PLAIN_RTOL and norm_rel <= RG_PLAIN_RTOL):
        raise AssertionError(f"kernel scan vs plain scan: loss rel {loss_rel:.2e}, grad norm "
                             f"rel {norm_rel:.2e} > {RG_PLAIN_RTOL}")
    if not (attn_loss_rel <= RG_ATTN_RTOL and attn_norm_rel <= RG_ATTN_RTOL):
        raise AssertionError(f"attention kernels vs plain attention: loss rel "
                             f"{attn_loss_rel:.2e}, grad norm rel {attn_norm_rel:.2e} > "
                             f"{RG_ATTN_RTOL:.3g}")

    counts, rec = run_train_steps(state, builder, batches,
                                  f"recurrentgemma train ({RG_TRAIN_BATCH} x {seq})", seed=26)
    expect_launches(counts, {name: RG_TRAIN_STEPS * n for name, n in {**scans, **attention}.items()},
                    "recurrentgemma train")
    rec.update(loss_rel=loss_rel, grad_norm_rel=norm_rel, attention_loss_rel=attn_loss_rel,
               attention_grad_norm_rel=attn_norm_rel, estimate_gib=(arg_b + temp_b) / 2**30,
               seq=seq)
    state["train_rg"] = rec
    log(f"  {RG_TRAIN_STEPS} x ({fwd} + {bwd}) linear_scan, {RG_TRAIN_STEPS} x {fa_fwd} "
        f"flash_attention_sm90 and {RG_TRAIN_STEPS} x {fa_bwd} flash_attention_bwd_sm90 "
        f"launches (forward with the recompute, backward), as expected")



def phase_train_long_olmo(state):
    """Full-width olmo-1b trained at 2 x 8192, or the longest multiple of
    512 whose dry-run record leaves ``RG_TRAIN_HEADROOM_GIB`` of the card
    free (remat "full", bf16 params, float32 AdamW state): every layer's
    attention (16 heads of 128, plain causal) through ``flash_attention_sm90``
    (again in the recompute) and ``flash_attention_bwd_sm90``.  First the
    gradients of one batch with the kernels (every one finite) and with the
    plain attention: loss and gradient norm within ``RG_ATTN_RTOL``; then
    the steps."""
    cfg = get_config(TRAIN_ARCH)
    seq, arg_b, temp_b = fit_train_seq(cfg, OLMO_TRAIN_BATCH, OLMO_TRAIN_SEQ)
    _, reader = corpus_reader(OLMO_TRAIN_BATCH, seq)
    batches = [dict(zip(("tokens", "labels"), (torch.as_tensor(a, device="cuda")
                                               for a in reader.next_batch())))
               for _ in range(OLMO_TRAIN_STEPS)]
    builder = TrainStepBuilder(build_model(cfg), remat_policy="full",
                               opt=AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100))
    fwd, bwd = train_launches(cfg, "attn", 1, builder.remat_policy)
    attention = {"flash_attention_sm90": fwd, "flash_attention_bwd_sm90": bwd}

    grads_fn = builder.grads_fn()
    probe = builder.init_state(torch.Generator(device="cuda").manual_seed(84))
    ops.reset_launch_counts()
    loss_k, grads_k = grads_fn(probe, batches[0])
    expect_launches(ops.launch_counts(), attention, "olmo gradients")
    expect_fp16_launches(ops.bwd_fp16_launches(), bwd, cfg.head_dim, "olmo gradients")
    norm_k = float(global_norm(grads_k))
    paths = [p for p, _ in flatten_with_paths(probe["params"])]
    bad = [p for p, g in zip(paths, grads_k) if not bool(torch.isfinite(g).all())]
    if bad or not np.isfinite(norm_k):
        raise AssertionError(f"olmo gradients not finite: {bad}, norm {norm_k}")
    del grads_k
    loss_k = float(loss_k)
    loss_a, norm_a = plain_grads(grads_fn, probe, batches[0], "flash_attention",
                                 plain_attention, {}, "olmo gradients")
    del probe
    torch.cuda.empty_cache()
    loss_rel, norm_rel = abs(loss_k - loss_a) / abs(loss_a), abs(norm_k - norm_a) / norm_a
    log(f"  {attention_layers(cfg, 'attn')} attention layers: loss {loss_k:.6f} (plain attention "
        f"{loss_a:.6f}, rel {loss_rel:.2e}), grad norm {norm_k:.6f} (plain attention "
        f"{norm_a:.6f}, rel {norm_rel:.2e}), tol {RG_ATTN_RTOL:.3g}; {len(paths)} gradients "
        f"finite")
    if not (loss_rel <= RG_ATTN_RTOL and norm_rel <= RG_ATTN_RTOL):
        raise AssertionError(f"attention kernels vs plain attention: loss rel {loss_rel:.2e}, "
                             f"grad norm rel {norm_rel:.2e} > {RG_ATTN_RTOL:.3g}")

    counts, rec = run_train_steps(state, builder, batches,
                                  f"olmo long train ({OLMO_TRAIN_BATCH} x {seq})", seed=86)
    expect_launches(counts, {name: OLMO_TRAIN_STEPS * n for name, n in attention.items()},
                    "olmo long train")
    expect_fp16_launches(rec["bwd_fp16_launches"], OLMO_TRAIN_STEPS * bwd, cfg.head_dim,
                         "olmo long train")
    rec.update(attention_loss_rel=loss_rel, attention_grad_norm_rel=norm_rel,
               estimate_gib=(arg_b + temp_b) / 2**30, seq=seq)
    state["train_olmo"] = rec
    log(f"  {OLMO_TRAIN_STEPS} x {fwd} flash_attention_sm90 and {OLMO_TRAIN_STEPS} x {bwd} "
        f"flash_attention_bwd_sm90 launches (forward with the recompute, backward), as expected")


# ------------------------------------------------- launch tooling, examples

# the dry run's cells on the card machine (``repro_torch.launch.dryrun``):
# (arch, shape, mesh[, strategy]), strategy "auto" where none is named (tp_fsdp
# to train, tp_serve to serve); train cells at one microbatch to keep the phase short
DRYRUN_CELLS = [[("qwen3-32b", "train_4k", "single")],
                [("olmo-1b", "train_4k", "single"), ("olmo-1b", "train_4k", "multi")],
                [("h2o-danube-3-4b", "prefill_32k", "single"),
                 ("granite-moe-1b-a400m", "decode_32k", "single"),
                 ("recurrentgemma-2b", "long_500k", "single")],
                # one cell of each class of the mesh path's repaired faults: the
                # decode lookup on 2 x 16 x 16, the MoE over split experts
                # (prefill, training), heads a 16-way axis does not divide,
                # xLSTM, the VLM splice, serving and training the encoder-decoder
                [("olmo-1b", "decode_32k", "multi"), ("olmoe-1b-7b", "prefill_32k", "single"),
                 ("xlstm-350m", "decode_32k", "single")],
                [("granite-moe-1b-a400m", "train_4k", "single"),
                 ("recurrentgemma-2b", "train_4k", "single")],
                [("internvl2-76b", "prefill_32k", "single"),
                 ("seamless-m4t-large-v2", "prefill_32k", "single"),
                 ("seamless-m4t-large-v2", "prefill_32k", "multi"),
                 ("seamless-m4t-large-v2", "train_4k", "single")],
                # the reference's last three strategies: heads split unevenly
                # (_uneven), the decode over a cache split on its head
                # dimension (tp_serve_hd), activations split on the sequence
                [("qwen1.5-32b", "train_4k", "single", "tp_fsdp_uneven"),
                 ("qwen1.5-32b", "prefill_32k", "single", "tp_serve_uneven"),
                 ("qwen1.5-32b", "decode_32k", "single", "tp_serve_hd"),
                 ("recurrentgemma-2b", "decode_32k", "single", "tp_serve_hd"),
                 ("recurrentgemma-2b", "train_4k", "single", "tp_fsdp_uneven"),
                 ("h2o-danube-3-4b", "long_500k", "single", "tp_fsdp_sp")],
                # the configurations the port once did not run under a mesh:
                # training past 4096 kv positions on a split sequence (512 q
                # rows a rank), the encoder-decoder's memories split on their
                # head dimension, and the encoder-decoder, the MoE and xLSTM
                # over a sequence split 16 ways
                [("h2o-danube-3-4b", "train_1x8k", "single", "tp_fsdp_sp"),
                 ("seamless-m4t-large-v2", "decode_32k", "single", "tp_serve_hd")],
                [("seamless-m4t-large-v2", "prefill_1x32k", "single", "tp_fsdp_sp"),
                 ("olmoe-1b-7b", "prefill_1x32k", "single", "tp_fsdp_sp"),
                 ("xlstm-350m", "prefill_1x32k", "single", "tp_fsdp_sp")]]
# cells of shapes that ``configs/shapes.py`` (the reference's) does not
# list: name -> (step, sequence, global batch)
DRYRUN_SHAPES = {"train_1x8k": ("train", 8192, 1), "prefill_1x32k": ("prefill", 32768, 1)}
# bounds of the strategy cells: most traced / analytic FLOPs, most temp GiB
# beyond the inputs, most all-gather GiB a device
DRYRUN_BOUNDS = {("qwen1.5-32b", "train_4k", "tp_fsdp_uneven"): (1.3, None, None),
                 ("qwen1.5-32b", "prefill_32k", "tp_serve_uneven"): (1.3, None, None),
                 ("qwen1.5-32b", "decode_32k", "tp_serve_hd"): (None, 1.0, 1.0),
                 # the memories' stack is local: 1.75 GiB of temporaries, not the
                 # 96 GiB meta tensor that asks for its axis names
                 ("seamless-m4t-large-v2", "prefill_32k", "tp_serve"): (None, 3.0, None),
                 # 512 q rows a rank (traced 0.105 of the analytic count, which
                 # splits the work over "model" and the batch, never the
                 # sequence: 16 x the rank's share); 0.89 GiB, 2.51 GiB gathered
                 ("h2o-danube-3-4b", "train_1x8k", "tp_fsdp_sp"): (0.2, 2.0, 4.0),
                 # no memory gathered: 0.07 GiB of temporaries, 0.061 all-gathered
                 ("seamless-m4t-large-v2", "decode_32k", "tp_serve_hd"): (None, 1.0, 1.0),
                 # a split sequence: 0.82 / 6.79 / 1.99 GiB of temporaries; the
                 # residual stream and the scans gather it (8.8, 0.8, 11.7 GiB)
                 ("seamless-m4t-large-v2", "prefill_1x32k", "tp_fsdp_sp"): (None, 2.0, 12.0),
                 ("olmoe-1b-7b", "prefill_1x32k", "tp_fsdp_sp"): (None, 10.0, 2.0),
                 ("xlstm-350m", "prefill_1x32k", "tp_fsdp_sp"): (None, 4.0, 16.0)}
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
shapes = json.loads(sys.argv[4])
for arch, shape, mesh, *strategy in cells:
    run_cell(arch, shape, mesh, (strategy or ["auto"])[0], out,
             accum=1 if shape.startswith("train") else None, device="cuda", timeout_s=%d,
             cell=ShapeCell(shape, *shapes[shape]) if shape in shapes else None)
if smoke:
    rec = trace_cell(get_config(%r), ShapeCell("smoke_train", "train", %d, %d), 1,
                     functools.partial(make_mesh, (1, 1), ("data", "model"), device="cuda"),
                     "tp_fsdp", remat="none", accum=1, device="cuda")
    with open(out + "/smoke_train_1x1.json", "w") as f:
        json.dump(rec, f, default=str)
""" % (DRYRUN_TIMEOUT_S, TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH)


def phase_dry_run(state):
    """The port's dry run of twenty-six cells on fake 256- and 512-rank meshes,
    each group of cells in its own process (the fake process group must
    not meet this process's NCCL group), the groups in parallel."""
    out = os.path.join(ROOT, "experiments", "dryrun_torch", "smoke")
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", _DRYRUN_SCRIPT, json.dumps(cells), out,
                               "1" if i == len(DRYRUN_CELLS) - 1 else "0",
                               json.dumps(DRYRUN_SHAPES)],
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
    recs, failed = [], []
    for arch, shape, mesh, *named in (c for group in DRYRUN_CELLS for c in group):
        strategy = named[0] if named else "tp_fsdp" if shape.startswith("train") else "tp_serve"
        with open(os.path.join(out, f"{arch}_{shape}_{mesh}_{strategy}.json")) as f:
            rec = json.load(f)
        recs.append(rec)
        if rec["status"] != "ok":
            failed.append(f"dry run {arch} {shape} {mesh} {strategy}: {rec['status']} "
                          f"{rec.get('error', '')[:1000]}")
            log(f"  {failed[-1]}")
            continue
        m, rf = rec["memory"], rec["roofline"]
        coll = rec["collectives_hlo"]
        ratio = rec["cost_hlo_raw"]["flops"] / rf["flops_per_device"]
        most_ratio, most_temp, most_gather = DRYRUN_BOUNDS.get((arch, shape, strategy),
                                                               (None, None, None))
        if most_ratio is not None and ratio > most_ratio:
            failed.append(f"dry run {arch} {shape} {strategy}: traced / analytic {ratio:.3f}")
        if most_temp is not None and m["temp_bytes"] > most_temp * 2**30:
            failed.append(f"dry run {arch} {shape} {strategy}: temp {m['temp_bytes']} B")
        if most_gather is not None and \
                coll["bytes_by_op"].get("all-gather", 0) > most_gather * 2**30:
            failed.append(f"dry run {arch} {shape} {strategy}: all-gather {coll['bytes_by_op']}")
        log(f"  dry run {arch} {shape} {mesh} {strategy} (accum {rec['accum']}): ok, build "
            f"{rec['lower_s']} s, trace {rec['compile_s']} s; {(m['argument_bytes'] + m['temp_bytes']) / 2**30:.2f} "
            f"GiB a device (args {m['argument_bytes'] / 2**30:.2f} + temp "
            f"{m['temp_bytes'] / 2**30:.2f}); FLOPs traced {rec['cost_hlo_raw']['flops']:.4e} "
            f"vs analytic {rf['flops_per_device']:.4e} a device ({ratio:.3f}); collectives "
            f"{coll['count_by_op']}, GiB {({k: round(v / 2**30, 3) for k, v in coll['bytes_by_op'].items()})}; "
            f"roofline {rf['step_time_s'] * 1e3:.2f} ms, {rf['bottleneck']} (H100 constants)")
    if failed:
        raise AssertionError("; ".join(failed))
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
    ("flash attention backward vs plain", phase_flash_bwd_vs_plain),
    ("serve", phase_serve),
    ("decode vs teacher forcing", phase_teacher_forcing),
    ("long-context serve", phase_serve_long),
    ("long decode vs teacher forcing", phase_teacher_forcing_long),
    ("recurrentgemma long serve", phase_serve_long_rg),
    ("recurrentgemma long decode vs teacher forcing", phase_teacher_forcing_long_rg),
    ("olmo long serve", phase_serve_long_olmo),
    ("olmo long decode vs teacher forcing", phase_teacher_forcing_long_olmo),
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
    ("long train", phase_train_long),
    ("long train float32", phase_train_long_f32),
    ("recurrentgemma train", phase_train_rg),
    ("olmo long train", phase_train_long_olmo),
    ("mesh group", phase_mesh_group),
    ("mesh long train", phase_mesh_train_long),
    ("mesh train and checkpoint", phase_mesh_train),
    ("mesh collective", phase_mesh_collective),
    ("mesh serve", phase_mesh_serve),
    ("mesh encdec serve", phase_mesh_serve_encdec),
    ("mesh generate", phase_mesh_generate),
    ("mesh recurrentgemma serve", phase_mesh_serve_rg),
    ("mesh xlstm train", phase_mesh_train_xlstm),
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
