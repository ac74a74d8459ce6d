"""End-to-end training on the PyTorch port with BlobSeer data + checkpoint
substrate, including a mid-run crash + bit-identical resume.

The twin of ``examples/train_e2e.py``: the same steps, sizes and prints,
on ``repro_torch`` (on the card unless ``--device cpu``).  Runs a reduced
olmo-family model for a few hundred steps.  The corpus is ingested
through APPENDs; checkpoints are incremental COW saves (watch the
pages_written/pages_total ratio; on the card each save runs the
``page_digest`` and ``delta_mask`` kernels); at step 150 the trainer
"crashes" — all in-memory state dropped — and resumes from the
checkpoint lineage + journaled data cursor.

    PYTHONPATH=src python examples/train_e2e_torch.py [--steps 300] [--device cpu]

``main(argv)`` returns the per-step losses (``{step: loss}``; a step run
twice keeps its loss after the resume) and the checkpoint lineage.  It
runs with ``torch.use_deterministic_algorithms(True)``: without it a
CPU or CUDA reduction may round differently from one run to the next,
and the resumed losses would not be bit-identical.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np
import torch

from repro_torch.checkpoint import BlobCheckpointer
from repro_torch.configs import get_config
from repro_torch.core import BlobSeerService
from repro_torch.data import ByteTokenizer, CorpusWriter, ShardedReader
from repro_torch.models import build_model
from repro_torch.models.param_util import tree_leaves
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import TrainStepBuilder


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--crash-at", type=int, default=150)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # a resume is bit-identical only if every kernel is deterministic
    # (cuBLAS needs a fixed workspace for that)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _run(args)
    finally:
        torch.use_deterministic_algorithms(was)


def _run(args) -> dict:
    dev = args.device

    svc = BlobSeerService(n_providers=6, n_meta_shards=4)
    client = svc.client("trainer")
    tok = ByteTokenizer()

    # ---- ingest a synthetic corpus through the blob store ----
    writer = CorpusWriter(client, psize=16 * 1024)
    rng = np.random.default_rng(0)
    for i in range(400):
        n = int(rng.integers(30, 150))
        writer.append_tokens(tok.encode(
            f"sample {i}: " + " ".join(f"tok{int(rng.integers(0, 64))}"
                                       for _ in range(n))))
    print(f"corpus: {writer.n_tokens():,} tokens in blob {writer.blob_id}")

    # ---- ~10M-param model (olmo family, reduced) ----
    cfg = get_config("olmo-1b").reduced(
        d_model=192, n_layers=4, n_heads=6, n_kv_heads=6, d_head=32,
        d_ff=512, vocab_size=tok.vocab_size + 1)
    model = build_model(cfg)
    n_params = sum(p.numel() for p in tree_leaves(model.abstract()[0]))
    print(f"model: {cfg.name} reduced, {n_params:,} params")

    # one device, no mesh (the reference runs a 1x1 mesh)
    builder = TrainStepBuilder(
        model, None, strategy="tp",
        opt=AdamWConfig(lr=2e-3, warmup_steps=20, total_steps=args.steps),
        remat_policy="none")
    step_fn = builder.train_step_fn()

    ckpt = BlobCheckpointer(client, psize=16 * 1024, header_pages=16)
    state = builder.init_state(torch.Generator(device=dev).manual_seed(0))
    reader = ShardedReader(client, writer.blob_id, batch=args.batch,
                           seq_len=args.seq)
    losses = {}

    def run(state, reader, lo, hi, label):
        t0 = time.time()
        for s in range(lo, hi):
            tokens, labels = reader.next_batch()
            state, m = step_fn(state, {"tokens": torch.as_tensor(tokens, device=dev),
                                       "labels": torch.as_tensor(labels, device=dev)})
            losses[s] = float(m["loss"])
            if s % 25 == 0 or s == hi - 1:
                print(f"[{label}] step {s:4d} loss {losses[s]:.4f}")
            if (s + 1) % args.ckpt_every == 0:
                st = ckpt.save(state, step=s + 1,
                               extra={"reader": reader.state_dict()})
                print(f"[{label}] ckpt v{st.version} step {st.step}: "
                      f"{st.pages_written}/{st.pages_total} pages "
                      f"({st.sharing_fraction:.0%} shared with previous)")
        print(f"[{label}] {hi - lo} steps in {time.time() - t0:.1f}s")
        return state

    state = run(state, reader, 0, args.crash_at, "run-1")
    print("\n*** simulated crash: dropping all in-memory training state ***\n")
    del state, reader

    # ---- resume: everything comes back from the blob store ----
    state, mani = ckpt.restore(builder.abstract_state(), with_manifest=True, device=dev)
    ckpt.load_digest_cache()
    reader = ShardedReader(client, writer.blob_id, batch=args.batch,
                           seq_len=args.seq, state=mani["extra"]["reader"])
    print(f"resumed at step {mani['step']} from checkpoint v{mani and ckpt.client.get_recent(ckpt.blob_id)}")
    state = run(state, reader, mani["step"], args.steps, "run-2")

    # ---- inspect the checkpoint lineage ----
    lineage = ckpt.steps()
    print("\ncheckpoint lineage (version, step):", lineage)
    print("storage report:", svc.storage_report())
    return {"losses": losses, "lineage": lineage, "resumed_at": mani["step"]}


if __name__ == "__main__":
    main()
