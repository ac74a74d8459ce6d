"""End-to-end training on one device.

The counterpart of ``repro.launch.train`` without a mesh: a BlobSeer
deployment holds both the tokenized corpus (append-ingested,
snapshot-pinned readers) and the versioned incremental checkpoint
lineage, and the model and AdamW run on one device.  On startup it
GET_RECENTs the checkpoint blob and resumes (params, optimizer, step,
data cursor) from it, so it can be killed and restarted at any point.

Usage (CPU-sized defaults)::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 50 \\
        --d-model 128 --layers 2 --seq 64 --batch 8 --spool /tmp/run1
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import BlobCheckpointer
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import BlobSeerService
from repro_torch.data import ByteTokenizer, CorpusWriter, ShardedReader
from repro_torch.models import build_model
from repro_torch.models.param_util import tree_map
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import TrainStepBuilder


def synthesize_corpus(writer: CorpusWriter, tok: ByteTokenizer, n_docs: int,
                      seed: int = 0) -> None:
    """Deterministic synthetic text corpus (number facts + noise)."""
    rng = np.random.default_rng(seed)
    for i in range(n_docs):
        n = int(rng.integers(40, 200))
        words = [f"tok{int(rng.integers(0, 50))}" for _ in range(n // 4)]
        text = f"document {i}: " + " ".join(words)
        writer.append_tokens(tok.encode(text))


def build_runtime(args):
    svc = BlobSeerService(
        n_providers=args.providers, n_meta_shards=4,
        data_replication=args.replication, spool_dir=args.spool,
        wal_path=(args.spool + "/vm.wal") if args.spool else None,
    )
    client = svc.client("trainer")
    return svc, client


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--providers", type=int, default=4)
    ap.add_argument("--replication", type=int, default=1)
    ap.add_argument("--spool", default=None)
    ap.add_argument("--mesh", default="1x1", help="only 1x1: the port trains on one device")
    ap.add_argument("--strategy", default="tp",
                    help="the reference's sharding strategy; one device shards nothing")
    ap.add_argument("--corpus-docs", type=int, default=200)
    ap.add_argument("--resume-blob", default=None)
    ap.add_argument("--corpus-blob", default=None)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        raise NotImplementedError(f"--mesh {args.mesh}: repro_torch trains on one device")

    tok = ByteTokenizer()
    cfg = get_config(args.arch).reduced(
        d_model=args.d_model, n_layers=args.layers, n_heads=args.heads,
        n_kv_heads=min(args.heads, get_config(args.arch).n_kv_heads),
        d_head=args.d_model // args.heads,
        d_ff=args.d_ff if get_config(args.arch).d_ff else 0,
        vocab_size=tok.vocab_size + 1,
    )
    svc, client = build_runtime(args)

    # ---- corpus (ingestion substrate) ----
    writer = CorpusWriter(client, args.corpus_blob, psize=16 * 1024)
    if args.corpus_blob is None:
        synthesize_corpus(writer, tok, args.corpus_docs)

    # ---- model + step ----
    model = build_model(cfg)
    builder = TrainStepBuilder(
        model, opt=AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps),
        remat_policy="none", accum=args.accum,
    )

    # ---- checkpoint lineage (resume if one exists) ----
    ckpt = BlobCheckpointer(client, args.resume_blob, psize=16 * 1024, header_pages=16)
    start_step = 0
    reader_state = None
    try:
        state, manifest = ckpt.restore(builder.abstract_state(), with_manifest=True,
                                       device=args.device)
        ckpt.load_digest_cache()
        start_step = manifest["step"]
        reader_state = manifest["extra"].get("reader")
        if not args.quiet:
            print(f"[resume] blob={ckpt.blob_id} step={start_step}")
    except (FileNotFoundError, KeyError):
        state = builder.init_state(torch.Generator(device=args.device).manual_seed(0))

    reader = ShardedReader(client, writer.blob_id, batch=args.batch,
                           seq_len=args.seq, state=reader_state)
    step_fn = builder.train_step_fn()

    # ---- loop ----
    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        tokens, labels = reader.next_batch()
        batch = tree_map(lambda a: torch.as_tensor(a, device=args.device),
                         {"tokens": tokens, "labels": labels})
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if not args.quiet and (step % 10 == 0 or step == args.steps - 1):
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
        if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
            stats = ckpt.save(state, step=step + 1,
                              extra={"reader": reader.state_dict()})
            if not args.quiet:
                print(f"[ckpt] v{stats.version} step {stats.step} "
                      f"wrote {stats.pages_written}/{stats.pages_total} pages "
                      f"(sharing {stats.sharing_fraction:.0%})")
    wall = time.time() - t0
    return {
        "losses": losses, "wall_s": wall, "ckpt_blob": ckpt.blob_id,
        "corpus_blob": writer.blob_id, "final_step": args.steps,
        "service": svc, "client": client, "state": state,
    }


if __name__ == "__main__":
    out = main()
    print(f"done: {len(out['losses'])} steps in {out['wall_s']:.1f}s, "
          f"final loss {out['losses'][-1]:.4f}")
