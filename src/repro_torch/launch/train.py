"""End-to-end training, on one device or under a mesh.

The counterpart of ``repro.launch.train``: a BlobSeer deployment holds
both the tokenized corpus (append-ingested, snapshot-pinned readers) and
the versioned incremental checkpoint lineage, and the model and AdamW
run on one device (``--mesh 1x1``, no launcher) or on a ``DxM`` mesh of
("data", "model") under ``torch.distributed.run`` with ``D*M`` ranks:
NCCL with one card a rank on ``--device cuda``, gloo on ``--device
cpu``.  Under a mesh every rank builds the same corpus blob from the seed
and keeps its slice of each global batch, and rank 0 alone writes the
checkpoints.  On startup it GET_RECENTs the checkpoint blob and resumes
(params, optimizer, step, data cursor) from it, so it can be killed and
restarted at any point: ``--resume-blob`` with the ``--spool`` of the
killed run restores that deployment (a cold restart: pages from the
spool, the version manager from its WAL; ``--corpus-blob`` names its
corpus).  Under a mesh rank 0 alone restores and reads the checkpoint,
whole, and ``TrainStepBuilder.distribute_state`` scatters it to the
ranks' placements; the other ranks rebuild the corpus from the seed.

Usage (CPU-sized defaults)::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 50 \\
        --d-model 128 --layers 2 --seq 64 --batch 8 --spool /tmp/run1
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.train --device cpu --mesh 2x1 --strategy tp_fsdp
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import BlobCheckpointer
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import BlobSeerService
from repro_torch.data import ByteTokenizer, CorpusWriter, ShardedReader
from repro_torch.launch.mesh import make_mesh
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


def build_runtime(args, rank: int = 0):
    """A BlobSeer deployment and a client; under a mesh only rank 0 spools
    to ``--spool`` (the other ranks' deployments stay in memory).  With
    ``--resume-blob``, rank 0 restores the deployment already spooled
    there."""
    spool = args.spool if rank == 0 else None
    kw = dict(n_providers=args.providers, n_meta_shards=4, data_replication=args.replication)
    if spool and args.resume_blob and os.path.exists(os.path.join(spool, "vm.wal")):
        svc = BlobSeerService.restore(spool, os.path.join(spool, "vm.wal"), **kw)
    else:
        svc = BlobSeerService(spool_dir=spool, wal_path=(spool + "/vm.wal") if spool else None,
                              **kw)
    client = svc.client("trainer")
    return svc, client


def _mesh(args):
    """(mesh or None, rank): a ``DxM`` mesh over the process group that
    ``torch.distributed.run`` set up (or the caller brought up), or no
    mesh for ``1x1`` without either."""
    import torch.distributed as dist

    shape = tuple(int(x) for x in args.mesh.split("x"))
    grouped = "RANK" in os.environ or (dist.is_available() and dist.is_initialized())
    if shape == (1, 1) and not grouped:
        return None, 0
    if not grouped:
        raise RuntimeError(f"--mesh {args.mesh} runs under torch.distributed.run "
                           f"--nproc-per-node {shape[0] * shape[1]}")
    if args.device.startswith("cuda"):
        if "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        args.device = "cuda"
    if not dist.is_initialized():
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    return make_mesh(shape, ("data", "model"), device=args.device), dist.get_rank()


def resume_state(args, builder, ckpt, mesh, rank):
    """(state or None, step, reader state): the checkpoint's, or None and
    a fresh start.  Rank 0 reads it, whole; under a mesh the other ranks
    learn from rank 0 whether and where it resumed, hold zeros of the
    state's shapes, and the state is scattered from rank 0 to its
    placements (the step counters, plain tensors, broadcast)."""
    state, found = None, None
    if rank == 0:
        try:
            state, manifest = ckpt.restore(builder.abstract_state(), with_manifest=True,
                                           device=args.device)
            ckpt.load_digest_cache()
            found = (manifest["step"], manifest["extra"].get("reader"))
        except (FileNotFoundError, KeyError):
            pass
    if mesh is None:
        return (state,) + (found or (0, None))
    import torch.distributed as dist

    box = [found]
    dist.broadcast_object_list(box, src=0)
    if box[0] is None:
        return None, 0, None
    if state is None:
        state = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=args.device),
                         builder.abstract_state())
    state = builder.distribute_state(state)
    for t in (state["step"], state["opt"]["count"]):
        dist.broadcast(t, src=0)
    return (state,) + box[0]


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
    ap.add_argument("--mesh", default="1x1",
                    help="DxM over (data, model); other than 1x1 under torch.distributed.run")
    ap.add_argument("--strategy", default="tp",
                    help="partitioning strategy (distributed.partitioning); a _zero2 "
                         "suffix gathers the parameters once a step")
    ap.add_argument("--corpus-docs", type=int, default=200)
    ap.add_argument("--resume-blob", default=None)
    ap.add_argument("--corpus-blob", default=None)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mesh, rank = _mesh(args)

    tok = ByteTokenizer()
    cfg = get_config(args.arch).reduced(
        d_model=args.d_model, n_layers=args.layers, n_heads=args.heads,
        n_kv_heads=min(args.heads, get_config(args.arch).n_kv_heads),
        d_head=args.d_model // args.heads,
        d_ff=args.d_ff if get_config(args.arch).d_ff else 0,
        vocab_size=tok.vocab_size + 1,
    )
    svc, client = build_runtime(args, rank)

    # ---- corpus (ingestion substrate) ----
    corpus_blob = args.corpus_blob if rank == 0 else None   # only rank 0 restores
    writer = CorpusWriter(client, corpus_blob, psize=16 * 1024)
    if corpus_blob is None:
        synthesize_corpus(writer, tok, args.corpus_docs)

    # ---- model + step ----
    model = build_model(cfg)
    builder = TrainStepBuilder(
        model, mesh, strategy=args.strategy,
        opt=AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps),
        remat_policy="none", accum=args.accum, zero2="_zero2" in args.strategy,
    )
    quiet = args.quiet or rank != 0

    # ---- checkpoint lineage (resume if one exists) ----
    ckpt = BlobCheckpointer(client, args.resume_blob if rank == 0 else None,
                            psize=16 * 1024, header_pages=16)
    state, start_step, reader_state = resume_state(args, builder, ckpt, mesh, rank)
    if state is None:
        state = builder.init_state(torch.Generator(device=args.device).manual_seed(0))
    elif not quiet:
        print(f"[resume] blob={ckpt.blob_id} step={start_step}")

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
        if not quiet and (step % 10 == 0 or step == args.steps - 1):
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
        if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
            stats = ckpt.save(state, step=step + 1,
                              extra={"reader": reader.state_dict()})
            if not quiet:
                print(f"[ckpt] v{stats.version} step {stats.step} "
                      f"wrote {stats.pages_written}/{stats.pages_total} pages "
                      f"(sharing {stats.sharing_fraction:.0%})")
    wall = time.time() - t0
    return {
        "losses": losses, "wall_s": wall, "ckpt_blob": ckpt.blob_id,
        "corpus_blob": writer.blob_id, "final_step": args.steps,
        "service": svc, "client": client, "state": state, "rank": rank,
    }


if __name__ == "__main__":
    out = main()
    if out["rank"] == 0:
        print(f"done: {len(out['losses'])} steps in {out['wall_s']:.1f}s, "
              f"final loss {out['losses'][-1]:.4f}")
    if "RANK" in os.environ:
        import torch.distributed as dist

        dist.destroy_process_group()
