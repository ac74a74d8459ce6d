"""Cheap branching for training experiments (paper §2.1 BRANCH), on the
PyTorch port.

The twin of ``examples/branch_experiments.py``: the same steps, sizes and
prints, on ``repro_torch`` (on the card unless ``--device cpu``).  Train
a base model, then fork the checkpoint lineage at an intermediate step
into two branches with different learning rates — zero bytes are copied
at fork time (copy-on-write snapshots).  Both branches and the trunk
remain fully readable afterwards.

    PYTHONPATH=src python examples/branch_experiments_torch.py [--device cpu]

``main(argv)`` returns the losses of the trunk and of each branch, the
data pages each fork added to the store, each branch's pages written
against the pages it holds, the lineage of every checkpointer and the
trunk restored after branching.
"""

import argparse
import os
import sys

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

BASE_STEPS, BRANCH_STEPS = 40, 40


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    svc = BlobSeerService(n_providers=6, n_meta_shards=4)
    client = svc.client("exp")
    tok = ByteTokenizer()
    writer = CorpusWriter(client, psize=16 * 1024)
    rng = np.random.default_rng(1)
    for i in range(200):
        writer.append_tokens(tok.encode(
            " ".join(f"w{int(rng.integers(0, 50))}" for _ in range(80))))

    cfg = get_config("olmo-1b").reduced(vocab_size=tok.vocab_size + 1)
    model = build_model(cfg)

    def make_step(lr, total):
        # one device, no mesh (the reference runs a 1x1 mesh)
        b = TrainStepBuilder(model, None, strategy="tp",
                             opt=AdamWConfig(lr=lr, warmup_steps=5,
                                             total_steps=total),
                             remat_policy="none")
        return b, b.train_step_fn()

    builder, step_fn = make_step(1e-3, BASE_STEPS + BRANCH_STEPS)
    state = builder.init_state(torch.Generator(device=dev).manual_seed(0))
    reader = ShardedReader(client, writer.blob_id, batch=8, seq_len=32)
    ckpt = BlobCheckpointer(client, psize=16 * 1024, header_pages=16)

    def run(state, reader, steps, step_fn, label):
        losses = []
        for _ in range(steps):
            t, l = reader.next_batch()
            state, m = step_fn(state, {"tokens": torch.as_tensor(t, device=dev),
                                       "labels": torch.as_tensor(l, device=dev)})
            losses.append(float(m["loss"]))
        print(f"[{label}] loss {losses[0]:.3f} -> {losses[-1]:.3f}")
        return state, losses

    # ---- trunk ----
    state, trunk_losses = run(state, reader, BASE_STEPS, step_fn, "trunk")
    st = ckpt.save(state, step=BASE_STEPS, extra={"reader": reader.state_dict()})
    print(f"trunk checkpoint v{st.version} ({st.pages_total} pages)")

    # ---- two branches, forked with zero copying ----
    state_abs = builder.abstract_state()
    results = {}
    for name, lr in [("branch-lowlr", 3e-4), ("branch-highlr", 3e-3)]:
        pages_before = svc.storage_report()["pages"]
        bck = ckpt.branch(st.version)          # O(1) fork
        fork_pages = svc.storage_report()["pages"] - pages_before
        bstate, mani = bck.restore(state_abs, with_manifest=True, device=dev)
        breader = ShardedReader(client, writer.blob_id, batch=8, seq_len=32,
                                state=mani["extra"]["reader"])
        _, bstep = make_step(lr, BASE_STEPS + BRANCH_STEPS)
        bstate, blosses = run(bstate, breader, BRANCH_STEPS, bstep, name)
        bst = bck.save(bstate, step=BASE_STEPS + BRANCH_STEPS)
        results[name] = {"losses": blosses, "fork_pages": fork_pages,
                         "pages_written": bst.pages_written,
                         "pages_total": bst.pages_total, "lineage": bck.steps()}
        print(f"{name}: saved v{bst.version}, "
              f"{bst.pages_written}/{bst.pages_total} pages written "
              f"(rest shared with trunk)")

    # trunk checkpoint is still intact and readable
    trunk = ckpt.restore(state_abs, version=st.version, device=dev)
    n_elements = int(sum(x.numel() for x in tree_leaves(trunk)))
    print("trunk restore after branching: OK,", n_elements, "elements")
    print("storage report:", svc.storage_report())
    return {"trunk": {"losses": trunk_losses, "lineage": ckpt.steps(),
                      "state": state, "version": st.version},
            "branches": results, "trunk_restored": trunk, "trunk_elements": n_elements}


if __name__ == "__main__":
    main()
