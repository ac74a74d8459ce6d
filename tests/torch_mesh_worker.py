"""One rank of the port's two-rank mesh check (``test_torch_distributed.py``).

Run as two processes with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` set (and ``GLOO_SOCKET_IFNAME=lo`` on a host whose name
does not resolve)::

    python tests/torch_mesh_worker.py IN.npz OUT_DIR
    python tests/torch_mesh_worker.py vocab IN.npz OUT_DIR
    python -m torch.distributed.run --nproc-per-node 2 tests/torch_mesh_worker.py \\
        train-main LOSSES.json --mesh 2x1 --device cpu ...

``IN.npz`` holds the inputs: the parameters of reduced olmo-1b and of
reduced h2o-danube3-4b (``<case>/<leaf path>``), a training batch and
the serving tokens.  The ranks join a gloo group and run, through the
port's entry points,

* ``train_zero2``: one ``tp_fsdp`` + ``zero2`` step with ``accum=2`` on
  mesh (2, 1), then a checkpoint of the state (rank 0 writes it to a
  spooled BlobSeer deployment in ``OUT_DIR/spool``);
* ``train_tp``: one ``tp`` step on mesh (1, 2); ``train_tp_kv1`` the
  same with one kv head, which does not divide the "model" axis;
* ``serve_kv2``, ``serve_kv1``: a ``tp_serve_sm`` prefill and decode
  steps of reduced h2o-danube3-4b on mesh (1, 2), with two kv heads and
  with one (which does not divide the "model" axis);

and rank 0 writes what came out to ``OUT_DIR/out.npz``.  With ``vocab``
they run ``train_tp_vocab``: one ``tp`` and one ``tp_fsdp`` step of
reduced olmo-1b and one ``tp`` step of the reduced encoder-decoder, each
with an even vocabulary that the "model" axis of mesh (1, 2) splits (the
loss's gold logit on split logits).  With
``train-main`` it runs ``repro_torch.launch.train.main`` with the
arguments that follow, under the launcher, and rank 0 writes the losses.
Only the port is imported here; the tests hold the results to the
reference or to a run on one device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch.checkpoint import BlobCheckpointer  # noqa: E402
from repro_torch.checkpoint.blobckpt import flatten_with_paths  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import BlobSeerService  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import AdamWConfig, TrainStepBuilder, adamw_init  # noqa: E402

SERVE_ARCH = "h2o-danube-3-4b"


def tree_from(npz, prefix, like):
    """``like``'s tree with each leaf read from ``npz[prefix/path]``."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        return torch.from_numpy(np.array(npz["/".join((prefix,) + path)]))

    return walk(like, ())


def whole(tree, prefix):
    return {f"{prefix}/{k}": (t.full_tensor() if hasattr(t, "full_tensor") else t).numpy()
            for k, t in flatten_with_paths(tree)}


def train(npz, meta, out, mesh, name, strategy, zero2, accum, kv=None, spool=None,
          arch="olmo-1b", inputs=None, vocab=None):
    """One step; the parameters come from ``npz[<inputs>/...]`` (by default
    ``olmo``, or ``olmo_kv1`` with one kv head), the batch from
    ``npz[<inputs>_batch/...]`` (by default ``batch``)."""
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, n_kv_heads=kv or cfg.n_kv_heads,
                              vocab_size=vocab or cfg.vocab_size)
    model = build_model(cfg)
    builder = TrainStepBuilder(model, mesh, strategy=strategy, accum=accum, zero2=zero2,
                               opt=AdamWConfig(**meta["opt"]))
    prefix = inputs or ("olmo_kv1" if kv == 1 else "olmo")
    params = tree_from(npz, prefix, model.abstract()[0])
    state = builder.distribute_state(
        {"params": params, "opt": adamw_init(params), "step": torch.zeros((), dtype=torch.int32)},
        src_data_rank=None)
    bkey = f"{inputs}_batch" if inputs else "batch"
    batch = {k[len(bkey) + 1:]: torch.from_numpy(npz[k]) for k in npz.files
             if k.startswith(bkey + "/")}
    batch = {k: v.long() if k in ("tokens", "labels") else v for k, v in batch.items()}
    state, metrics = builder.train_step_fn()(state, batch)
    out[f"{name}/loss"] = np.asarray(float(metrics["loss"]))
    out[f"{name}/grad_norm"] = np.asarray(float(metrics["grad_norm"]))
    out.update(whole(state["params"], f"{name}/params"))
    out.update(whole(state["opt"]["mu"], f"{name}/mu"))
    if "groups" in state["params"]:
        out[f"{name}/placements"] = np.asarray(
            str(state["params"]["groups"][0]["mixer"]["wq"].placements))
    if spool is not None:
        rank0 = dist.get_rank() == 0
        if rank0:
            os.makedirs(spool, exist_ok=True)
        svc = (BlobSeerService(n_providers=4, n_meta_shards=2, spool_dir=spool,
                               wal_path=spool + "/vm.wal") if rank0
               else BlobSeerService(n_providers=4, n_meta_shards=2))
        ckpt = BlobCheckpointer(svc.client(), psize=4096, header_pages=16)
        stats = ckpt.save(state, step=1)
        if rank0:
            out[f"{name}/ckpt_blob"] = np.asarray(ckpt.blob_id)
            out[f"{name}/ckpt_pages"] = np.asarray(stats.pages_written)
        elif stats is not None:
            raise AssertionError("a rank other than 0 wrote a checkpoint")


def serve(npz, meta, out, mesh, name, kv):
    cfg = dataclasses.replace(get_config(SERVE_ARCH).reduced(), n_kv_heads=kv)
    model = build_model(cfg)
    builder = TrainStepBuilder(model, mesh, strategy="tp_serve_sm")
    params = tree_from(npz, name, model.abstract()[0])
    params = builder.distribute(params, builder.param_shardings(params), src_data_rank=None)
    toks = torch.from_numpy(npz["serve/tokens"]).long()
    B, T = toks.shape
    t0 = meta["prefill"]
    cache = builder.shard_cache(model.init_cache(B, T + 4, device="cpu"))
    prefill, decode = builder.prefill_step_fn(), builder.decode_step_fn()
    logits, cache = prefill(params, {"tokens": toks[:, :t0]}, cache)
    outs = [logits]
    for t in range(t0, T):
        logits, cache = decode(params, toks[:, t], t, cache)
        outs.append(logits)
    out[f"{name}/logits"] = torch.stack(outs).numpy()
    out[f"{name}/cache_placements"] = np.asarray(str(cache["groups"][0]["k"].placements))


def train_main(out_path, argv) -> int:
    """``repro_torch.launch.train.main(argv)`` on this rank; rank 0 writes
    the losses to ``out_path`` as JSON."""
    from repro_torch.launch.train import main as launch_main

    out = launch_main(argv)
    try:
        if out["rank"] == 0:
            with open(out_path, "w") as f:
                json.dump(out["losses"], f)
    finally:
        dist.destroy_process_group()
    return 0


def vocab_main(in_path, out_dir) -> int:
    """``train_tp_vocab``: the vocabulary split over "model" (mesh (1, 2))."""
    npz = np.load(in_path)
    meta = json.loads(str(npz["meta"]))
    dist.init_process_group("gloo")
    out: dict = {}
    try:
        mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
        vocab = meta["vocab"]
        train(npz, meta, out, mesh, "train_tp_vocab", "tp", False, 1, vocab=vocab)
        train(npz, meta, out, mesh, "train_tp_fsdp_vocab", "tp_fsdp", False, 1, vocab=vocab)
        train(npz, meta, out, mesh, "train_encdec_vocab", "tp", False, 1,
              arch="seamless-m4t-large-v2", inputs="encdec", vocab=vocab)
        if dist.get_rank() == 0:
            np.savez(os.path.join(out_dir, "out.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


def main() -> int:
    torch.set_num_threads(1)
    if sys.argv[1] == "train-main":
        return train_main(sys.argv[2], sys.argv[3:])
    if sys.argv[1] == "vocab":
        return vocab_main(sys.argv[2], sys.argv[3])
    npz = np.load(sys.argv[1])
    out_dir = sys.argv[2]
    meta = json.loads(str(npz["meta"]))
    dist.init_process_group("gloo")
    out: dict = {}
    try:
        train(npz, meta, out, make_mesh((2, 1), ("data", "model"), device="cpu"),
              "train_zero2", "tp_fsdp", True, 2, spool=os.path.join(out_dir, "spool"))
        mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
        train(npz, meta, out, mesh, "train_tp", "tp", False, 1)
        train(npz, meta, out, mesh, "train_tp_kv1", "tp", False, 1, kv=1)
        serve(npz, meta, out, mesh, "serve_kv2", 2)
        serve(npz, meta, out, mesh, "serve_kv1", 1)
        if dist.get_rank() == 0:
            np.savez(os.path.join(out_dir, "out.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
