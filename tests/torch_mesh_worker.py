"""One rank of the port's two-rank mesh check (``test_torch_distributed.py``).

Run as two processes with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` set (and ``GLOO_SOCKET_IFNAME=lo`` on a host whose name
does not resolve)::

    python tests/torch_mesh_worker.py IN.npz OUT_DIR
    python tests/torch_mesh_worker.py vocab IN.npz OUT_DIR
    python tests/torch_mesh_worker.py paths IN.npz OUT_DIR
    python tests/torch_mesh_worker.py splice-heads IN.npz OUT_DIR    # WORLD_SIZE=4
    python tests/torch_mesh_worker.py strategies IN.npz OUT_DIR      # WORLD_SIZE=4
    python tests/torch_mesh_worker.py configs IN.npz OUT_DIR         # WORLD_SIZE=4
    python -m torch.distributed.run --nproc-per-node 2 tests/torch_mesh_worker.py \\
        train-main LOSSES.json --mesh 2x1 --device cpu ...
    python -m torch.distributed.run --nproc-per-node 2 tests/torch_mesh_worker.py \\
        train-resume LOSSES.json SPOOL --mesh 2x1 --device cpu ...

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
loss's gold logit on split logits).  With ``paths`` they run
``train_moe_tp`` and ``train_moe_fsdp`` (one ``tp`` step of reduced
granite-moe-1b-a400m on mesh (1, 2), its experts split over "model", and
one ``tp_fsdp`` step on (2, 1)), ``train_xlstm`` (one ``tp`` step of
reduced xlstm-350m on (1, 2)), ``serve_encdec`` (a ``tp_serve`` prefill
of reduced seamless-m4t-large-v2 on (1, 2), its memories split by kv
heads, and teacher-forced decode steps) and ``generate`` (greedy
``launch.serve.generate`` of reduced h2o-danube3-4b under ``tp_serve_sm``
on (1, 2)).  With ``splice-heads``, four ranks (``WORLD_SIZE=4``) run on
mesh (2, 2) ``train_vlm`` and ``prefill_vlm`` under ``tp`` (a step, and a
prefill and decode steps, of reduced internvl2-76b with ``vision_embeds``
spliced in and an even vocabulary that "model" splits) and
``train_rg_heads`` and ``train_qwen_heads`` under ``tp_fsdp`` (a step of
reduced recurrentgemma-2b and of reduced qwen1.5-32b with 3 heads, which
"model" does not divide, their other dimensions split over "data").  With ``strategies``, four ranks on mesh (2, 2) run the last
three strategies of the reference, each case through the port's entry
points (see ``strategies_main``).  With ``configs``, four ranks on mesh
(2, 2) run the configurations that the port once did not run under a
mesh (training past 4096 kv positions, the encoder-decoder under
``_uneven``, ``tp_serve_hd`` and ``tp_fsdp_sp``, the MoE and xLSTM over a
split sequence; see ``configs_main``).  With
``train-main`` it runs ``repro_torch.launch.train.main``
with the arguments that follow, under the launcher, and rank 0 writes the
losses; with ``train-resume`` it runs it three times: 6 steps, then 3
steps spooled to ``SPOOL``, then 6 steps resumed from that spool
(``--resume-blob``), and rank 0 writes the uninterrupted run's losses and
the resumed run's.
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
          arch="olmo-1b", inputs=None, vocab=None, over=None):
    """One step; the parameters come from ``npz[<inputs>/...]`` (by default
    ``olmo``, or ``olmo_kv1`` with one kv head), the batch from
    ``npz[<inputs>_batch/...]`` (by default ``batch``); ``over`` replaces
    fields of the reduced config."""
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, **{"n_kv_heads": kv or cfg.n_kv_heads,
                                       "vocab_size": vocab or cfg.vocab_size, **(over or {})})
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
    wq = [g["mixer"]["wq"] for g in state["params"].get("groups", ())
          if "wq" in g.get("mixer", {})]
    if wq:
        out[f"{name}/placements"] = np.asarray(str(wq[0].placements))
    table = state["params"]["embed"]["table"]
    out[f"{name}/table_placements"] = np.asarray(str(table.placements))
    out[f"{name}/table_local_shape"] = np.asarray(table.to_local().shape)
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


def train_resume(out_path, spool, argv) -> int:
    """``launch.train.main``: 6 steps uninterrupted; 3 steps spooled to
    ``spool`` (its last checkpoint at step 3); 6 steps resumed from the
    spool.  Rank 0 writes {"whole": [...], "resumed": [...]}."""
    from repro_torch.launch.train import main as launch_main

    try:
        whole = launch_main(argv + ["--steps", "6"])["losses"]
        if int(os.environ["RANK"]) == 0:
            os.makedirs(spool, exist_ok=True)
        first = launch_main(argv + ["--steps", "3", "--spool", spool])
        resumed = launch_main(argv + ["--steps", "6", "--spool", spool,
                                      "--resume-blob", first["ckpt_blob"],
                                      "--corpus-blob", first["corpus_blob"]])
        if resumed["rank"] == 0:
            with open(out_path, "w") as f:
                json.dump({"whole": whole, "first": first["losses"],
                           "resumed": resumed["losses"]}, f)
    finally:
        dist.destroy_process_group()
    return 0


def serve_encdec(npz, meta, out, mesh, name):
    """A ``tp_serve`` prefill of the reduced encoder-decoder and
    teacher-forced decode steps over the memories it returns."""
    cfg = get_config("seamless-m4t-large-v2").reduced()
    model = build_model(cfg)
    builder = TrainStepBuilder(model, mesh, strategy="tp_serve")
    params = tree_from(npz, name, model.abstract()[0])
    params = builder.distribute(params, builder.param_shardings(params), src_data_rank=None)
    toks = torch.from_numpy(npz[f"{name}_in/tokens"]).long()
    frames = torch.from_numpy(npz[f"{name}_in/frames"])
    B, T = toks.shape
    t0 = meta["prefill"]
    cache = builder.shard_cache(model.init_cache(B, T + 4, device="cpu"))
    prefill, decode = builder.prefill_step_fn(), builder.decode_step_fn()
    logits, cache, memories = prefill(params, {"tokens": toks[:, :t0], "enc_embeds": frames},
                                      cache)
    outs = [logits]
    for t in range(t0, T):
        logits, cache = decode(params, toks[:, t], t, cache, memories)
        outs.append(logits)
    out[f"{name}/logits"] = torch.stack(outs).numpy()
    out[f"{name}/memories_placements"] = np.asarray(str(memories[0].placements))


def generate_tokens(npz, meta, out, mesh, name):
    from repro_torch.launch.serve import generate

    cfg = get_config(SERVE_ARCH).reduced()
    model = build_model(cfg)
    params = tree_from(npz, name, model.abstract()[0])
    prompts = list(npz[f"{name}_in/prompts"])
    got = generate(model, params, prompts, max_new=meta["max_new"],
                   max_len=len(prompts[0]) + meta["max_new"], device="cpu", mesh=mesh,
                   strategy="tp_serve_sm")
    out[f"{name}/tokens"] = np.stack(got)


def prefill_vlm(npz, meta, out, mesh, name, strategy):
    """Prefill of the reduced VLM over tokens and ``vision_embeds``, then
    teacher-forced decode steps."""
    cfg = dataclasses.replace(get_config("internvl2-76b").reduced(), vocab_size=meta["vocab"])
    model = build_model(cfg)
    builder = TrainStepBuilder(model, mesh, strategy=strategy)
    params = tree_from(npz, name, model.abstract()[0])
    params = builder.distribute(params, builder.param_shardings(params), src_data_rank=None)
    toks = torch.from_numpy(npz[f"{name}_in/tokens"]).long()
    vision = torch.from_numpy(npz[f"{name}_in/vision_embeds"])
    B, T = toks.shape
    t0 = meta["prefill"]
    cache = builder.shard_cache(model.init_cache(B, T + 4, device="cpu"))
    prefill, decode = builder.prefill_step_fn(), builder.decode_step_fn()
    logits, cache = prefill(params, {"tokens": toks[:, :t0], "vision_embeds": vision}, cache)
    outs = [logits]
    for t in range(t0, T):
        logits, cache = decode(params, toks[:, t], t, cache)
        outs.append(logits)
    out[f"{name}/logits"] = torch.stack(outs).numpy()
    out[f"{name}/table_placements"] = np.asarray(str(params["embed"]["table"].placements))


def _attention_cache(cache):
    """The first attention layer's cache entry (its "k" leaf)."""
    return next(e for e in cache["groups"] + cache["rest"] if "k" in e)


def serve_steps(npz, meta, out, mesh, name, arch, strategy, over):
    """A prefill of ``npz[<name>_in/tokens][:, :prefill[name]]`` and teacher-forced
    decode steps of the rest under ``strategy``; the logits of each, the
    first attention cache's placements and local shape after the last
    step, and the placements of the first ``wq``."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    model = build_model(cfg)
    builder = TrainStepBuilder(model, mesh, strategy=strategy)
    params = tree_from(npz, name, model.abstract()[0])
    params = builder.distribute(params, builder.param_shardings(params), src_data_rank=None)
    toks = torch.from_numpy(npz[f"{name}_in/tokens"]).long()
    B, T = toks.shape
    t0 = meta["prefill"][name]
    cache = builder.shard_cache(model.init_cache(B, T + 4, device="cpu"))
    prefill, decode = builder.prefill_step_fn(), builder.decode_step_fn()
    logits, cache = prefill(params, {"tokens": toks[:, :t0]}, cache)
    outs = [logits]
    for t in range(t0, T):
        logits, cache = decode(params, toks[:, t], t, cache)
        outs.append(logits)
    out[f"{name}/logits"] = torch.stack(outs).numpy()
    k = _attention_cache(cache)["k"]
    out[f"{name}/cache_placements"] = np.asarray(str(k.placements))
    out[f"{name}/cache_local_shape"] = np.asarray(k.to_local().shape)
    wq = next(g["mixer"]["wq"] for g in params["groups"] if "wq" in g["mixer"])
    out[f"{name}/wq_placements"] = np.asarray(str(wq.placements))
    out[f"{name}/wq_local_shape"] = np.asarray(wq.to_local().shape)


class _ConstrainSpy:
    """Records the placements of the first output of ``lm``'s ``constrain``
    (the embedding's, (B, T, D); or of ``module``'s) while installed."""

    def __init__(self, module=None):
        if module is None:
            from repro_torch.models import lm as module

        self.lm, self.real, self.seen = module, module.constrain, []

    def __enter__(self):
        def spy(x, *names):
            y = self.real(x, *names)
            self.seen.append(str(y.placements))
            return y

        self.lm.constrain = spy
        return self

    def __exit__(self, *exc):
        self.lm.constrain = self.real


def strategies_main(in_path, out_dir) -> int:
    """The reference's last three strategies on mesh (2, 2) of four ranks:

    * ``serve_hd_qwen``, ``serve_hd_rg``: ``tp_serve_hd`` prefill and decode
      steps of reduced qwen1.5-32b (3 heads, 3 kv heads, head_dim 8) and
      reduced recurrentgemma-2b (1 kv head), the caches split on their
      head dimension;
    * ``prefill_uneven_qwen``: ``tp_serve_uneven`` prefill and decode steps
      of reduced qwen1.5-32b with 3 heads, split 2 + 1 over "model";
    * ``train_uneven_qwen``, ``train_uneven_rg``: ``tp_fsdp_uneven`` steps
      of reduced qwen1.5-32b and recurrentgemma-2b with 3 heads;
    * ``train_uneven_vocab``: a ``tp_uneven`` step of reduced
      granite-moe-1b-a400m with an odd vocabulary, split unevenly;
    * ``sp_train_rg``, ``sp_prefill_danube``: ``tp_fsdp_sp`` with a batch
      of 1, a train step of reduced recurrentgemma-2b and a prefill and
      decode steps of reduced h2o-danube3-4b, the sequence split over
      "data" (the placements of the embedding's constrained output)."""
    npz = np.load(in_path)
    meta = json.loads(str(npz["meta"]))
    dist.init_process_group("gloo")
    out: dict = {}
    try:
        square = make_mesh((2, 2), ("data", "model"), device="cpu")
        for case, (arch, strategy) in meta["serve"].items():
            with _ConstrainSpy() as spy:
                serve_steps(npz, meta, out, square, case, arch, strategy, meta["over"][case])
            out[f"{case}/embed_placements"] = np.asarray(spy.seen[0])
        for case, (arch, strategy) in meta["train"].items():
            with _ConstrainSpy() as spy:
                train(npz, meta, out, square, case, strategy, False, 1, arch=arch, inputs=case,
                      over=meta["over"][case])
            out[f"{case}/embed_placements"] = np.asarray(spy.seen[0])
        if dist.get_rank() == 0:
            np.savez(os.path.join(out_dir, "out.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


class _FlashSpy:
    """Records each call of ``ops.flash_attention`` (the recorded op on
    local tensors) while installed: q's and k's shapes, ``q_offset``,
    ``window``, and whether autograd records it."""

    def __init__(self):
        from repro_torch.kernels import ops

        self.ops, self.real, self.calls = ops, ops.flash_attention, []

    def __enter__(self):
        def spy(q, k, v, **kw):
            self.calls.append([list(q.shape), list(k.shape), kw.get("q_offset", 0),
                               kw.get("window"), self.ops._recorded(q, k, v)])
            return self.real(q, k, v, **kw)

        self.ops.flash_attention = spy
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.real


class _HeadDimGatherSpy:
    """Records each ``DTensor.redistribute`` made inside the encoder-decoder's
    ``cross_memories`` or ``_decoder_cached`` while installed (where the
    memories and the cache are made and read) that takes a tensor split on
    its last (head) dimension to placements where it is not: a gather of
    the head dimension.  Only tensors whose next-to-last dimension is one
    of ``lengths`` (the memories' frames, the cache's slots) are recorded."""

    def __init__(self, lengths):
        from torch.distributed.tensor import DTensor

        from repro_torch.models import encdec

        self.cls, self.real, self.lengths, self.seen = DTensor, DTensor.redistribute, lengths, []
        self.encdec, self.scopes, self.inside = encdec, ("cross_memories", "_decoder_cached"), 0

    def __enter__(self):
        real, lengths, seen = self.real, self.lengths, self.seen

        def spy(t, device_mesh=None, placements=None, **kw):
            last = t.ndim - 1
            if (self.inside and t.ndim >= 4 and t.shape[-2] in lengths
                    and placements is not None
                    and any(p.is_shard(last) for p in t.placements)
                    and not any(p.is_shard(last) for p in placements)):
                seen.append([list(t.shape), str(t.placements), str(tuple(placements))])
            return real(t, device_mesh, placements, **kw)

        def scoped(fn):
            def run(*a, **k):
                self.inside += 1
                try:
                    return fn(*a, **k)
                finally:
                    self.inside -= 1
            return run

        self.fns = {name: getattr(self.encdec, name) for name in self.scopes}
        for name, fn in self.fns.items():
            setattr(self.encdec, name, scoped(fn))
        self.cls.redistribute = spy
        return self

    def __exit__(self, *exc):
        self.cls.redistribute = self.real
        for name, fn in self.fns.items():
            setattr(self.encdec, name, fn)


class _RouteSpy:
    """Records each call of ``moe.route`` while installed: its input (the
    MoE layer's (B, T, D) rows) and the kept (token, choice) pairs, each
    gathered whole."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.real, self.x, self.kept = moe, moe.route, [], []

    def __enter__(self):
        from repro_torch.distributed.partitioning import full

        def spy(p, cfg, x):
            out = self.real(p, cfg, x)
            self.x.append(full(x).detach().numpy())
            self.kept.append(full(out[4]).numpy())
            return out

        self.moe.route = spy
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real


def serve_case(npz, meta, out, mesh, name, arch, strategy, over):
    """A prefill of ``npz[<name>_in/tokens][:, :prefill[name]]`` (over
    ``<name>_in/frames`` for the encoder-decoder) and teacher-forced decode
    steps of the rest under ``strategy``: the logits of each, the
    placements of the first cache leaf (and of the memories), and every
    head-dimension gather of the memories or the cache."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    model = build_model(cfg)
    builder = TrainStepBuilder(model, mesh, strategy=strategy)
    params = tree_from(npz, name, model.abstract()[0])
    params = builder.distribute(params, builder.param_shardings(params), src_data_rank=None)
    toks = torch.from_numpy(npz[f"{name}_in/tokens"]).long()
    batch = {"tokens": toks[:, :meta["prefill"][name]]}
    if f"{name}_in/frames" in npz.files:
        batch["enc_embeds"] = torch.from_numpy(npz[f"{name}_in/frames"])
    B, T = toks.shape
    cache = builder.shard_cache(model.init_cache(B, T + 4, device="cpu"))
    lengths = {T + 4} | ({batch["enc_embeds"].shape[1]} if "enc_embeds" in batch else set())
    prefill, decode = builder.prefill_step_fn(), builder.decode_step_fn()
    with _HeadDimGatherSpy(lengths) as gathers:
        logits, cache, *memories = prefill(params, batch, cache)
        outs = [logits]
        for t in range(batch["tokens"].shape[1], T):
            logits, cache = decode(params, toks[:, t], t, cache, *memories)
            outs.append(logits)
    out[f"{name}/logits"] = torch.stack(outs).numpy()
    first = next(t for _, t in flatten_with_paths(cache))
    out[f"{name}/cache_placements"] = np.asarray(str(first.placements))
    if memories:
        out[f"{name}/memories_placements"] = np.asarray(str(memories[0][0].placements))
    out[f"{name}/head_dim_gathers"] = np.asarray(json.dumps(gathers.seen))


def configs_main(in_path, out_dir) -> int:
    """The configurations the reference runs under a mesh that the port
    once did not, on mesh (2, 2) of four ranks: each of ``meta["train"]``
    one step (``train``), each of ``meta["serve"]`` a prefill and
    teacher-forced decode steps (``serve_case``).  For every case the
    placements of the embedding's constrained output (the encoder's first
    norm's for the encoder-decoder), every rank's calls of
    ``ops.flash_attention``, and each MoE routing's input and kept
    pairs."""
    from repro_torch.models import layers, lm

    npz = np.load(in_path)
    meta = json.loads(str(npz["meta"]))
    dist.init_process_group("gloo")
    out: dict = {}
    try:
        square = make_mesh((2, 2), ("data", "model"), device="cpu")
        for kind in ("train", "serve"):
            for case, (arch, strategy) in meta[kind].items():
                # the encoder-decoder's first split activation is its first norm's
                module = layers if arch == "seamless-m4t-large-v2" else lm
                with _ConstrainSpy(module) as spy, _FlashSpy() as flash, _RouteSpy() as route:
                    if kind == "train":
                        train(npz, meta, out, square, case, strategy, False, 1, arch=arch,
                              inputs=case, over=meta["over"][case])
                    else:
                        serve_case(npz, meta, out, square, case, arch, strategy,
                                   meta["over"][case])
                for i, (x, kept) in enumerate(zip(route.x, route.kept)):
                    out[f"{case}/route_x/{i}"], out[f"{case}/route_kept/{i}"] = x, kept
                calls = [None] * dist.get_world_size()
                dist.all_gather_object(calls, flash.calls)
                out[f"{case}/embed_placements"] = np.asarray(spy.seen[0])
                out[f"{case}/flash_calls"] = np.asarray(json.dumps(calls))
        if dist.get_rank() == 0:
            np.savez(os.path.join(out_dir, "out.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


def splice_heads_main(in_path, out_dir) -> int:
    """The VLM splice on a vocab-split table, and heads that "model" does
    not divide (see the module docstring), on mesh (2, 2) of four ranks."""
    npz = np.load(in_path)
    meta = json.loads(str(npz["meta"]))
    dist.init_process_group("gloo")
    out: dict = {}
    try:
        square = make_mesh((2, 2), ("data", "model"), device="cpu")
        train(npz, meta, out, square, "train_vlm", "tp", False, 1, arch="internvl2-76b",
              inputs="vlm", vocab=meta["vocab"])
        prefill_vlm(npz, meta, out, square, "prefill_vlm", "tp")
        for arch, case in (("recurrentgemma-2b", "rg"), ("qwen1.5-32b", "qwen")):
            train(npz, meta, out, square, f"train_{case}_heads", "tp_fsdp", False, 1,
                  arch=arch, inputs=case, over=meta["heads"][arch])
        if dist.get_rank() == 0:
            np.savez(os.path.join(out_dir, "out.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


def paths_main(in_path, out_dir) -> int:
    """The mesh paths the port once refused (see the module docstring)."""
    npz = np.load(in_path)
    meta = json.loads(str(npz["meta"]))
    dist.init_process_group("gloo")
    out: dict = {}
    try:
        row = make_mesh((1, 2), ("data", "model"), device="cpu")
        moe = "granite-moe-1b-a400m"
        train(npz, meta, out, row, "train_moe_tp", "tp", False, 1, arch=moe, inputs="moe")
        train(npz, meta, out, make_mesh((2, 1), ("data", "model"), device="cpu"),
              "train_moe_fsdp", "tp_fsdp", False, 1, arch=moe, inputs="moe")
        train(npz, meta, out, row, "train_xlstm", "tp", False, 1, arch="xlstm-350m",
              inputs="xlstm", over=dict(block_pattern=tuple(meta["xlstm_blocks"]),
                                        n_layers=len(meta["xlstm_blocks"])))
        serve_encdec(npz, meta, out, row, "serve_encdec")
        generate_tokens(npz, meta, out, row, "generate")
        if dist.get_rank() == 0:
            np.savez(os.path.join(out_dir, "out.npz"), **out)
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
    if sys.argv[1] == "train-resume":
        return train_resume(sys.argv[2], sys.argv[3], sys.argv[4:])
    if sys.argv[1] == "vocab":
        return vocab_main(sys.argv[2], sys.argv[3])
    if sys.argv[1] == "paths":
        return paths_main(sys.argv[2], sys.argv[3])
    if sys.argv[1] == "splice-heads":
        return splice_heads_main(sys.argv[2], sys.argv[3])
    if sys.argv[1] == "strategies":
        return strategies_main(sys.argv[2], sys.argv[3])
    if sys.argv[1] == "configs":
        return configs_main(sys.argv[2], sys.argv[3])
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
