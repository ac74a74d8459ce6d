"""Batched serving driver: prefill + decode, on one device or under a mesh.

Serves a (reduced or full) arch config with batched requests; greedy or
temperature sampling.  The counterpart of ``repro.launch.serve``: with a
``mesh``, ``generate`` places the parameters and the cache by the
strategy's rules and drives ``TrainStepBuilder``'s serve steps (logits
whole on every rank, so every rank samples the same tokens).  As the
reference's, ``main`` serves under a (1, 1) mesh when a process group
exists or ``torch.distributed.run`` started it, and on one device
otherwise.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
        --prompt "hello world" --max-new 32
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 1 \
        -m repro_torch.launch.serve --device cpu
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import ByteTokenizer
from repro_torch.launch.train import _mesh
from repro_torch.models import build_model
from repro_torch.train.step import TrainStepBuilder


def generate(
    model,
    params,
    prompts: List[np.ndarray],
    *,
    max_new: int,
    max_len: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    mesh=None,
    strategy: str = "tp",
) -> List[np.ndarray]:
    """Greedy/temperature generation for a batch of equal-length prompts.

    ``params`` must live on ``device``.  Sampling draws from
    ``generator`` (a ``torch.Generator`` on ``device``) when
    ``temperature > 0``.  Returns each prompt followed by its new tokens.
    With a ``DeviceMesh`` the parameters (whole on every rank, or already
    placed) and the cache are placed by ``strategy``'s rules and the
    builder's ``prefill_step_fn``/``decode_step_fn`` run the steps.
    Decoder-only models, as the reference's ``generate``: an
    encoder-decoder is driven through its ``Model.prefill`` and
    ``Model.decode_step`` with the memories the prefill returns.
    Runs under ``torch.inference_mode`` on one device and under
    ``torch.no_grad`` on a mesh: in inference mode DTensor sends the ops
    it would shard through its decompositions and a fake-tensor shape
    pass, which multiplies the host time of a decode step.
    """
    with torch.inference_mode() if mesh is None else torch.no_grad():
        return _generate(model, params, prompts, max_new=max_new, max_len=max_len,
                         temperature=temperature, generator=generator, device=device,
                         mesh=mesh, strategy=strategy)


def _generate(model, params, prompts, *, max_new, max_len, temperature, generator, device,
              mesh, strategy):
    if model.cfg.arch_kind != "decoder":
        raise NotImplementedError(
            f"generate serves decoder-only models, not arch_kind {model.cfg.arch_kind!r}: "
            f"call Model.prefill with enc_embeds, then Model.decode_step with its memories")
    B = len(prompts)
    T0 = len(prompts[0])
    if any(len(p) != T0 for p in prompts):
        raise ValueError("pad prompts to equal length")
    if T0 + max_new > max_len:
        raise ValueError(f"prompt {T0} + max_new {max_new} exceeds max_len {max_len}")
    tokens = torch.as_tensor(np.stack(prompts).astype(np.int64), device=device)
    cache = model.init_cache(B, max_len, device=device)
    prefill, decode = model.prefill, model.decode_step
    if mesh is not None:
        builder = TrainStepBuilder(model, mesh, strategy=strategy)
        params = builder.distribute(params, builder.param_shardings(params), src_data_rank=None)
        cache = builder.shard_cache(cache)
        prefill, decode = builder.prefill_step_fn(), builder.decode_step_fn()

    logits, cache = prefill(params, {"tokens": tokens}, cache)
    new = []
    for i in range(max_new):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            tok = torch.argmax(logits, dim=-1)
        new.append(tok)
        if i + 1 < max_new:   # the last token's logits are never read
            logits, cache = decode(params, tok, T0 + i, cache)
    out = torch.stack(new, dim=1).cpu().numpy() if new else np.zeros((B, 0), np.int64)
    return [np.concatenate([np.asarray(p), o]).astype(np.int32) for p, o in zip(prompts, out)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=ARCH_IDS)
    ap.add_argument("--prompt", default="the quick brown fox")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mesh, rank = _mesh(argparse.Namespace(mesh="1x1", device=args.device))

    tok = ByteTokenizer()
    cfg = get_config(args.arch).reduced(
        d_model=args.d_model, n_layers=args.layers,
        vocab_size=tok.vocab_size + 1,
    )
    model = build_model(cfg)
    params = model.init(torch.Generator(device=args.device).manual_seed(0))
    ids = tok.encode(args.prompt, add_special=True)
    prompts = [ids for _ in range(args.batch)]

    t0 = time.time()
    outs = generate(model, params, prompts, max_new=args.max_new,
                    max_len=len(ids) + args.max_new + 1,
                    temperature=args.temperature,
                    generator=torch.Generator(device=args.device).manual_seed(0),
                    device=args.device, mesh=mesh)
    dt = time.time() - t0
    n_tok = args.batch * args.max_new
    if rank == 0:
        where = args.device if mesh is None else "a (1, 1) mesh"
        print(f"generated {n_tok} tokens in {dt:.2f}s on {where} "
              f"({n_tok/dt:.1f} tok/s, untrained model)")
        print("sample:", tok.decode(outs[0][len(ids):]))
    return outs


if __name__ == "__main__":
    main()
    if "RANK" in os.environ:
        import torch.distributed as dist

        dist.destroy_process_group()
