"""Model facade: a uniform API over the ported architectures.

``build_model(cfg)`` returns a :class:`Model` whose methods are plain
functions of (params, batch); the serving driver and the tests drive
models only through it.  Decoder-only archs are ported; encoder-decoder
is not yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.models import lm as LM
from repro_torch.models.config import ModelConfig


@dataclass
class Model:
    cfg: ModelConfig
    init: Callable          # generator -> params, on the generator's device
    loss_fn: Callable       # (params, batch, remat_policy="none") -> (loss, metrics)
    init_cache: Callable    # (batch, max_len, device="cuda") -> cache
    prefill: Callable       # (params, batch, cache) -> (logits, cache)
    decode_step: Callable   # (params, token, pos, cache) -> (logits, cache)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.arch_kind != "decoder":
        raise NotImplementedError(f"arch_kind {cfg.arch_kind!r} is not ported to repro_torch yet")

    def init(gen):
        return LM.init_lm(gen, cfg)

    def loss_fn(params, batch, remat_policy="none"):
        return LM.lm_loss(params, cfg, batch, remat_policy)

    def init_cache(batch, max_len, device="cuda"):
        return LM.init_lm_cache(cfg, batch, max_len, device)

    def prefill(params, batch, cache):
        return LM.lm_prefill(params, cfg, batch, cache)

    def decode_step(params, token, pos, cache):
        return LM.lm_decode_step(params, cfg, token, pos, cache)

    return Model(cfg=cfg, init=init, loss_fn=loss_fn, init_cache=init_cache,
                 prefill=prefill, decode_step=decode_step)
