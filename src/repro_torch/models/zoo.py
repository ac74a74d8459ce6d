"""Model facade: a uniform API over the ported architectures.

``build_model(cfg)`` returns a :class:`Model` whose methods are plain
functions of (params, batch); the serving driver and the tests drive
models only through it.  Every arch of the repo is ported: the
decoder-only ones (dense, hybrid, MoE, xLSTM and the VLM with its stub
frontend) through ``models.lm`` and the encoder-decoder
(seamless-m4t-large-v2) through ``models.encdec``, each with the three
rematerialisation policies.  An encoder-decoder's prefill also returns
the cross-attention memories, which its decode step takes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.models.config import ModelConfig
from repro_torch.models.param_util import axes_tree


@dataclass
class Model:
    cfg: ModelConfig
    init: Callable          # generator -> params, on the generator's device
    loss_fn: Callable       # (params, batch, remat_policy="none"|"full"|"dots") -> (loss, metrics)
    init_cache: Callable    # (batch, max_len, device="cuda") -> cache
    prefill: Callable       # (params, batch, cache) -> (logits, cache[, memories])
    decode_step: Callable   # (params, token, pos, cache[, memories]) -> (logits, cache)

    def abstract(self) -> Tuple[Any, Any]:
        """(abstract_params, axes) without allocating: the init runs on
        fake tensors (shapes and dtypes only), and the axes tree is read
        from the tags its leaves carry (``param_util.leaf``)."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            params = self.init(torch.Generator())
        return params, axes_tree(params)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.arch_kind == "encdec":
        return _build_encdec(cfg)
    if cfg.arch_kind != "decoder":
        raise ValueError(cfg.arch_kind)

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


def _build_encdec(cfg: ModelConfig) -> Model:
    def init(gen):
        return ED.init_encdec(gen, cfg)

    def loss_fn(params, batch, remat_policy="none"):
        return ED.encdec_loss(params, cfg, batch, remat_policy)

    def init_cache(batch, max_len, device="cuda"):
        return ED.init_encdec_cache(cfg, batch, max_len, device)

    def prefill(params, batch, cache):
        return ED.encdec_prefill(params, cfg, batch, cache)

    def decode_step(params, token, pos, cache, memories):
        return ED.encdec_decode_step(params, cfg, token, pos, cache, memories)

    return Model(cfg=cfg, init=init, loss_fn=loss_fn, init_cache=init_cache,
                 prefill=prefill, decode_step=decode_step)
