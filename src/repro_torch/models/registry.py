"""Unified Model interface over the zoo, decoder LM or encoder-decoder
(``repro.models.registry``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf_mod


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable                    # (gen, dtype=None) -> params
    apply: Callable                   # (params, batch, **kw) -> (hidden, aux)
    loss: Callable                    # (params, batch, **kw) -> scalar
    init_cache: Callable              # (batch, max_len, dtype, device)
    decode_step: Callable             # (params, token, cache, index,
    #                                   positions3=None) -> (logits, cache)
    logits: Callable                  # (params, hidden) -> logits


def build_model(cfg: ModelConfig) -> Model:
    mod: Any = encdec_mod if cfg.encdec is not None else tf_mod

    def init(gen, dtype=None):
        return mod.init(gen, cfg, dtype=dtype)

    def apply(params, batch, *, impl="auto", remat=False, remat_policy=None):
        return mod.apply(params, cfg, batch, impl=impl, remat=remat,
                         remat_policy=remat_policy)

    def loss(params, batch, *, impl="auto", remat=False, remat_policy=None):
        hidden, aux = mod.apply(params, cfg, batch, impl=impl, remat=remat,
                                remat_policy=remat_policy)
        ce = tf_mod.lm_loss(params, cfg, hidden, batch["labels"])
        if cfg.moe is not None:
            ce = ce + cfg.moe.router_aux_loss * aux
        return ce

    def init_cache(batch, max_len, dtype=torch.bfloat16, device="cpu"):
        return mod.init_cache(cfg, batch, max_len, dtype=dtype,
                              device=device)

    def decode_step(params, token, cache, index, *, positions3=None,
                    return_hidden=False):
        return mod.decode_step(params, cfg, token, cache, index,
                               positions3=positions3,
                               return_hidden=return_hidden)

    def logits(params, hidden):
        return tf_mod.logits_from_hidden(params, cfg, hidden)

    return Model(cfg, init, apply, loss, init_cache, decode_step, logits)
