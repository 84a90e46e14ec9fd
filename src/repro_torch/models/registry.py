"""Unified Model interface (``repro.models.registry``), for the decoder
LM; the encoder-decoder model comes with a later slice."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
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
    if cfg.encdec is not None:
        raise NotImplementedError(f"{cfg.name} is an encoder-decoder: that "
                                  f"model comes with a later slice")

    def init(gen, dtype=None):
        return tf_mod.init(gen, cfg, dtype=dtype)

    def apply(params, batch, *, impl="auto"):
        return tf_mod.apply(params, cfg, batch, impl=impl)

    def loss(params, batch, *, impl="auto"):
        hidden, aux = tf_mod.apply(params, cfg, batch, impl=impl)
        ce = tf_mod.lm_loss(params, cfg, hidden, batch["labels"])
        if cfg.moe is not None:
            ce = ce + cfg.moe.router_aux_loss * aux
        return ce

    def init_cache(batch, max_len, dtype=torch.bfloat16, device="cpu"):
        return tf_mod.init_cache(cfg, batch, max_len, dtype=dtype,
                                 device=device)

    def decode_step(params, token, cache, index, *, positions3=None,
                    return_hidden=False):
        return tf_mod.decode_step(params, cfg, token, cache, index,
                                  positions3=positions3,
                                  return_hidden=return_hidden)

    def logits(params, hidden):
        return tf_mod.logits_from_hidden(params, cfg, hidden)

    return Model(cfg, init, apply, loss, init_cache, decode_step, logits)
