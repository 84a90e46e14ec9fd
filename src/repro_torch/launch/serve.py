"""Personalized serving driver: batched decode with per-request heads
(``repro.launch.serve``).

Serves a model with a *head bank*: each request carries a client profile
id; the trunk (client block + body, = w*) is shared across the batch, and
the final projection uses the request's own personalized classifier
w_{u,1,hd}^K (paper Sec. III-B).  This is the serving-side contract of
PHSFL: one shared trunk, many heads.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \\
        --batch 4 --steps 16                 # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

``main`` takes the reference's flags and defaults and serves the
architecture's reduced config, as the reference does; ``serve`` takes any
config (full width on the card) and, optionally, parameters carried from
elsewhere.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core.personalize import personalize_head_bank
from repro_torch.data.synthetic import synthetic_token_batch
from repro_torch.device import resolve_device
from repro_torch.models.layers import softcap
from repro_torch.models.registry import build_model
from repro_torch.telemetry import MetricLogger
from repro_torch.utils.prng import make_generator


@dataclass
class ServeResult:
    generated: torch.Tensor      # (batch, steps) generated token ids
    profiles: np.ndarray         # (batch,) client profile of each request
    logits: torch.Tensor         # (batch, steps, V) float32, per decode step
    head_bank: torch.Tensor      # (clients, D, V) personalized heads
    bank_losses: torch.Tensor    # (clients, K) fine-tuning losses
    bank_seconds: float          # head bank: trunk forward + K head steps
    decode_seconds: float        # prompt stepping + generation
    tokens: int                  # tokens through the trunk while decoding

    @property
    def tok_per_s(self) -> float:
        return self.tokens / self.decode_seconds


def personalized_logits(hidden, bank32, profile_ids, cap: float = 0.0):
    """Each request's logits through its own client's head: hidden
    (B,1,D) float32 against the float32 bank (C,D,V), indexed per request
    (``hidden_f32 @ head_f32`` of the reference).  Returns (B,1,V)."""
    lg = torch.stack([hidden[b] @ bank32[pid]
                      for b, pid in enumerate(profile_ids)])
    return softcap(lg, cap)


def _synced_clock(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def serve(cfg: ModelConfig, *, params=None, batch: int = 4, steps: int = 16,
          clients: int = 3, prompt_len: int = 16, seed: int = 0,
          bank_seq: int = 32, device=None, log: MetricLogger | None = None
          ) -> ServeResult:
    """Build a head bank of ``clients`` heads (Eq. 18, on sequences of
    ``bank_seq`` tokens), then decode ``batch`` requests of a
    ``prompt_len`` prompt for ``steps`` tokens, each request through its
    client's head.  ``params`` defaults to a random init from ``seed``,
    drawn on the device."""
    dev = resolve_device(device)
    log = log or MetricLogger("serve")
    model = build_model(cfg)
    if params is None:
        params = model.init(make_generator(seed, dev))

    # ---- build a personalized head bank (Eq. 18) ----
    tcfg = TrainConfig(finetune_lr=0.2, finetune_steps=4)
    nbs = [synthetic_token_batch(c, 2, bank_seq, cfg.vocab_size)
           for c in range(clients)]
    batches = {k: torch.from_numpy(np.stack([nb[k] for nb in nbs])).to(dev)
               for k in nbs[0]}
    t0 = _synced_clock(dev)
    head_bank, bank_losses = personalize_head_bank(model, params, batches,
                                                   tcfg)
    bank_seconds = _synced_clock(dev) - t0
    log.log(head_bank_clients=head_bank.shape[0])

    # ---- batched decode; per-request personalized final projection ----
    rng = np.random.default_rng(seed)
    profile_ids = rng.integers(0, clients, batch)
    # float32 heads, as the reference's per-step cast, made once for the
    # bank and indexed per request: a gathered (batch, D, V) float32 copy
    # would be 16 GB a step at full width
    bank32 = head_bank.to(torch.float32)
    cache = model.init_cache(batch, prompt_len + steps, dtype=torch.float32,
                             device=dev)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(dev)

    def hidden_at(tok, index):
        hidden, _ = model.decode_step(params, tok, cache, index,
                                      return_hidden=True)
        return hidden.to(torch.float32)                   # (B,1,D)

    with torch.no_grad():
        t0 = _synced_clock(dev)
        for i in range(prompt_len - 1):                   # prefill by stepping
            hidden_at(prompt[:, i:i + 1], i)
        generated, logits = [], []
        tok = prompt[:, -1:]
        for s in range(steps):
            lg = personalized_logits(hidden_at(tok, prompt_len - 1 + s),
                                     bank32, profile_ids,
                                     cfg.final_logit_softcap)
            tok = lg[:, :, :cfg.vocab_size].argmax(-1).to(torch.int32)
            generated.append(tok[:, 0])
            logits.append(lg[:, 0])
        decode_seconds = _synced_clock(dev) - t0
    toks = batch * (steps + prompt_len - 1)
    res = ServeResult(torch.stack(generated, 1), profile_ids,
                      torch.stack(logits, 1), head_bank, bank_losses,
                      bank_seconds, decode_seconds, toks)
    log.log(tokens=toks, tok_per_s=res.tok_per_s, wall_s=decode_seconds)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    res = serve(get_arch(args.arch).reduced(), batch=args.batch,
                steps=args.steps, clients=args.clients,
                prompt_len=args.prompt_len, seed=args.seed,
                device=args.device)
    print(json.dumps({"generated": res.generated.cpu().tolist(),
                      "profiles": res.profiles.tolist(),
                      "tok_per_s": round(res.tok_per_s, 1)}))
    return res


if __name__ == "__main__":
    main()
