"""Per-client head fine-tuning (Eq. 18) through the port's
``personalize_head_bank``.

Traffic parameters: ``clients`` (C), each with ``batch`` sequences of
``seq`` tokens, ``steps`` (K) SGD steps on the head at ``lr``.  A unit
is one bank: one trunk forward over the C x batch sequences, then C x K
head steps.  Each bank's tokens are drawn from the seed inside the
window.

Set-up draws the weights from the seed and runs ``WARM`` banks; the
first is checked.  ``check`` recomputes its hidden states with the plain
reference's trunk and its K steps with the reference's head SGD, on the
same weights and tokens, and compares:

- ``loss``: the largest gap of a (client, step) loss, relative;
- ``change``: the worst client's gap between the norms of (its head -
  the initial head) in the program and in the reference, over the
  larger of the reference's norm for that client and the median
  client's.
"""

from __future__ import annotations

import torch

from phsfl_bench import feed, flops, weights
from phsfl_bench.harness import median, note, worst
from phsfl_bench.reference.common import F32, Numerics

WARM = 2
BLOCK = 4                 # sequences a reference trunk pass takes


def _batch(run, index: int) -> dict:
    t = run.traffic
    toks = feed.client_tokens(run.cfg["vocab_size"], t["clients"],
                              (t["batch"],), t["seq"],
                              run.seed_for("bank", index))
    return feed.to_device(toks, run.device)


def _weights(run):
    return weights.draw(run.family.layout(run.cfg), run.seed_for("weights"),
                        run.device)


def _change_norms(bank, w0) -> list:
    return [float((bank[c].to(F32) - w0.to(F32)).norm())
            for c in range(bank.shape[0])]


class Unit:
    def __init__(self, run):
        from repro_torch.configs.base import TrainConfig
        from repro_torch.core.personalize import personalize_head_bank
        from repro_torch.models.registry import build_model
        self.run, t = run, run.traffic
        self.model = build_model(run.program_cfg)
        self.params = _weights(run)
        note("weights drawn")
        self.tcfg = TrainConfig(finetune_steps=t["steps"], finetune_lr=t["lr"])
        self.bank_fn = personalize_head_bank
        self.index = 0
        for _ in range(WARM):
            bank, losses = self._bank()
            if self.index == 1:
                self.readings = {
                    "losses": losses.cpu().tolist(),
                    "change": _change_norms(bank,
                                            self.params["lm_head"]["w"])}
            del bank
            note(f"set-up bank {self.index} done")

    def _bank(self):
        batch = _batch(self.run, self.index)
        self.index += 1
        return self.bank_fn(self.model, self.params, batch, self.tcfg)

    def step(self) -> tuple[int, int]:
        bank, losses = self._bank()
        bad = int((~torch.isfinite(losses).all(dim=1)).sum())
        return bank.shape[0], bad

    def counters(self, since=None) -> dict:
        return {}

    def work(self, units: int) -> dict:
        t, cfg = self.run.traffic, self.run.cfg
        tokens = t["batch"] * t["seq"]
        trunk = flops.trunk_forward_flops(cfg, t["clients"] * tokens, t["seq"])
        head = t["clients"] * t["steps"] * flops.head_step_flops(cfg, tokens)
        return {"model_flops": units * (trunk + head),
                "clients": units * t["clients"]}

    def end_to_end(self, window_s: float, units: int, attempted: int):
        return {"personalize_clients_per_s": attempted / window_s}

    def release(self) -> None:
        self.run.readings = self.readings
        del self.params, self.model


def hidden_states(run, params, batch, num: Numerics):
    """The reference trunk's final hidden states (C,B,S,D) of every
    client's sequences, ``BLOCK`` sequences a pass."""
    c, b, s = batch["tokens"].shape
    flat = {k: v.reshape(c * b, *v.shape[2:]) for k, v in batch.items()}
    outs = []
    with torch.no_grad():
        for i in range(0, c * b, BLOCK):
            part = {k: v[i:i + BLOCK] for k, v in flat.items()}
            outs.append(run.family.forward(params, run.cfg, part, num)[0])
    return torch.cat(outs).reshape(c, b, s, -1)


def reference_readings(run, num: Numerics, half: bool = False) -> dict:
    from phsfl_bench.reference import phsfl
    t = run.traffic
    params = _weights(run)
    batch = _batch(run, 0)
    if half:
        batch = {k: v[:, :max(t["batch"] // 2, 1)] for k, v in batch.items()}
    hidden = hidden_states(run, params, batch, num)
    w0 = params["lm_head"]["w"]
    bank, losses = phsfl.head_bank(hidden, batch["labels"], w0, t["steps"],
                                   t["lr"], num)
    return {"losses": losses.cpu().tolist(), "change": _change_norms(bank, w0)}


def compare(prog: dict, ref: dict) -> dict:
    loss = worst(abs(a - b) / abs(b)
                 for pa, ra in zip(prog["losses"], ref["losses"])
                 for a, b in zip(pa, ra))
    med = median(ref["change"])
    change = worst(abs(a - b) / max(b, med, 1e-30)
                   for a, b in zip(prog["change"], ref["change"]))
    return {"loss": loss, "change": change}


def check(run) -> dict:
    return compare(run.readings, reference_readings(run, Numerics()))
