"""PHSFL training rounds through the port's ``make_host_round``.

Traffic parameters: ``clients`` (C), ``edge_servers`` (B, C/B clients
each), ``kappa0`` local steps a round of ``micro`` sequences of ``seq``
tokens each client, ``lr`` (plain SGD, the head frozen), and for an
encoder-decoder ``source_frames`` a sequence.  A unit is one round with
global aggregation; each round's batch is drawn from the seed on the
host (tokens) and the device (frames) inside the window, as a user's
loop would.

Set-up builds the one round object and its state from the seed and
drives it through ``CHECKED`` rounds, reading after the first the
update of every leaf and after the last its change and the loss of
each; the window then goes on from there.  ``check`` replays those
rounds in the plain reference (``reference/phsfl.py``) on the same
weights and batches and compares:

- ``loss``: the largest gap of a round's mean local loss, relative;
- ``update1`` and ``change3``: the worst leaf's gap between the norms
  of the update after round 1 (and of the change after the last
  checked round) in the program and in the reference, over the larger
  of the reference's norm of that leaf and of the median leaf.  The
  program's norm is the root mean square over the clients.  Two rules
  on the reference's first step leave a leaf out: a gradient under a
  thousandth of the median leaf's (a key's bias under softmax: its
  update is round-off), and an update that moves fewer than
  ``MIN_MOVED`` of its elements (bfloat16 norm scales at 1.0: each
  element moves by an ulp or not at all, so the leaf's norm counts
  rounding decisions, and one element reads 2% of the median leaf);
- ``head_moved``: the largest change of the frozen head, exactly 0.
"""

from __future__ import annotations

import math
import sys

import torch

from phsfl_bench import feed, flops, weights
from phsfl_bench.harness import median, note, worst
from phsfl_bench.reference.common import F32, Numerics, nest, paths

CHECKED = 3
FLOOR = 1e-3              # of the median leaf's gradient norm
MIN_MOVED = 10_000        # elements a leaf's first reference update moves


def _batch(run, index: int) -> dict:
    t, cfg = run.traffic, run.cfg
    toks = feed.client_tokens(cfg["vocab_size"], t["clients"],
                              (t["kappa0"], t["micro"]), t["seq"],
                              run.seed_for("round", index))
    batch = feed.to_device(toks, run.device)
    if cfg.get("encdec"):
        shape = (t["clients"], t["kappa0"], t["micro"], t["source_frames"],
                 cfg["d_model"])
        batch["source_embeds"] = feed.frames(
            shape, run.seed_for("frames", index), getattr(torch, cfg["dtype"]),
            run.device)
    return batch


def _weights(run):
    return weights.draw(run.family.layout(run.cfg), run.seed_for("weights"),
                        run.device)


def _norms(stacked: dict, base: dict) -> dict:
    """Each leaf's root mean square over the clients of the norm of
    (client's leaf - base leaf), in float32."""
    out = {}
    flat = dict(paths(base))
    for p, t in paths(stacked):
        b = flat[p].to(F32)
        sq = sum(float((t[c].to(F32) - b).square().sum())
                 for c in range(t.shape[0]))
        out[p] = math.sqrt(sq / t.shape[0])
    return out


class Unit:
    def __init__(self, run):
        from repro_torch.configs.base import HierarchyConfig, TrainConfig
        from repro_torch.core.phsfl import (build_optimizer, make_host_round,
                                            stack_replicas)
        from repro_torch.models import moe
        from repro_torch.models.registry import build_model
        self.run, t = run, run.traffic
        self.moe = moe
        c, b = t["clients"], t["edge_servers"]
        model = build_model(run.program_cfg)
        one = _weights(run)
        note("weights drawn")
        tcfg = TrainConfig(learning_rate=t["lr"], remat=False,
                           local_steps_in_step=t["kappa0"])
        hcfg = HierarchyConfig(num_edge_servers=b, clients_per_es=c // b,
                               kappa0=t["kappa0"], kappa1=1)
        opt, _ = build_optimizer(model, tcfg, params=one)
        self.state = stack_replicas(opt.init(one), c)
        self.round = make_host_round(model, hcfg, tcfg, num_clients=c,
                                     global_sync=True)
        dev = run.device
        self.au = torch.full((c,), 1.0 / (c // b), dtype=F32, device=dev)
        self.ab = torch.full((c,), 1.0 / b, dtype=F32, device=dev)
        self.index = 0
        self.losses = []
        self.params = stack_replicas(one, c)
        note("replicas stacked")
        for r in range(CHECKED):
            self.step()
            note(f"set-up round {r + 1} done")
            if r == 0:
                self.update1 = _norms(self.params, one)
        self.change = _norms(self.params, one)
        self.head_moved = float((self.params["lm_head"]["w"].to(F32)
                                 - one["lm_head"]["w"].to(F32)[None])
                                .abs().max())
        del one

    def step(self) -> tuple[int, int]:
        batch = _batch(self.run, self.index)
        self.params, self.state, m = self.round.fn(
            self.params, self.state, batch, self.au, self.ab)
        loss = float(m["loss"])
        if self.index < CHECKED:
            self.losses.append(loss)
        self.index += 1
        return 1, int(not math.isfinite(loss))

    def counters(self, since=None) -> dict:
        now = {"moe_host_reads": self.moe.group_size_reads,
               "local_steps": self.index * self.run.traffic["clients"]
               * self.run.traffic["kappa0"]}
        if since is None:
            return now
        return {k: now[k] - since[k] for k in now}

    def work(self, units: int) -> dict:
        """Model FLOPs and attention work of ``units`` rounds."""
        t, cfg = self.run.traffic, self.run.cfg
        steps = units * t["clients"] * t["kappa0"]
        model = steps * flops.train_step_flops(cfg, t["micro"] * t["seq"],
                                               t["seq"])
        h, kvh, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
        att = [flops.self_attention_work(t["micro"], t["seq"], h, kvh, hd,
                                         hd, True)] * cfg["num_layers"]
        if cfg.get("encdec"):
            att += [flops.self_attention_work(
                t["micro"], t["source_frames"], h, kvh, hd, hd,
                False)] * cfg["encdec"]["num_encoder_layers"]
        return {"model_flops": model,
                "attention_flops": steps * sum(a[0] for a in att),
                "attention_bytes": steps * sum(a[1] for a in att)}

    def end_to_end(self, window_s: float, units: int, attempted: int):
        return {"round_s": window_s / units}

    def release(self) -> None:
        self.run.readings = {"losses": self.losses, "update1": self.update1,
                             "change": self.change,
                             "head_moved": self.head_moved}
        del self.params, self.state, self.round


def client_batches(run, index: int, half: bool = False) -> list:
    """Each client's micro-batches of round ``index``, as the reference
    takes them (``half``: the first half of each micro-batch's rows)."""
    b = _batch(run, index)
    t = run.traffic
    rows = t["micro"] // 2 if half else t["micro"]
    return [[{k: v[c, s, :rows] for k, v in b.items()}
             for s in range(t["kappa0"])] for c in range(t["clients"])]


def reference_readings(run, num: Numerics, half: bool = False) -> dict:
    """The plain reference's readings of the checked rounds: losses,
    gradient norms at the first step, update and change norms."""
    from phsfl_bench.reference import phsfl
    t = run.traffic
    p0 = _weights(run)
    params, losses, first = p0, [], {}
    for r in range(CHECKED):
        params, loss = phsfl.round_(run.family, params, run.cfg,
                                    client_batches(run, r, half),
                                    t["edge_servers"], t["lr"], num,
                                    first if r == 0 else None)
        losses.append(float(loss))
        if r == 0:
            update1 = _norms(_stack1(params), p0)
    change = _norms(_stack1(params), p0)
    head = float((params["lm_head"]["w"].to(F32)
                  - p0["lm_head"]["w"].to(F32)).abs().max())
    return {"losses": losses, "update1": update1, "change": change,
            "head_moved": head, "first": first}


def _stack1(tree: dict) -> dict:
    return nest({p: t[None] for p, t in paths(tree)})


def kept(first: dict) -> list:
    """The leaves compared: a reference gradient at least FLOOR of the
    median leaf's, and at least MIN_MOVED elements moved by it."""
    gmed = median([g for g, _ in first.values()])
    keep = [p for p, (g, n) in first.items()
            if g >= FLOOR * gmed and n >= MIN_MOVED]
    if not keep:
        raise ValueError("no leaf is left to compare")
    return keep


def worst_leaf(prog: dict, ref: dict, keep: list, label: str) -> float:
    """The worst leaf of ``keep``'s gap between the norms, over the larger
    of the reference's norm and the median leaf's.  The three worst go to
    standard error."""
    med = median([ref[p] for p in keep])
    gaps = {p: abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30) for p in keep}
    for p in sorted(gaps, key=lambda p: -gaps[p])[:3]:
        print(f"[bench] {label} {p}: gap {gaps[p]:.3e} program "
              f"{prog[p]:.6e} reference {ref[p]:.6e} median {med:.6e}",
              file=sys.stderr)
    return worst(gaps.values())


def compare(prog: dict, ref: dict) -> dict:
    loss = worst(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                     ref["losses"]))
    keep = kept(ref["first"])
    return {"loss": loss,
            "update1": worst_leaf(prog["update1"], ref["update1"], keep,
                                  "update1"),
            "change3": worst_leaf(prog["change"], ref["change"], keep,
                                  "change3"),
            "head_moved": prog["head_moved"]}


def check(run) -> dict:
    return compare(run.readings, reference_readings(run, Numerics()))
