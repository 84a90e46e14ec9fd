"""End-to-end PHSFL training driver (``repro.launch.train``), on the ideal
network: kappa0 local SGD steps per client with the head frozen (Eq. 12),
edge aggregation (Eqs. 14-15) every round, then per-client head
fine-tuning (Eq. 18) and the global against the personalized loss of
every client.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
        --rounds 20 --clients 4 --seq 128          # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu

``main`` takes the reference's flags and defaults and trains the
architecture's reduced config, as the reference does; ``train`` takes any
config (full width on the card) and, optionally, parameters carried from
elsewhere.  The wireless scheduler (``--channel`` other than ideal,
``--population``) and telemetry (``--trace-dir``) come with later slices
and raise ``NotImplementedError``; as in the reference, the codec, cut,
compute and fault flags price only a non-ideal network and have no
effect here.  The mesh round waits for the mesh slice: every run takes
the reference's one-device path, ``make_host_round``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs.base import HierarchyConfig, ModelConfig, TrainConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core.personalize import (personalize_head_bank,
                                          personalized_eval)
from repro_torch.core.phsfl import (build_optimizer, make_host_round,
                                    stack_replicas)
from repro_torch.data.synthetic import synthetic_token_batch
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.telemetry import MetricLogger
from repro_torch.utils.prng import make_generator
from repro_torch.utils.tree import tree_map


def _client_round_batch(cfg: ModelConfig, C, k, micro, seq, seed,
                        device="cpu"):
    """Stacked per-client batches (C, k, micro, seq); each client gets a
    DIFFERENT token distribution (client id shifts the vocab) => non-IID
    federated data.  The reference's numpy streams, element for
    element."""
    if cfg.encdec is not None or cfg.vlm is not None:
        raise NotImplementedError(f"{cfg.name}'s frontend inputs come with "
                                  f"its model in a later slice")
    toks, labs = [], []
    for c in range(C):
        nb = synthetic_token_batch(seed * 1000 + c, k * micro, seq,
                                   max(cfg.vocab_size // 2, 2))
        shift = (c * cfg.vocab_size) // (2 * max(C, 1))
        toks.append((nb["tokens"] + shift) % cfg.vocab_size)
        labs.append((nb["labels"] + shift) % cfg.vocab_size)
    return {name: torch.from_numpy(np.stack(a)).reshape(C, k, micro, seq)
            .to(device) for name, a in (("tokens", toks), ("labels", labs))}


def _synced_clock(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@dataclass
class TrainResult:
    losses: list             # mean local loss of each round run here
    round_seconds: list      # synchronised wall seconds of each round
    tokens_per_round: int    # C x kappa0 x micro x seq training tokens
    peak_mem_GB: float | None  # max_memory_allocated on the card
    params: dict             # stacked (C, ...) parameters after training
    opt_state: dict          # stacked (C, ...) optimizer states
    start_round: int         # 0, or the round a resume started from
    aborted_after: int | None = None   # set when abort_after cut the run
    head_bank: torch.Tensor | None = None        # (C, D, V) Eq. 18 heads
    finetune_losses: torch.Tensor | None = None  # (C, K)
    global_eval: torch.Tensor | None = None      # (C,) shared head
    personalized_eval: torch.Tensor | None = None  # (C,) own head

    @property
    def final_loss(self) -> float:
        return self.losses[-1] if self.losses else float("nan")

    @property
    def tokens_per_s(self) -> float:
        return (self.tokens_per_round * len(self.round_seconds)
                / sum(self.round_seconds))

    @property
    def personalization_gain(self) -> float:
        return float((self.global_eval - self.personalized_eval).mean())


def train(cfg: ModelConfig, *, params=None, rounds: int = 10,
          clients: int = 4, local_steps: int = 2, micro: int = 2,
          seq: int = 128, lr: float = 0.05, hsfl: bool = False,
          finetune_steps: int = 5, seed: int = 0, ckpt_dir=None,
          ckpt_every: int = 0, resume: bool = False, abort_after=None,
          device=None, log: MetricLogger | None = None) -> TrainResult:
    """``rounds`` edge rounds of ``clients`` clients in one ES (each round
    ``local_steps`` steps of ``micro`` x ``seq`` tokens a client, with the
    head frozen unless ``hsfl``), then a head bank of ``finetune_steps``
    steps a client on the seed-777 batch and both evaluations on it.
    ``params`` (one replica) defaults to a random init from ``seed``,
    drawn on the device.

    With ``ckpt_dir`` and ``ckpt_every`` a full training-state checkpoint
    (params, optimizer, round cursor, simulated clock: the reference's
    state tree) goes to {ckpt_dir}/state every ``ckpt_every`` rounds;
    ``resume`` continues from the latest one, bit-identically, since each
    round's batches are seeded ``seed + round``.  ``abort_after`` stops
    right after that round's checkpoint (a crash, for the resume check).
    """
    dev = resolve_device(device)
    log = log or MetricLogger("train")
    model = build_model(cfg)
    C = clients
    hcfg = HierarchyConfig(num_edge_servers=1, clients_per_es=C,
                           kappa0=local_steps, kappa1=1,
                           global_rounds=rounds)
    tcfg = TrainConfig(learning_rate=lr, freeze_head=not hsfl,
                       local_steps_in_step=local_steps, remat=False,
                       finetune_steps=finetune_steps, finetune_lr=lr)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    round_ = make_host_round(model, hcfg, tcfg, num_clients=C,
                             global_sync=False, cut=cfg.n_client_layers)

    one = (model.init(make_generator(seed, dev)) if params is None
           else tree_map(lambda t: t.to(dev), params))
    opt, _ = build_optimizer(model, tcfg, params=one)
    opt_state = stack_replicas(opt.init(one), C)
    params = stack_replicas(one, C)
    del one
    au = torch.full((C,), 1.0 / C, dtype=torch.float32, device=dev)
    ab = torch.ones((C,), dtype=torch.float32, device=dev)

    sim_time = 0.0           # the ideal network spends no simulated time
    start_round = 0
    state_dir = os.path.join(ckpt_dir, "state") if ckpt_dir else None

    def run_state(r):
        return {"params": params, "opt_state": opt_state,
                "round": np.int64(r), "sim_time_s": np.float64(sim_time)}

    if resume and state_dir:
        step = latest_step(state_dir)
        if step is not None:
            st = load_checkpoint(state_dir, step, run_state(0))
            params, opt_state = st["params"], st["opt_state"]
            start_round = int(st["round"])
            sim_time = float(st["sim_time_s"])
            log.log(resumed_from_round=float(start_round))

    res = TrainResult([], [], C * local_steps * micro * seq, None, params,
                      opt_state, start_round)
    t0 = time.time()
    for r in range(start_round, rounds):
        batch = _client_round_batch(cfg, C, local_steps, micro, seq,
                                    seed=seed + r, device=dev)
        r0 = _synced_clock(dev)
        params, opt_state, metrics = round_.fn(params, opt_state, batch,
                                               au, ab)
        res.round_seconds.append(_synced_clock(dev) - r0)
        res.losses.append(float(metrics["loss"]))
        log.log(step=r, loss=metrics["loss"],
                s_per_round=(time.time() - t0) / (r + 1))
        if state_dir and ckpt_every > 0 and (r + 1) % ckpt_every == 0:
            save_checkpoint(state_dir, r + 1, run_state(r + 1))
        if abort_after is not None and r + 1 >= abort_after:
            res.aborted_after = r + 1
            break
    res.params, res.opt_state = params, opt_state
    if res.aborted_after is None:
        _personalize(res, model, cfg, tcfg, C, micro, seq, dev, log)
        if ckpt_dir:
            save_checkpoint(ckpt_dir, rounds,
                            tree_map(lambda x: x[0], params))
            log.log(ckpt=1.0)
    if dev.type == "cuda":
        res.peak_mem_GB = torch.cuda.max_memory_allocated(dev) / 1e9
    return res


def _personalize(res: TrainResult, model, cfg, tcfg, C, micro, seq, dev,
                 log) -> None:
    """Eq. 18 on the seed-777 batch: the head bank, then each client's
    loss under the shared head and under its own."""
    global_params = tree_map(lambda x: x[0], res.params)
    ft = _client_round_batch(cfg, C, 1, micro, seq, seed=777, device=dev)
    ft = {k: v[:, 0] for k, v in ft.items()}          # (C, micro, seq)
    res.head_bank, res.finetune_losses = personalize_head_bank(
        model, global_params, ft, tcfg)
    res.personalized_eval = personalized_eval(model, global_params,
                                              res.head_bank, ft)
    base_head = global_params["lm_head"]["w"][None].expand(
        res.head_bank.shape)
    res.global_eval = personalized_eval(model, global_params, base_head, ft)
    for c in range(C):
        log.log(client=c, global_loss=res.global_eval[c],
                personalized_loss=res.personalized_eval[c])
    log.log(personalization_gain=res.personalization_gain)


def _later(what: str, item: str):
    raise NotImplementedError(f"{what} comes with a later slice of the port "
                              f"(ROADMAP.md §1 item {item}); this driver "
                              f"runs the ideal network")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--micro", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--hsfl", action="store_true",
                    help="baseline: do NOT freeze the head")
    ap.add_argument("--finetune-steps", type=int, default=5)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="write a FULL training-state checkpoint (params, "
                         "optimizer, round cursor) into {ckpt-dir}/state "
                         "every N rounds; a killed run then resumes "
                         "bit-identically (0 = final-params checkpoint "
                         "only)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest state checkpoint in "
                         "{ckpt-dir}/state (fresh start if none exists)")
    ap.add_argument("--abort-after", type=int, default=None,
                    help="kill the run right after this round's state "
                         "checkpoint (crash simulation for the resume "
                         "check)")
    ap.add_argument("--seed", type=int, default=0)
    # ---- the reference's population, wireless, device-model, fault and
    # codec flags: all price a non-ideal network (later slices) ----
    ap.add_argument("--population", type=int, default=0)
    ap.add_argument("--cohort-size", type=int, default=None)
    ap.add_argument("--sampling", default="uniform",
                    choices=["uniform", "rate", "pareto"])
    ap.add_argument("--channel", default="ideal",
                    choices=["ideal", "static", "rayleigh"])
    ap.add_argument("--deadline", type=float, default=float("inf"))
    ap.add_argument("--mean-rate-mbps", type=float, default=100.0)
    ap.add_argument("--energy-budget", type=float, default=float("inf"))
    ap.add_argument("--es-uplink-mbps", type=float, default=float("inf"))
    ap.add_argument("--cut-policy", default="fixed",
                    choices=["fixed", "greedy", "deadline"])
    ap.add_argument("--cut-candidates", type=int, nargs="+", default=None)
    ap.add_argument("--compute-gflops", type=float, default=float("inf"))
    ap.add_argument("--compute-heterogeneity", type=float, default=0.0)
    ap.add_argument("--compute-power-w", type=float, default=0.0)
    ap.add_argument("--codec-cycles", type=float, default=0.0)
    ap.add_argument("--erasure-prob", type=float, default=0.0)
    ap.add_argument("--harq-retries", type=int, default=2)
    ap.add_argument("--harq-backoff", type=float, default=0.0)
    ap.add_argument("--crash-hazard", type=float, default=0.0)
    ap.add_argument("--pipeline", action="store_true")
    ap.add_argument("--codec", default="fp32",
                    choices=["fp32", "int8", "int4", "topk", "fp8"])
    ap.add_argument("--codec-bits", type=int, default=None)
    ap.add_argument("--topk-frac", type=float, default=0.05)
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--metrics-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.population:
        if args.channel == "ideal":
            ap.error("--population requires a non-ideal --channel (the "
                     "cohort sampler lives on the wireless scheduler)")
        _later("population-scale cohorts (--population)", "4")
    if args.channel != "ideal":
        _later(f"the wireless scheduler (--channel {args.channel})", "4")
    if args.trace_dir:
        _later("telemetry (--trace-dir)", "5")

    res = train(get_arch(args.arch).reduced(), rounds=args.rounds,
                clients=args.clients, local_steps=args.local_steps,
                micro=args.micro, seq=args.seq, lr=args.lr,
                hsfl=args.hsfl, finetune_steps=args.finetune_steps,
                seed=args.seed, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, resume=args.resume,
                abort_after=args.abort_after, device=args.device)
    if res.aborted_after is not None:
        print(json.dumps({"aborted_after_round": res.aborted_after}))
        return res
    print(json.dumps({"final_loss": res.final_loss,
                      "personalization_gain": res.personalization_gain}))
    return res


if __name__ == "__main__":
    main()
