"""End-to-end PHSFL training driver (``repro.launch.train``): kappa0
local SGD steps per client with the head frozen (Eq. 12), edge
aggregation (Eqs. 14-15) every round, then per-client head fine-tuning
(Eq. 18) and the global against the personalized loss of every client.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
        --rounds 20 --clients 4 --seq 128          # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --channel rayleigh --deadline 0.5 --population 64

``main`` takes the reference's flags and defaults and trains the
architecture's reduced config, as the reference does; ``train`` takes any
config (full width on the card) and, optionally, parameters carried from
elsewhere.  A non-ideal ``--channel`` builds the reference's wireless
scheduler (``build_scheduler``): each round's participation mask goes
into the masked edge step, the codec, cut, compute and fault flags price
the traffic (``core.comm.comm_for_lm`` / ``comm_table_for_lm``), and the
scheduler's state joins the state checkpoint, so ``--resume`` replays the
exact fault schedule.  ``--population N`` samples each round's cohort of
``--clients`` training slots from N registered clients through the
``CohortScheduler``, whose decision core runs on the training device.
``--trace-dir OUT`` turns telemetry on (``repro_torch.telemetry``): the
scheduler's Perfetto trace (``trace.json``) and metrics
(``metrics.jsonl``), the kernel probes and the log's ``log.train.*``
gauges, a run manifest (``manifest.json``) and a summary table
(``summary.txt``); every number of the run stays as it is without it.
The mesh round waits for the mesh slice: every run takes the reference's
one-device path, ``make_host_round``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs.base import (FaultConfig, HierarchyConfig,
                                      ModelConfig, TrainConfig,
                                      WirelessConfig)
from repro_torch.configs.registry import get_arch
from repro_torch.core.hierarchy import es_assignment
from repro_torch.core.personalize import (personalize_head_bank,
                                          personalized_eval)
from repro_torch.core.phsfl import (build_optimizer, make_host_round,
                                    stack_replicas)
from repro_torch.data.synthetic import synthetic_token_batch
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.telemetry import MetricLogger, Telemetry
from repro_torch.utils.prng import make_generator
from repro_torch.utils.tree import tree_map


def _client_round_batch(cfg: ModelConfig, C, k, micro, seq, seed,
                        device="cpu"):
    """Stacked per-client batches (C, k, micro, seq); each client gets a
    DIFFERENT token distribution (client id shifts the vocab) => non-IID
    federated data.  The reference's numpy streams, element for
    element.  A stubbed frontend's inputs join the batch as the reference
    builds them: the encoder-decoder's source frames of 0.02 (C, k, micro,
    max_source_len, D) float32; the VLM's patch embeddings of 0.02 (C, k,
    micro, P, D) float32 and M-RoPE positions (C, k, micro, seq, 3), the
    token index in all three streams."""
    toks, labs = [], []
    for c in range(C):
        nb = synthetic_token_batch(seed * 1000 + c, k * micro, seq,
                                   max(cfg.vocab_size // 2, 2))
        shift = (c * cfg.vocab_size) // (2 * max(C, 1))
        toks.append((nb["tokens"] + shift) % cfg.vocab_size)
        labs.append((nb["labels"] + shift) % cfg.vocab_size)
    batch = {name: torch.from_numpy(np.stack(a)).reshape(C, k, micro, seq)
             .to(device) for name, a in (("tokens", toks), ("labels", labs))}
    if cfg.encdec is not None:
        batch["source_embeds"] = torch.full(
            (C, k, micro, cfg.encdec.max_source_len, cfg.d_model), 0.02,
            dtype=torch.float32, device=device)
    if cfg.vlm is not None:
        batch["patch_embeds"] = torch.full(
            (C, k, micro, cfg.vlm.num_patch_tokens, cfg.d_model), 0.02,
            dtype=torch.float32, device=device)
        batch["positions3"] = torch.arange(
            seq, dtype=torch.int32, device=device)[:, None].expand(
            C, k, micro, seq, 3).contiguous()
    return batch


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
    sim_time_s: float = 0.0  # simulated network clock (0 on the ideal one)
    network: list = field(default_factory=list)  # scheduler row a round

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
          device=None, log: MetricLogger | None = None,
          scheduler=None) -> TrainResult:
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

    ``scheduler`` (from :func:`build_scheduler`; None = the ideal network)
    decides each round's participants: its mask goes into the masked edge
    step, its round time advances the simulated clock, and its state
    (budgets, stale bank, every RNG stream, the population's) joins the
    state checkpoint.
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
                             global_sync=False,
                             participation=scheduler is not None,
                             cut=cfg.n_client_layers)
    population = getattr(scheduler, "population", None)

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
        st = {"params": params, "opt_state": opt_state,
              "round": np.int64(r), "sim_time_s": np.float64(sim_time)}
        if scheduler is not None:
            st["scheduler"] = scheduler.state_dict()
        return st

    if resume and state_dir:
        step = latest_step(state_dir)
        if step is not None:
            st = load_checkpoint(state_dir, step, run_state(0))
            params, opt_state = st["params"], st["opt_state"]
            start_round = int(st["round"])
            sim_time = float(st["sim_time_s"])
            if scheduler is not None:
                scheduler.load_state_dict(st["scheduler"])
            log.log(resumed_from_round=float(start_round))

    res = TrainResult([], [], C * local_steps * micro * seq, None, params,
                      opt_state, start_round)
    t0 = time.time()
    for r in range(start_round, rounds):
        batch = _client_round_batch(cfg, C, local_steps, micro, seq,
                                    seed=seed + r, device=dev)
        r0 = _synced_clock(dev)
        if scheduler is None:
            params, opt_state, metrics = round_.fn(params, opt_state, batch,
                                                   au, ab)
            net = {}
        else:
            rep = scheduler.step(r)
            if population is not None:
                # (N,)-wide report -> this round's C training slots
                from repro_torch.wireless.population import cohort_report
                rep = cohort_report(rep, scheduler.last_cohort)
            sim_time += rep.round_time_s
            mask = torch.as_tensor(rep.mask, dtype=torch.float32, device=dev)
            params, opt_state, metrics = round_.fn(params, opt_state, batch,
                                                   au, ab, mask)
            net = {"participants": rep.num_participants,
                   "round_time_s": rep.round_time_s,
                   "sim_time_s": sim_time, "bits_tx": rep.bits_tx}
            if rep.mean_cut is not None:
                net["mean_cut"] = rep.mean_cut
            if rep.compute_s is not None and rep.compute_s.any():
                net["compute_s_max"] = float(rep.compute_s.max())
            res.network.append(net)
        res.round_seconds.append(_synced_clock(dev) - r0)
        res.losses.append(float(metrics["loss"]))
        log.log(step=r, loss=metrics["loss"], **net,
                s_per_round=(time.time() - t0) / (r + 1))
        if state_dir and ckpt_every > 0 and (r + 1) % ckpt_every == 0:
            save_checkpoint(state_dir, r + 1, run_state(r + 1))
        if abort_after is not None and r + 1 >= abort_after:
            res.aborted_after = r + 1
            break
    res.params, res.opt_state = params, opt_state
    res.sim_time_s = sim_time
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


def build_scheduler(cfg: ModelConfig, wcfg: WirelessConfig, *,
                    clients: int, seq: int, rounds: int, local_steps: int,
                    micro: int, codecs=None, population: int = 0,
                    sampling: str = "uniform", seed: int = 0, device=None,
                    telemetry=None):
    """The reference's wireless scheduler of ``main``: the LM's byte
    accounting (``comm_for_lm``, or ``comm_table_for_lm`` over
    ``wcfg.cut_candidates`` when the cut policy adapts) priced by
    ``make_scheduler`` for ``clients`` clients on one ES, or, with
    ``population`` > 0, a ``CohortScheduler`` on ``device`` over that many
    registered clients (seeded ``seed``) that samples ``clients`` of them
    a round.  ``telemetry`` (default off) records every round's trace and
    scheduler metrics."""
    from repro_torch.core.comm import comm_for_lm, comm_table_for_lm
    from repro_torch.wireless import make_scheduler
    comm_kw = dict(seq_len=seq, dataset_size=rounds * local_steps * micro,
                   batch_size=micro, batches_per_epoch=1, codecs=codecs)
    if population:
        from repro_torch.wireless.population import (CohortScheduler,
                                                     Population)
        pop = Population(population, seed=seed)
        sched_u, es_assign = pop.N, pop.es_assign
        extra = dict(cls=CohortScheduler, population=pop,
                     cohort_size=clients, sampling=sampling,
                     core_device=device)
    else:
        sched_u, es_assign = clients, es_assignment(clients, clients)
        extra = {}
    extra["telemetry"] = telemetry
    candidates = tuple(wcfg.cut_candidates)
    if wcfg.cut_policy != "fixed" or candidates:
        table = comm_table_for_lm(
            cfg, cuts=candidates or (cfg.n_client_layers,), **comm_kw)
        if wcfg.cut_policy == "fixed" and cfg.n_client_layers not in table:
            raise ValueError(
                f"--cut-policy fixed would price one of {tuple(table)} "
                f"but the model's client depth is {cfg.n_client_layers}; "
                f"include it in --cut-candidates")
        return make_scheduler(
            wcfg, sched_u, kappa0=local_steps, comm_table=table,
            es_assign=es_assign,
            fixed_cut=cfg.n_client_layers
            if cfg.n_client_layers in table else 0, **extra)
    return make_scheduler(wcfg, sched_u, comm_for_lm(cfg, **comm_kw),
                          local_steps, es_assign=es_assign, **extra)


def parse_args(argv=None):
    """The reference's flags (and ``--device``), with its defaults and
    usage errors; ``args.clients`` is the cohort size in population
    mode."""
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
    # ---- population-scale cohorts (repro_torch.wireless.population) ----
    ap.add_argument("--population", type=int, default=0,
                    help="register N clients in a persistent population and "
                         "sample a cohort per round; the scheduler then "
                         "prices ALL N channels/budgets while only the "
                         "cohort trains (0 = classic fixed-client mode). "
                         "Requires a non-ideal --channel")
    ap.add_argument("--cohort-size", type=int, default=None,
                    help="clients trained per round in population mode "
                         "(default: --clients); becomes the slot count of "
                         "the host round")
    ap.add_argument("--sampling", default="uniform",
                    choices=["uniform", "rate", "pareto"],
                    help="cohort sampling rule: uniform, biased toward "
                         "good channels (rate), or a Pareto-style "
                         "participation cap (least-sampled first)")
    # ---- wireless scenario (repro_torch.wireless) ----
    ap.add_argument("--channel", default="ideal",
                    choices=["ideal", "static", "rayleigh"],
                    help="per-client channel model (ideal = pre-wireless)")
    ap.add_argument("--deadline", type=float, default=float("inf"),
                    help="edge-round deadline in seconds; stragglers drop")
    ap.add_argument("--mean-rate-mbps", type=float, default=100.0,
                    help="mean per-client uplink rate")
    ap.add_argument("--energy-budget", type=float, default=float("inf"),
                    help="lifetime per-client uplink energy budget (J)")
    ap.add_argument("--es-uplink-mbps", type=float, default=float("inf"),
                    help="shared ES uplink capacity, split among that "
                         "round's scheduled clients (inf = private uplinks)")
    ap.add_argument("--cut-policy", default="fixed",
                    choices=["fixed", "greedy", "deadline"],
                    help="per-round cut-layer selection policy "
                         "(repro_torch.wireless.cutter)")
    ap.add_argument("--cut-candidates", type=int, nargs="+", default=None,
                    help="candidate client depths (n_client_layers), "
                         "shallow to deep; default: the model's depth only")
    # ---- device (compute) model (repro_torch.wireless.device) ----
    ap.add_argument("--compute-gflops", type=float, default=float("inf"),
                    help="per-client compute rate in GFLOP/s; client-block "
                         "FLOPs then cost round time and energy (inf = "
                         "free compute, the bits-only accounting)")
    ap.add_argument("--compute-heterogeneity", type=float, default=0.0,
                    help="lognormal sigma of a fixed per-client compute "
                         "scale (0 = identical devices)")
    ap.add_argument("--compute-power-w", type=float, default=0.0,
                    help="power drawn while computing; joins tx energy in "
                         "the per-client budget gate")
    ap.add_argument("--codec-cycles", type=float, default=0.0,
                    help="FLOPs per element crossing a lossy codec "
                         "(encode/decode compute; 0 = codecs compute-free)")
    # ---- fault injection (repro_torch.wireless.faults) ----
    ap.add_argument("--erasure-prob", type=float, default=0.0,
                    help="per-attempt payload erasure probability; erased "
                         "transmissions retransmit (HARQ) as real timeline "
                         "segments, priced in the deadline/energy/bits "
                         "accounting")
    ap.add_argument("--harq-retries", type=int, default=2,
                    help="max retransmissions per payload before it FAILS")
    ap.add_argument("--harq-backoff", type=float, default=0.0,
                    help="radio-idle seconds before each retransmission")
    ap.add_argument("--crash-hazard", type=float, default=0.0,
                    help="per-round probability a scheduled client dies "
                         "mid-round (timeline frozen at the crash instant)")
    ap.add_argument("--pipeline", action="store_true",
                    help="overlap client compute with uplink streaming at "
                         "minibatch granularity (repro_torch.wireless.timeline); "
                         "the deadline/energy gates and the accounting "
                         "price the overlapped timeline.  Staleness-"
                         "weighted async aggregation (staleness_lambda) is "
                         "a FedSim-side fold and is not exposed here — this "
                         "driver prices the scheduler side only")
    # ---- compression (repro_torch.compress) ----
    ap.add_argument("--codec", default="fp32",
                    choices=["fp32", "int8", "int4", "topk", "fp8"],
                    help="codec for the split-learning wire payloads "
                         "(activations up, gradients down, offloads); this "
                         "driver prices it in the wireless accounting — the "
                         "CNN simulator (benchmarks/compress_sweep.py) "
                         "additionally applies it in the dataflow")
    ap.add_argument("--codec-bits", type=int, default=None,
                    help="override the uniform quantizer's bit width")
    ap.add_argument("--topk-frac", type=float, default=0.05,
                    help="kept fraction for --codec topk")
    # ---- observability (repro_torch.telemetry) ----
    ap.add_argument("--trace-dir", default=None,
                    help="write telemetry into this directory: a streamed "
                         "Chrome/Perfetto trace of every wireless round "
                         "(trace.json — open at https://ui.perfetto.dev), "
                         "typed metrics snapshots (metrics.jsonl), a run "
                         "manifest (manifest.json), and a run-end summary "
                         "table (summary.txt).  Default: telemetry off, "
                         "bit-identical to a run without it")
    ap.add_argument("--metrics-every", type=int, default=1,
                    help="flush a metrics.jsonl snapshot every N rounds "
                         "(with --trace-dir)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.population:
        if args.channel == "ideal":
            ap.error("--population requires a non-ideal --channel (the "
                     "cohort sampler lives on the wireless scheduler)")
        args.clients = args.cohort_size or args.clients
        if args.population < args.clients:
            ap.error("--population must be >= the cohort size")
    return args


def scheduler_from_args(cfg: ModelConfig, args, device=None, telemetry=None):
    """The wireless scheduler ``main`` builds from its flags (None on the
    ideal network): the reference's ``WirelessConfig`` of the flags (the
    downlink at 4x the uplink), their codec, and :func:`build_scheduler`
    on ``device``, recording into ``telemetry`` (default off)."""
    if args.channel == "ideal":
        return None
    from repro_torch.compress import link_codecs
    codecs = None
    if args.codec != "fp32":
        codecs = link_codecs(args.codec, bits=args.codec_bits,
                             topk_frac=args.topk_frac)
    wcfg = WirelessConfig(model=args.channel,
                          mean_uplink_mbps=args.mean_rate_mbps,
                          mean_downlink_mbps=4 * args.mean_rate_mbps,
                          deadline_s=args.deadline,
                          energy_budget_j=args.energy_budget,
                          es_uplink_mbps=args.es_uplink_mbps,
                          cut_policy=args.cut_policy,
                          cut_candidates=tuple(args.cut_candidates or ()),
                          compute_gflops=args.compute_gflops,
                          compute_heterogeneity=args.compute_heterogeneity,
                          compute_power_w=args.compute_power_w,
                          codec_cycles_per_element=args.codec_cycles,
                          pipeline=args.pipeline,
                          faults=FaultConfig(erasure_prob=args.erasure_prob,
                                             max_retries=args.harq_retries,
                                             backoff_s=args.harq_backoff,
                                             crash_hazard=args.crash_hazard),
                          seed=args.seed)
    return build_scheduler(
        cfg, wcfg, clients=args.clients, seq=args.seq, rounds=args.rounds,
        local_steps=args.local_steps, micro=args.micro, codecs=codecs,
        population=args.population, sampling=args.sampling,
        seed=args.seed, device=resolve_device(device), telemetry=telemetry)


def main(argv=None):
    args = parse_args(argv)
    tel = (Telemetry(args.trace_dir, metrics_every=args.metrics_every,
                     kernels=True)
           if args.trace_dir else Telemetry.disabled())
    log = MetricLogger("train", telemetry=tel)
    cfg = get_arch(args.arch).reduced()
    scheduler = scheduler_from_args(cfg, args, args.device, telemetry=tel)
    tel.write_manifest(config=vars(args), seeds={"seed": args.seed},
                       extra={"arch": args.arch, "clients": args.clients})
    res = train(cfg, rounds=args.rounds, clients=args.clients,
                local_steps=args.local_steps, micro=args.micro,
                seq=args.seq, lr=args.lr, hsfl=args.hsfl,
                finetune_steps=args.finetune_steps, seed=args.seed,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                resume=args.resume, abort_after=args.abort_after,
                device=args.device, log=log, scheduler=scheduler)
    tel.close()
    if res.aborted_after is not None:
        print(json.dumps({"aborted_after_round": res.aborted_after}))
        return res
    out = {"final_loss": res.final_loss,
           "personalization_gain": res.personalization_gain}
    if scheduler is not None:
        out["sim_time_s"] = res.sim_time_s
        out["energy_left_j_min"] = float(scheduler.energy_left.min())
    print(json.dumps(out))
    return res


if __name__ == "__main__":
    main()
