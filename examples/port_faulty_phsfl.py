"""Fault injection + recovery: erasures, HARQ, outages, crashes, resume.

    PYTHONPATH=src python examples/port_faulty_phsfl.py \
        [--erasure 0.3]

(the PyTorch port's counterpart of ``examples/faulty_phsfl.py``: the
scheduler's numpy oracle on the host, as there; no device)

What happens (scheduler only — seconds, no training):
  1. prints one client's explicit event timeline on a round with payload
     erasures: the erased uplink is RETRANSMITTED as extra real segments
     (each after a ``backoff_s`` radio gap), so its airtime, energy, and
     moved bits flow through the same deadline gate and ledger as any
     first transmission; the report splits total air bits from the
     retransmit overhead (``retx_bits``/``retx_j``);
  2. compares three recovery policies over many rounds at the same
     erasure rate: hard drop (``max_retries=0``), HARQ, and
     HARQ + staleness banking (retry-exhausted updates deliver late and
     discounted instead of vanishing) — effective participation recovers
     step by step;
  3. marks an edge server DOWN for a round (``es_outage_trace``): its
     clients re-associate to the nearest live ES (``RoundReport.es_map``)
     or sit out under ``failover="skip"``;
  4. crashes clients mid-round (``crash_hazard``): the timeline truncates
     at the crash instant — partial compute/airtime are charged, nothing
     is delivered, nothing is banked;
  5. snapshots the scheduler mid-chaos (``state_dict``) and replays the
     remaining rounds in a FRESH scheduler — bit-identical, fault stream
     included (the checkpoint/resume contract ``launch/train.py --resume``
     and ``FedSim.save/restore`` are built on).
"""

import argparse

import numpy as np

from repro_torch.configs.base import FaultConfig, WirelessConfig
from repro_torch.core.comm import comm_for_cnn
from repro_torch.configs.phsfl_cnn import CONFIG as CNN_CFG
from repro_torch.core.hierarchy import es_assignment
from repro_torch.wireless import client_round_bits, make_scheduler

KAPPA0 = 2
U = 8


def scenario(args, **faults) -> WirelessConfig:
    return WirelessConfig(model="static", mean_uplink_mbps=20.0,
                          mean_downlink_mbps=80.0, latency_s=0.02,
                          heterogeneity=0.5, deadline_s=args.deadline,
                          selection="random", participation_prob=0.8,
                          staleness_lambda=faults.pop("lam", 0.0),
                          faults=FaultConfig(**faults), seed=args.seed)


def _sched(comm, cfg):
    return make_scheduler(cfg, U, comm, KAPPA0,
                          es_assign=es_assignment(U, U // 2))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--erasure", type=float, default=0.3)
    ap.add_argument("--deadline", type=float, default=4.0)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--client", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    comm = comm_for_cnn(CNN_CFG, dataset_size=400, batch_size=16,
                        batches_per_epoch=2)
    bits = client_round_bits(comm, KAPPA0)

    # 1. the HARQ timeline, segment by segment
    print(f"--- HARQ timeline, erasure={args.erasure}, backoff=0.05s "
          f"(client {args.client}) ---")
    s = _sched(comm, scenario(args, erasure_prob=args.erasure,
                              max_retries=3, backoff_s=0.05))
    for r in range(4):                      # find a round with a retx
        link = s.channel.sample(r)
        plan = s.injector.round_plan()
        if plan.up_attempts[args.client].max() > 1:
            break
    s._plan = plan
    tl = s._timeline(link, bits, s._compute_s(None))
    for seg in tl.segments(args.client):
        span = f"[{seg['start']:7.3f}, {seg['end']:7.3f})"
        extra = f"  {seg['bits']:,.0f} bits" if "bits" in seg else ""
        print(f"  {seg['kind']:8s} {span}{extra}")
    print(f"  attempts per payload: {plan.up_attempts[args.client]}, "
          f"air {tl.air_up_bits[args.client]:,.0f} bits vs goodput "
          f"{tl.goodput_up_bits[args.client]:,.0f}\n")

    # 2. recovery policies at the same erasure rate
    print(f"--- recovery over {args.rounds} rounds at "
          f"erasure={args.erasure} ---")
    cells = {"hard drop  ": scenario(args, erasure_prob=args.erasure,
                                     max_retries=0),
             "harq       ": scenario(args, erasure_prob=args.erasure,
                                     max_retries=3),
             "harq+stale ": scenario(args, erasure_prob=args.erasure,
                                     max_retries=3, lam=0.5)}
    for name, cfg in cells.items():
        sc = _sched(comm, cfg)
        live = deliv = retx = 0.0
        for r in range(args.rounds):
            rep = sc.step(r)
            live += rep.num_participants
            if rep.stale_delivered is not None:
                deliv += int((rep.stale_delivered > 0).sum())
            retx += rep.retx_bits
        print(f"  {name} live {live / (args.rounds * U):5.1%}  "
              f"effective {(live + deliv) / (args.rounds * U):5.1%}  "
              f"retx {retx / 1e6:8.1f} Mbit")

    # 3. an ES outage round: reassoc vs skip
    print("\n--- ES 1 down for one round ---")
    for policy in ("reassoc", "skip"):
        sc = _sched(comm, scenario(args, es_outage_trace=((0, 1),),
                                   failover=policy))
        rep = sc.step(0)
        home = f"es_map {rep.es_map}" if rep.es_map is not None else \
            f"ES-1 clients sat out ({int(rep.scheduled[4:].sum())} sched)"
        print(f"  {policy:8s}: participants {rep.num_participants}/{U}, "
              f"{home}")

    # 4. crashes
    sc = _sched(comm, scenario(args, crash_hazard=0.4))
    crashed = sched = 0
    for r in range(6):
        rep = sc.step(r)
        crashed += int(rep.crashed.sum())
        sched += int(rep.scheduled.sum())
    print(f"\n--- crash_hazard=0.4 over 6 rounds: {crashed}/{sched} "
          f"scheduled client-rounds died mid-round (partial compute and "
          f"airtime charged, nothing delivered or banked) ---")

    # 5. checkpoint/resume mid-chaos, bit-identical
    chaos = dict(erasure_prob=args.erasure, max_retries=2,
                 crash_hazard=0.2, lam=0.5)
    ref = _sched(comm, scenario(args, **chaos))
    want = [ref.step(r) for r in range(8)]
    sc = _sched(comm, scenario(args, **chaos))
    for r in range(4):
        sc.step(r)
    snap = sc.state_dict()
    fresh = _sched(comm, scenario(args, **chaos))
    fresh.load_state_dict(snap)
    same = all(np.array_equal(fresh.step(r).mask, want[r].mask)
               for r in range(4, 8))
    print(f"\nresume from a round-4 snapshot replays rounds 4..7 "
          f"bit-identically: {same}")
    assert same


if __name__ == "__main__":
    main()
