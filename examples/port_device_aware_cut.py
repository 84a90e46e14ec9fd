"""Compute-aware cut selection: slow devices get shallower cuts.

    PYTHONPATH=src python examples/port_device_aware_cut.py \
        [--compute-gflops 10]

(the PyTorch port's counterpart of ``examples/device_aware_cut.py``: the
scheduler's numpy oracle on the host, as there; no device)

What happens:
  1. prints each candidate cut's TWO prices — the Remark-1 bits it moves
     and the client-block FLOPs it keeps on the device (the half of the
     trade-off the simulator could not see before the device model);
  2. drives the deadline-aware cut controller over a static channel where
     every client has the SAME 20 Mbps link but a lognormal spread of
     compute speeds (``compute_heterogeneity``): the compute-starved
     clients are steered to a shallower cut than their fast-channel peers,
     because the deep cut's client-side FLOPs — not its bits — would blow
     the deadline for them;
  3. re-runs the same scenario with ``compute_gflops=inf`` (the bits-only
     controller): every client picks the same deep cut, demonstrating the
     blind spot the device model closes.

The energy ledger also shows compute joules now: each scheduled client is
charged ``compute_power_w * compute_s`` on top of its transmit energy.
"""

import argparse

import numpy as np

from repro_torch.configs.base import WirelessConfig
from repro_torch.configs.phsfl_cnn import CONFIG as CNN_CFG
from repro_torch.core.comm import comm_table_for_cnn
from repro_torch.core.hierarchy import es_assignment
from repro_torch.models.cnn import CUT_CANDIDATES
from repro_torch.wireless import client_round_bits, client_round_flops, \
    make_scheduler

KAPPA0 = 2


def run(gflops: float, sigma: float, args, table):
    cfg = WirelessConfig(model="static", mean_uplink_mbps=20.0,
                         mean_downlink_mbps=80.0, latency_s=0.02,
                         deadline_s=args.deadline,
                         cut_policy="deadline", cut_candidates=CUT_CANDIDATES,
                         compute_gflops=gflops, compute_heterogeneity=sigma,
                         compute_power_w=0.2, energy_budget_j=50.0,
                         seed=args.seed)
    sched = make_scheduler(cfg, 8, kappa0=KAPPA0, comm_table=table,
                           es_assign=es_assignment(8, 4))
    rep = sched.step(0)
    return sched, rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--compute-gflops", type=float, default=10.0)
    ap.add_argument("--compute-heterogeneity", type=float, default=1.0)
    ap.add_argument("--deadline", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    table = comm_table_for_cnn(CNN_CFG, dataset_size=400, batch_size=16,
                               batches_per_epoch=2)
    print("== candidate cuts: bits moved vs FLOPs kept on the client ==")
    for name, cm in table.items():
        bits = client_round_bits(cm, KAPPA0)
        flops = client_round_flops(cm, KAPPA0)
        print(f"  {name:5s}: uplink {bits.uplink / 1e6:6.1f} Mb/round   "
              f"client compute {flops / 1e9:5.2f} GFLOP/round")

    print(f"\n== deadline policy, same 20 Mbps channel for all 8 clients, "
          f"compute ~lognormal(sigma={args.compute_heterogeneity}) around "
          f"{args.compute_gflops} GFLOP/s ==")
    sched, rep = run(args.compute_gflops, args.compute_heterogeneity, args,
                     table)
    order = np.argsort(sched.device.flops_per_s)
    for u in order:
        cut = CUT_CANDIDATES[rep.cuts[u]]
        status = ("made deadline" if rep.mask[u] else
                  ("straggled" if rep.scheduled[u] else "not scheduled"))
        print(f"  client {u}: {sched.device.flops_per_s[u] / 1e9:6.1f} "
              f"GFLOP/s -> cut {cut:5s}  compute {rep.compute_s[u]:5.2f}s  "
              f"tx+compute energy "
              f"{sched.cfg.energy_budget_j - rep.energy_left_j[u]:4.2f}J  "
              f"({status})")
    slow, fast = order[0], order[-1]
    assert rep.cuts[slow] <= rep.cuts[fast], "slowest device went deeper?!"
    if rep.cuts[slow] < rep.cuts[fast]:
        print(f"  -> compute-starved client {slow} sits at "
              f"{CUT_CANDIDATES[rep.cuts[slow]]} while its fast peer {fast} "
              f"holds {CUT_CANDIDATES[rep.cuts[fast]]}")
    else:
        print(f"  -> every device keeps up at this compute rate (all at "
              f"{CUT_CANDIDATES[rep.cuts[fast]]}); lower --compute-gflops "
              f"or raise --compute-heterogeneity to see the steering")

    print("\n== same scenario, bits-only controller (compute_gflops=inf) ==")
    _, rep0 = run(float("inf"), args.compute_heterogeneity, args, table)
    picked = sorted({CUT_CANDIDATES[c] for c in rep0.cuts})
    print(f"  every client picks {picked} — the compute spread is invisible "
          f"when FLOPs are priced at zero")


if __name__ == "__main__":
    main()
