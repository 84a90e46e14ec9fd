"""PHSFL over a wireless network: straggler dropout vs the ideal network.

    PYTHONPATH=src python examples/port_wireless_phsfl.py \
        [--deadline 1.0] [--device cpu]

(the PyTorch port's counterpart of ``examples/wireless_phsfl.py``: on
the card unless ``--device cpu``)

What happens:
  1. runs the paper-faithful CNN simulator on an IDEAL network (every
     client aggregates every edge round — the pre-wireless behavior);
  2. re-runs the SAME federation over a Rayleigh-faded channel with an
     edge-round deadline: per round, each client's uplink/downlink airtime
     for its cut-layer traffic (Remark 1 accounting) decides whether it
     makes the deadline, and Eq. 14-16 weights renormalize over the
     participants;
  3. prints per-round participation, simulated wall-clock, and the final
     accuracy gap the deadline costs.

Also demonstrates the LM-scale path:

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \
        --rounds 3 --clients 4 --channel rayleigh --deadline 0.5
"""

import argparse

from repro_torch.configs.base import (HierarchyConfig, TrainConfig,
                                      WirelessConfig)
from repro_torch.configs.phsfl_cnn import CONFIG as CNN_CFG
from repro_torch.core.fedsim import FedSim
from repro_torch.data.synthetic import make_federated_image_data


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--deadline", type=float, default=1.0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    fed = make_federated_image_data(8, alpha=0.3, train_per_class=40,
                                    test_per_class=20, seed=args.seed)
    h = HierarchyConfig(num_edge_servers=2, clients_per_es=4, kappa0=2,
                        kappa1=2, global_rounds=args.rounds)
    t = TrainConfig(learning_rate=0.05, batch_size=16, freeze_head=True)

    print("== ideal network ==")
    ideal = FedSim(CNN_CFG, fed, h, t, batches_per_epoch=2, seed=args.seed,
                   device=args.device)
    res_i = ideal.run(rounds=args.rounds, log_every=1)
    for row in res_i.history:
        print(f"  round {row['round']}: acc {row['test_acc']:.3f}")

    print(f"== rayleigh channel, deadline {args.deadline}s ==")
    w = WirelessConfig(model="rayleigh", mean_uplink_mbps=20.0,
                       mean_downlink_mbps=80.0, latency_s=0.02,
                       deadline_s=args.deadline, seed=args.seed)
    sim = FedSim(CNN_CFG, fed, h, t, batches_per_epoch=2, seed=args.seed,
                 wireless=w, device=args.device)
    res_w = sim.run(rounds=args.rounds, log_every=1)
    for row in res_w.history:
        print(f"  round {row['round']}: acc {row['test_acc']:.3f}  "
              f"participants {row['mean_participants']:.1f}/8  "
              f"sim clock {row['sim_time_s']:.1f}s")
    gap = res_i.history[-1]["test_acc"] - res_w.history[-1]["test_acc"]
    print(f"accuracy cost of the {args.deadline}s deadline: {gap:+.3f} "
          f"(at {res_w.total_sim_time_s:.1f}s simulated wall-clock)")


if __name__ == "__main__":
    main()
