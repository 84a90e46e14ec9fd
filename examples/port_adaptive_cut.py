"""Adaptive cut-layer selection under a shared, fading ES uplink.

    PYTHONPATH=src python examples/port_adaptive_cut.py \
        [--deadline 4.0] [--device cpu]

(the PyTorch port's counterpart of ``examples/adaptive_cut.py``: on the
card unless ``--device cpu``)

What happens:
  1. prints the Remark-1 byte accounting of every candidate cut of the
     paper's CNN — the cut trades the per-minibatch activation tensor
     (N * Z_c, shrinking as the cut deepens) against the client-block
     offload (Z_0, growing with depth);
  2. runs the SAME federation three times over a Rayleigh-faded channel
     where the 4 clients of each ES share one uplink pipe: pinned to the
     shallow cut, pinned to the deep cut, and with the deadline-aware
     controller that re-picks each client's cut every round from the
     contended rate (repro_torch.wireless.cutter);
  3. prints per-run participation, mean chosen cut, and simulated
     wall-clock — the adaptive controller keeps clients in rounds a frozen
     cut would price out.

By the paper's Remark 2 all three runs would train IDENTICALLY on an ideal
network (see test_torch_split.py for the check) — the cut only decides
who pays which bits, which is exactly why it is free to chase the channel.
"""

import argparse

import numpy as np

from repro_torch.configs.base import (HierarchyConfig, TrainConfig,
                                      WirelessConfig)
from repro_torch.configs.phsfl_cnn import CONFIG as CNN_CFG
from repro_torch.core.comm import comm_table_for_cnn
from repro_torch.core.fedsim import FedSim
from repro_torch.data.synthetic import make_federated_image_data
from repro_torch.models.cnn import CUT_CANDIDATES
from repro_torch.wireless import client_round_bits


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--deadline", type=float, default=4.0)
    ap.add_argument("--es-uplink-mbps", type=float, default=40.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    h = HierarchyConfig(num_edge_servers=2, clients_per_es=4, kappa0=2,
                        kappa1=2, global_rounds=args.rounds)
    t = TrainConfig(learning_rate=0.05, batch_size=16, freeze_head=True)

    print("== candidate cuts (Remark 1: who pays which bits) ==")
    table = comm_table_for_cnn(CNN_CFG, dataset_size=400,
                               batch_size=t.batch_size, batches_per_epoch=2)
    for name, cm in table.items():
        bits = client_round_bits(cm, h.kappa0)
        print(f"  {name:5s}: Z_0 {cm.client_params:>9,} params   "
              f"Z_c {cm.cut_size:>6,} /sample   "
              f"uplink {bits.uplink / 1e6:6.1f} Mb/round")

    fed = make_federated_image_data(8, alpha=0.3, train_per_class=40,
                                    test_per_class=20, seed=args.seed)

    def wireless(policy, candidates):
        return WirelessConfig(model="rayleigh", mean_uplink_mbps=20.0,
                              mean_downlink_mbps=80.0, latency_s=0.02,
                              deadline_s=args.deadline,
                              es_uplink_mbps=args.es_uplink_mbps,
                              cut_policy=policy, cut_candidates=candidates,
                              seed=args.seed)

    runs = [("fixed shallow (conv1)", "fixed", (CUT_CANDIDATES[0],),
             CUT_CANDIDATES[0]),
            ("fixed deep (fc1)", "fixed", (CUT_CANDIDATES[-1],),
             CUT_CANDIDATES[-1]),
            ("deadline-aware", "deadline", CUT_CANDIDATES, None)]
    for label, policy, candidates, train_cut in runs:
        sim = FedSim(CNN_CFG, fed, h, t, batches_per_epoch=2, seed=args.seed,
                     wireless=wireless(policy, candidates), cut=train_cut,
                     device=args.device)
        res = sim.run(rounds=args.rounds, log_every=args.rounds)
        parts = np.mean([n["participants"] for n in res.network])
        cuts = np.mean([n.get("mean_cut", 0.0) for n in res.network])
        print(f"== {label} ==")
        print(f"  participation {parts:.1f}/8 per round   mean cut index "
              f"{cuts:.2f}   sim clock {res.total_sim_time_s:.1f}s   "
              f"final acc {res.history[-1]['test_acc']:.3f}")


if __name__ == "__main__":
    main()
