"""Quantized smashed data: a deep cut infeasible at fp32 becomes feasible.

    PYTHONPATH=src python examples/port_compressed_phsfl.py \
        [--deadline 1.0] [--device cpu]

(the PyTorch port's counterpart of ``examples/compressed_phsfl.py``: on
the card unless ``--device cpu``; the int8 runs go through the
quantize-dequantize kernel there)

What happens:
  1. prints the Remark-1 byte table of every (cut, codec) cell — the
     compression subsystem (repro_torch.compress) makes the bits the cut
     controller optimizes over configurable, so the cut x codec grid is
     just more candidate cells with fewer bits;
  2. runs the SAME federation three times over a static channel with a
     shared ES uplink and a round deadline, at the paper's kappa0 = 5
     local epochs (where the per-minibatch activation stream dominates):
     the deep cut (fc1) at fp32 — its 2.17M-param offload alone is ~72 Mb,
     hopeless; the paper cut (conv1) at int8 — activations still stream
     ~52 Mb/round, a straggler at any deadline the deep cut can make; and
     the deep cut at int8 — tiny activations AND an affordable 17 Mb
     offload, the only cell of the grid that participates at all;
  3. prints per-run scheduled/participating clients, bits moved, and final
     accuracy — the joint (cut, codec) choice turns a dead network into a
     training one.

Unlike the cut (Remark 2), a lossy codec DOES touch learning dynamics —
the int8 runs pay a small stochastic-rounding tax in exchange for
participating at all.  tests/test_torch_fedsim.py pins the identity codec
to the uncompressed trajectory bit-for-bit.
"""

import argparse

import numpy as np

from repro_torch.compress import link_codecs
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
    ap.add_argument("--deadline", type=float, default=2.5)
    ap.add_argument("--es-uplink-mbps", type=float, default=40.0)
    ap.add_argument("--energy-budget", type=float, default=4.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    h = HierarchyConfig(num_edge_servers=2, clients_per_es=4, kappa0=5,
                        kappa1=2, global_rounds=args.rounds)
    t = TrainConfig(learning_rate=0.05, batch_size=16, freeze_head=True)

    print("== cut x codec byte table (Remark 1 with configurable bits) ==")
    named = {"fp32": None, "int8": link_codecs("int8")}
    table = comm_table_for_cnn(CNN_CFG, dataset_size=400,
                               batch_size=t.batch_size, batches_per_epoch=5,
                               codecs=named)
    for (cut, codec), cm in table.items():
        bits = client_round_bits(cm, h.kappa0)
        print(f"  {cut:5s} x {codec:4s}: Z_0 {cm.client_params:>9,} params   "
              f"uplink {bits.uplink / 1e6:6.1f} Mb/round")

    fed = make_federated_image_data(8, alpha=0.3, train_per_class=40,
                                    test_per_class=20, seed=args.seed)
    wireless = WirelessConfig(model="static", mean_uplink_mbps=20.0,
                              mean_downlink_mbps=80.0, latency_s=0.02,
                              deadline_s=args.deadline,
                              es_uplink_mbps=args.es_uplink_mbps,
                              energy_budget_j=args.energy_budget,
                              seed=args.seed)

    runs = [("fp32, deep cut (fc1)", None, CUT_CANDIDATES[-1]),
            ("int8, paper cut (conv1)", link_codecs("int8"),
             CUT_CANDIDATES[0]),
            ("int8, deep cut (fc1)", link_codecs("int8"),
             CUT_CANDIDATES[-1])]
    for label, codecs, cut in runs:
        sim = FedSim(CNN_CFG, fed, h, t, batches_per_epoch=5,
                     seed=args.seed, wireless=wireless, cut=cut,
                     codecs=codecs, device=args.device)
        res = sim.run(rounds=args.rounds, log_every=args.rounds)
        sched = np.mean([n["scheduled"] for n in res.network])
        parts = np.mean([n["participants"] for n in res.network])
        bits = np.sum([n["bits"] for n in res.network])
        print(f"== {label} ==")
        print(f"  scheduled {sched:.1f}/8   participating {parts:.1f}/8   "
              f"bits {bits / 1e6:.1f} Mb   "
              f"final acc {res.history[-1]['test_acc']:.3f}")


if __name__ == "__main__":
    main()
