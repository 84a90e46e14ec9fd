"""The paper's pipeline end-to-end (scaled down): hierarchical split
federated training with a frozen classifier -> per-client head fine-tuning
-> per-client evaluation, vs the HSFL baseline.

    PYTHONPATH=src python examples/port_personalized_federation.py \
        [--device cpu]

(the PyTorch port's counterpart of ``examples/personalized_federation.py``:
on the card unless ``--device cpu``)
"""

import argparse

from repro_torch.configs.base import HierarchyConfig, TrainConfig
from repro_torch.configs.phsfl_cnn import CONFIG as CNN_CFG
from repro_torch.core.fedsim import FedSim
from repro_torch.data.synthetic import make_federated_image_data


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    # 2 edge servers x 8 clients, Dir(0.2) non-IID synthetic images
    data = make_federated_image_data(16, alpha=0.2, train_per_class=100,
                                     test_per_class=40, seed=0)
    h = HierarchyConfig(num_edge_servers=2, clients_per_es=8, kappa0=3,
                        kappa1=2, global_rounds=8)
    print(f"{'algo':8s} {'global acc':>12s} {'personalized':>13s} {'gain':>7s}")
    for algo, freeze in (("phsfl", True), ("hsfl", False)):
        t = TrainConfig(learning_rate=0.05, batch_size=32, freeze_head=freeze,
                        finetune_steps=10, finetune_lr=0.05)
        sim = FedSim(CNN_CFG, data, h, t, batches_per_epoch=2, seed=0,
                     device=args.device)
        res = sim.run(rounds=8, log_every=8)
        heads, per = sim.personalize(res.global_params)
        g = res.per_client_global["acc"].mean()
        p = per["acc"].mean()
        print(f"{algo:8s} {g:12.4f} {p:13.4f} {p - g:7.4f}")


if __name__ == "__main__":
    main()
