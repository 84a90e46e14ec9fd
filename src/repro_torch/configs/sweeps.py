"""The canonical small-scale sweep scenario shared by the benchmark tables
(the port's copy of ``repro.configs.sweeps``, field for field).

The cut and codec sweeps are meant to be comparable cells of one
experiment grid: the same 2-ES x 4-client hierarchy, the same training
recipe, the same 20/80 Mbps channel.  Keeping the literals here means
tuning one sweep's scenario cannot silently de-calibrate it from the
other.
"""

from __future__ import annotations

from repro_torch.configs.base import (HierarchyConfig, TrainConfig,
                                      WirelessConfig)


def sweep_hierarchy(rounds: int, *, kappa0: int = 2) -> HierarchyConfig:
    return HierarchyConfig(num_edge_servers=2, clients_per_es=4,
                           kappa0=kappa0, kappa1=2, global_rounds=rounds)


def sweep_train() -> TrainConfig:
    return TrainConfig(learning_rate=0.05, batch_size=16, freeze_head=True)


def sweep_wireless(channel: str, **overrides) -> WirelessConfig:
    """The sweeps' shared channel: 20/80 Mbps mean rates, 20 ms latency.
    Per-sweep knobs (deadline, ES capacity, energy budget, cut policy,
    seed, ...) ride in as overrides."""
    return WirelessConfig(model=channel, mean_uplink_mbps=20.0,
                          mean_downlink_mbps=80.0, latency_s=0.02,
                          **overrides)
