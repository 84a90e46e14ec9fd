"""The hierarchy and training configs of the PHSFL simulation.

Copies of ``HierarchyConfig`` and ``TrainConfig`` from
``repro.configs.base`` (the port imports nothing of the reference
package).  Fields the port does not use yet (the datacenter-mode knobs)
stay, so one config means the same run on both sides.
"""

from __future__ import annotations

from dataclasses import dataclass


# --------------------------------------------------------------------------
# PHSFL hierarchy (Sec. II-B / III-A of the paper)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class HierarchyConfig:
    num_edge_servers: int = 4        # B
    clients_per_es: int = 25         # U_b (uniform here; weights may differ)
    kappa0: int = 5                  # local SGD steps per edge round
    kappa1: int = 3                  # edge rounds per global round
    global_rounds: int = 100         # R
    # aggregation weights: "uniform" or "data" (proportional to |D_u|)
    weighting: str = "data"

    @property
    def num_clients(self) -> int:
        return self.num_edge_servers * self.clients_per_es

    @property
    def steps_per_global_round(self) -> int:
        return self.kappa0 * self.kappa1


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 0.01      # eta (paper: SGD, eta=0.01)
    finetune_lr: float = 0.01        # eta~ for the head fine-tune (Eq. 18)
    finetune_steps: int = 10         # K
    batch_size: int = 32             # N
    optimizer: str = "sgd"           # sgd | momentum | adamw
    momentum: float = 0.0
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    seed: int = 0
    freeze_head: bool = True         # PHSFL; False -> HSFL baseline
    # datacenter mode: microbatches per local round inside the fused step
    local_steps_in_step: int = 2
    remat: bool = True               # activation checkpointing per block
    remat_policy: str = "full"       # full | dots (selective, §Perf knob)
    shared_server: bool = False      # beyond-paper SFL-V2-style body sharing
    agg_dtype: str = "float32"       # aggregation psum dtype (perf knob)
