"""Model splitting (the SL part of PHSFL, paper Sec. III-A Steps
2.1–2.2; ``repro.core.split``).

The model parameter tree is partitioned into three parts:

    client  w_{b,0}    — embedding + first n_client_layers blocks (trained
                         on the client device)
    body    w_{b,1,bd} — remaining blocks + final norm (trained on the ES)
    head    w_{b,1,hd} — the output classifier (randomly initialized and
                         FROZEN during global training, Eq. 12; fine-tuned
                         per client for personalization, Eq. 18)

The split is a partition of the parameters plus masking (the paper's
Remark 2: the cut-layer choice does not change learning dynamics).  The
literal activation exchange is ``core/fedsim.py`` on the paper's CNN.
Paths are '/'-joined, as ``utils.tree.path_leaves`` renders them.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.phsfl_cnn import CNNConfig
from repro_torch.utils.tree import map_with_path, path_leaves

# training phases
GLOBAL_TRAIN = "global_train"      # PHSFL: everything but the head trains
HSFL_TRAIN = "hsfl_train"          # baseline: everything trains
PERSONALIZE = "personalize"        # only the head trains (Eq. 18)


@dataclass(frozen=True)
class SplitSpec:
    client_patterns: tuple[str, ...]
    head_patterns: tuple[str, ...]

    def part_of(self, path: str) -> str:
        if any(re.search(p, path) for p in self.head_patterns):
            return "head"
        if any(re.search(p, path) for p in self.client_patterns):
            return "client"
        return "body"


def split_spec_for(cfg, cut=None) -> SplitSpec:
    """The SplitSpec of a model config.

    ``cut`` selects the candidate boundary the client/body split falls on:
    a cut NAME from ``cnn.CUT_CANDIDATES`` for the CNN, or an int
    overriding ``cfg.n_client_layers`` for LMs.  ``None`` keeps the
    config's default.  By the paper's Remark 2 the choice never changes
    learning dynamics, only the byte accounting.
    """
    if isinstance(cfg, CNNConfig):
        from repro_torch.models import cnn
        keys = cnn.client_keys_for(cut if cut is not None else cnn.DEFAULT_CUT)
        return SplitSpec(
            client_patterns=tuple(f"^{k}(/|$)" for k in keys),
            head_patterns=tuple(f"^{k}(/|$)" for k in cnn.HEAD_KEYS),
        )
    if not isinstance(cfg, ModelConfig):
        raise TypeError(f"no split for {type(cfg).__name__}")
    n_client = cfg.n_client_layers if cut is None else int(cut)
    if cfg.encdec is not None:
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder: its frontend-based split "
            f"comes with that model in a later slice")
    # decoder LMs: compute_stages puts the first n_client_layers in the
    # unscanned stage0 ("lead"); they and the embedding form w_0
    from repro_torch.models.transformer import compute_stages
    stages = compute_stages(cfg)
    client: list[str] = [r"^embed(/|$)"]
    if n_client and stages and stages[0].which == "lead":
        for j, lid in enumerate(stages[0].layer_ids):
            if lid < n_client:
                client.append(rf"^stage0/b{j}(/|$)")
    return SplitSpec(client_patterns=tuple(client),
                     head_patterns=(rf"^{cfg.head_name}(/|$)",))


def part_masks(params, spec: SplitSpec):
    """Boolean mask trees for each part; exactly one True per leaf."""
    def mk(part):
        return map_with_path(lambda path, _: spec.part_of(path) == part,
                             params)

    return {"client": mk("client"), "body": mk("body"), "head": mk("head")}


def trainable_mask(params, spec: SplitSpec, phase: str):
    """What trains in each phase (True = trainable)."""
    if phase == GLOBAL_TRAIN:
        return map_with_path(lambda p, _: spec.part_of(p) != "head", params)
    if phase == HSFL_TRAIN:
        return map_with_path(lambda p, _: True, params)
    if phase == PERSONALIZE:
        return map_with_path(lambda p, _: spec.part_of(p) == "head", params)
    raise ValueError(phase)


def count_parts(params, spec: SplitSpec):
    """Parameter counts per part (Z_0, Z_bd, Z_hd of the paper)."""
    counts = {"client": 0, "body": 0, "head": 0}
    for path, leaf in path_leaves(params):
        counts[spec.part_of(path)] += math.prod(leaf.shape)
    return counts
