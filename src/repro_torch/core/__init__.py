"""The paper's primary contribution: PHSFL — model splitting, hierarchical
multi-timescale aggregation, frozen-head training, and head personalization —
plus the faithful small-scale simulator, comm accounting, and Theorem-1
bound calculator (the reference's ``repro.core`` names, from the port's
modules; ``fedsim`` imports the wireless package only when a run asks for
a network, so ``repro_torch.wireless`` may import ``core.comm``)."""

from repro_torch.core.split import (
    SplitSpec, split_spec_for, part_masks, trainable_mask, count_parts,
    GLOBAL_TRAIN, HSFL_TRAIN, PERSONALIZE)
from repro_torch.core.hierarchy import (
    edge_aggregate, global_aggregate, masked_edge_aggregate,
    masked_global_aggregate, edge_aggregate_mesh, global_aggregate_mesh,
    masked_psum_weighted, sgd_step_index, normalized_weights)
from repro_torch.core.phsfl import (
    make_phsfl_round, make_host_round, make_shared_server_step,
    build_optimizer, abstract_params, init_stacked_params,
    init_shared_server_params, PHSFLRound, SharedServerStep)
from repro_torch.core.personalize import (
    personalize_head_bank, personalized_eval, merge_head, extract_head,
    head_loss)
from repro_torch.core.fedsim import (FedSim, centralized_sgd, split_grad,
                                     monolithic_grad)
from repro_torch.core.comm import (CommModel, comm_for_cnn, comm_for_lm,
                                   comm_table_for_cnn, comm_table_for_lm)
from repro_torch.core.theory import (BoundInputs, bound_terms, lr_limit,
                                     uniform_weights)

__all__ = [
    "SplitSpec", "split_spec_for", "part_masks", "trainable_mask",
    "count_parts", "GLOBAL_TRAIN", "HSFL_TRAIN", "PERSONALIZE",
    "edge_aggregate", "global_aggregate", "masked_edge_aggregate",
    "masked_global_aggregate", "edge_aggregate_mesh",
    "global_aggregate_mesh", "masked_psum_weighted",
    "sgd_step_index", "normalized_weights",
    "make_phsfl_round", "make_host_round",
    "make_shared_server_step", "build_optimizer",
    "abstract_params", "init_stacked_params", "init_shared_server_params",
    "PHSFLRound", "SharedServerStep",
    "personalize_head_bank", "personalized_eval", "merge_head",
    "extract_head", "head_loss",
    "FedSim", "centralized_sgd", "split_grad", "monolithic_grad",
    "CommModel", "comm_for_cnn", "comm_for_lm",
    "comm_table_for_cnn", "comm_table_for_lm",
    "BoundInputs", "bound_terms", "lr_limit", "uniform_weights",
]
