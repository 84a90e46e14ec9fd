from repro_torch.optim.optimizers import (
    Optimizer,
    sgd,
    momentum,
    adamw,
    masked,
    make_optimizer,
    apply_updates,
    global_norm,
    clip_by_global_norm,
    zeros_view,
)
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine

__all__ = [
    "Optimizer", "sgd", "momentum", "adamw", "masked", "make_optimizer",
    "apply_updates", "global_norm", "clip_by_global_norm", "zeros_view",
    "constant", "cosine_decay", "warmup_cosine",
]
