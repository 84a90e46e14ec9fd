from repro_torch.checkpoint.ckpt import (latest_step, load_checkpoint,
                                         save_checkpoint)
from repro_torch.checkpoint.rng import restore_rng_state, rng_state_array

__all__ = ["latest_step", "load_checkpoint", "save_checkpoint",
           "restore_rng_state", "rng_state_array"]
