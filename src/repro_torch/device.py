"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU: there is
no silent fallback, because a run that quietly lands on the CPU would
report CPU numbers under a GPU's name.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; the CPU only when asked for by name.

    On the card path this also pins float32 numerics: cuDNN convolutions
    otherwise run in TF32 (about three decimal digits), while the JAX
    reference computes in full float32.  Matmuls are pinned too, so the
    setting does not depend on what the process set before."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
