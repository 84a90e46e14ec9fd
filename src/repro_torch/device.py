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
    setting does not depend on what the process set before.  cuDNN is
    pinned to deterministic algorithms, chosen by its heuristics rather
    than by timing (``benchmark`` off): its default weight gradient for
    the CNN's grouped convolutions (``wgrad_alg0_engine``) accumulates
    with atomics in a run-dependent order, so two runs of one FedSim
    cell differed in the last bits and a resumed run did not repeat the
    whole one.  The process-wide ``torch.use_deterministic_algorithms``
    stays off: the code that needs a fixed order already has one (the
    wireless core's ordered sums, ``wireless/scheduler_core.py``), and the
    switch would raise on ops that need none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
