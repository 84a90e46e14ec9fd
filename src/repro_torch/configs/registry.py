"""Architecture registry: ``--arch <id>`` resolution.

Holds the architectures whose every block kind the port can run.  The
reference registry (``repro.configs.registry``) knows more; asking for one
of those raises a ``KeyError`` that names what the port still lacks.
"""

from __future__ import annotations

from repro_torch.configs import gemma3_12b, recurrentgemma_2b, xlstm_350m
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (gemma3_12b, xlstm_350m, recurrentgemma_2b)
}

# the reference's other architectures, and what each needs beyond the
# LM slices (global/sliding-window attention with a dense gated MLP;
# the mLSTM and sLSTM blocks; the RG-LRU block)
NOT_PORTED: dict[str, str] = {
    "command-r-plus-104b": "its config (dense attention, layernorm)",
    "mistral-large-123b": "its config (dense attention)",
    "gemma3-27b": "its config (dense attention, 62 layers)",
    "olmoe-1b-7b": "the MoE FFN",
    "deepseek-v2-236b": "MLA attention and the MoE FFN",
    "qwen2-vl-7b": "M-RoPE and the vision-patch frontend",
    "seamless-m4t-medium": "the encoder-decoder model",
}


def get_arch(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet: the port lacks "
                       f"{NOT_PORTED[name]}; ported: {sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; ported: {sorted(ARCHS)}, "
                   f"not yet ported: {sorted(NOT_PORTED)}")
