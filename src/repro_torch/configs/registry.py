"""Architecture registry: ``--arch <id>`` resolution.

Holds the architectures whose every block kind the port can run.  The
reference registry (``repro.configs.registry``) knows one more, the
encoder-decoder; asking for it raises a ``KeyError`` that names what the
port still lacks.
"""

from __future__ import annotations

from repro_torch.configs import (command_r_plus_104b, deepseek_v2_236b,
                                 gemma3_12b, gemma3_27b, mistral_large_123b,
                                 olmoe_1b_7b, qwen2_vl_7b, recurrentgemma_2b,
                                 xlstm_350m)
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (command_r_plus_104b, olmoe_1b_7b, mistral_large_123b,
              qwen2_vl_7b, xlstm_350m, gemma3_27b, recurrentgemma_2b,
              gemma3_12b, deepseek_v2_236b)
}

# the reference's other architecture, and what it needs beyond the
# decoder LMs
NOT_PORTED: dict[str, str] = {
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
