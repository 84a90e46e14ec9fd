"""Architecture registry: ``--arch <id>`` resolution.

Holds every architecture of the reference registry
(``repro.configs.registry``).  ``NOT_PORTED`` names any the port cannot
run yet, with what it lacks; asking for one raises a ``KeyError`` that
says so.  It is empty: the encoder-decoder closed the zoo.
"""

from __future__ import annotations

from repro_torch.configs import (command_r_plus_104b, deepseek_v2_236b,
                                 gemma3_12b, gemma3_27b, mistral_large_123b,
                                 olmoe_1b_7b, qwen2_vl_7b, recurrentgemma_2b,
                                 seamless_m4t_medium, xlstm_350m)
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (command_r_plus_104b, olmoe_1b_7b, mistral_large_123b,
              qwen2_vl_7b, xlstm_350m, gemma3_27b, recurrentgemma_2b,
              gemma3_12b, seamless_m4t_medium, deepseek_v2_236b)
}

# archs with sub-quadratic / bounded-window sequence mixing that run
# long_500k
LONG_CONTEXT_OK = frozenset({
    "xlstm-350m",
    "recurrentgemma-2b",
    "gemma3-12b",
    "gemma3-27b",
})

# reference architectures the port cannot run yet, and what each lacks
NOT_PORTED: dict[str, str] = {}


def get_arch(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet: the port lacks "
                       f"{NOT_PORTED[name]}; ported: {sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; ported: {sorted(ARCHS)}, "
                   f"not yet ported: {sorted(NOT_PORTED)}")


def supports_shape(arch: str, shape_name: str) -> bool:
    """Whether (arch, shape) is a supported dry-run combination."""
    if shape_name == "long_500k":
        return arch in LONG_CONTEXT_OK
    return True
