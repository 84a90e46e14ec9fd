"""recurrentgemma-2b  [hybrid]  — RG-LRU + local attention, 1 attn : 2 recurrent.

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000 [arXiv:2402.19427]
"""

from repro_torch.configs.base import (LOCAL_ATTN, RGLRU, ModelConfig,
                                      RGLRUConfig)

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    # Griffin pattern: (recurrent, recurrent, local attention)
    block_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    sliding_window=2048,
    rope_theta=10_000.0,
    rglru=RGLRUConfig(lru_width=2560, conv_kernel=4),
    embed_scale=True,
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
    n_client_layers=2,
    source="arXiv:2402.19427",
)
