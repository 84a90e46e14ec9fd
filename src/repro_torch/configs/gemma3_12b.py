"""gemma3-12b  [dense]  — 5 local (sliding-window 1024) : 1 global, 128k ctx.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144 [hf:google/gemma-3-1b-pt]
"""

from repro_torch.configs.base import ATTN, LOCAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    block_pattern=(LOCAL_ATTN, LOCAL_ATTN, LOCAL_ATTN,
                   LOCAL_ATTN, LOCAL_ATTN, ATTN),
    sliding_window=1024,
    rope_theta=1_000_000.0,
    local_rope_theta=10_000.0,
    qk_norm=True,
    embed_scale=True,
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
    n_client_layers=2,
    source="hf:google/gemma-3-1b-pt",
)
