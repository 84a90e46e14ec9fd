"""gemma3-27b  [dense]  — 5 local (sliding-window 1024) : 1 global, 128k ctx.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144 [hf:google/gemma-3-1b-pt]
"""

from repro_torch.configs.base import ATTN, LOCAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    block_pattern=(LOCAL_ATTN, LOCAL_ATTN, LOCAL_ATTN,
                   LOCAL_ATTN, LOCAL_ATTN, ATTN),
    sliding_window=1024,
    rope_theta=1_000_000.0,       # global layers
    local_rope_theta=10_000.0,    # local layers
    qk_norm=True,
    final_logit_softcap=0.0,
    embed_scale=True,
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
    n_client_layers=2,
    source="hf:google/gemma-3-1b-pt",
)
