"""command-r-plus-104b  [dense]  — GQA, no bias.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01]
"""

from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    block_pattern=(ATTN,),
    rope_theta=75_000_000.0,
    attn_bias=False,
    norm="layernorm",
    act="silu",
    tie_embeddings=True,
    n_client_layers=2,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
