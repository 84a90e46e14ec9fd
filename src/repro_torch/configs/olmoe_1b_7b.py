"""olmoe-1b-7b  [moe]  — 64 experts, top-8.

16L d_model=2048 16H (kv=16) d_ff=1024/expert vocab=50304, MoE 64e top-8
[arXiv:2409.02060]
"""

from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    block_pattern=(ATTN,),
    rope_theta=10_000.0,
    qk_norm=True,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024,
                  router_aux_loss=0.01),
    norm="rmsnorm",
    act="silu",
    n_client_layers=2,
    source="arXiv:2409.02060",
)
