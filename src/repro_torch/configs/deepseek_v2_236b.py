"""deepseek-v2-236b  [moe]  — MLA (kv_lora=512), 2 shared + 160 routed, top-6.

60L d_model=5120 128H d_ff=1536/expert vocab=102400 [arXiv:2405.04434]
"""

from repro_torch.configs.base import MLA_ATTN, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,               # MLA: all heads share the latent KV
    head_dim=128,                   # = qk_nope_head_dim
    d_ff=1536,
    vocab_size=102400,
    block_pattern=(MLA_ATTN,),
    rope_theta=10_000.0,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536,
                  num_shared_experts=2, d_ff_shared=1536,
                  router_aux_loss=0.003,
                  first_dense_layers=1, d_ff_dense=12288),
    norm="rmsnorm",
    act="silu",
    n_client_layers=2,
    source="arXiv:2405.04434",
)
