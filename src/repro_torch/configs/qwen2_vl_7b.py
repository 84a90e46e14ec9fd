"""qwen2-vl-7b  [vlm]  — M-RoPE, dynamic-resolution vision frontend (stubbed).

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 [arXiv:2409.12191]

The ViT + projector frontend is the allowed stub: ``input_specs`` supplies
precomputed patch embeddings of shape (batch, num_patch_tokens, d_model) plus
3D M-RoPE position ids; this module implements the language backbone.
"""

from repro_torch.configs.base import ATTN, ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    block_pattern=(ATTN,),
    rope_theta=1_000_000.0,
    attn_bias=True,          # qwen2 uses qkv bias
    vlm=VLMConfig(num_patch_tokens=1024, mrope_sections=(16, 24, 24)),
    norm="rmsnorm",
    act="silu",
    n_client_layers=2,
    source="arXiv:2409.12191",
)
