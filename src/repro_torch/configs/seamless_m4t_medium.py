"""seamless-m4t-medium  [audio]  — encoder-decoder, multimodal frontend stubbed.

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206 [arXiv:2308.11596]

The mel-spectrogram + conv feature extractor is the allowed stub: the
batch carries precomputed frame embeddings ``source_embeds`` of shape
(batch, source_len, d_model), which the encoder consumes
(``repro_torch.models.encdec``).
"""

from repro_torch.configs.base import ATTN, EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,                  # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,              # padded to 256256 internally for TP
    block_pattern=(ATTN,),
    rope_theta=10_000.0,
    encdec=EncDecConfig(num_encoder_layers=12, max_source_len=1024),
    norm="layernorm",
    act="gelu",
    attn_bias=True,
    n_client_layers=2,
    source="arXiv:2308.11596",
)
