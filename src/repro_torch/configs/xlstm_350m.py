"""xlstm-350m  [ssm]  — alternating sLSTM + mLSTM blocks.

24L d_model=1024 4H d_ff=0 vocab=50304 [arXiv:2405.04517]

d_ff=0: xLSTM blocks carry their own up/down projections (pre-up-projection
backbone for mLSTM, post-up-projection for sLSTM), so there is no separate
FFN sublayer.
"""

from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    # 1:1 alternation (the paper's xLSTM[a:b] notation; [1:1] mix)
    block_pattern=(MLSTM, SLSTM),
    xlstm=XLSTMConfig(num_heads=4),
    norm="layernorm",
    act="gelu",
    n_client_layers=2,
    source="arXiv:2405.04517",
)
