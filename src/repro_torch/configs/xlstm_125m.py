"""xLSTM-125M — sLSTM + mLSTM blocks.  [arXiv:2405.04517]

d_ff=0: the FFN lives inside the m/sLSTM blocks as their up-projection
(mLSTM pf=2, sLSTM pf=4/3).  Block cycle m,m,m,s over a 12-layer stack.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    attention="mlstm",
    act="gelu",
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    mlstm_proj_factor=2.0,
    slstm_proj_factor=4.0 / 3.0,
    chunk_size=256,
    citation="arXiv:2405.04517",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="xlstm-tiny", num_layers=4, d_model=64, num_heads=2,
        num_kv_heads=2, head_dim=32, vocab_size=512, chunk_size=16,
    )
