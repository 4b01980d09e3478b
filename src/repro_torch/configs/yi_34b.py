"""Yi-34B — llama-architecture dense GQA.  [arXiv:2403.04652]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    attention="gqa",
    act="swiglu",
    rope_theta=5_000_000.0,
    citation="arXiv:2403.04652",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="yi-34b-tiny", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
    )
