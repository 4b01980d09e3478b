"""Qwen2.5-32B — dense GQA transformer with QKV bias.  [hf:Qwen/Qwen2.5-*]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    attention="gqa",
    qkv_bias=True,
    act="swiglu",
    rope_theta=1_000_000.0,
    citation="hf:Qwen/Qwen2.5-0.5B",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2.5-32b-tiny", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
    )
