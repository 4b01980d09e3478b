"""Phi-4-mini (3.8B) — dense, RoPE (partial) + SwiGLU + GQA.  [arXiv:2412.08905]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    attention="gqa",
    act="swiglu",
    rope_style="partial",
    rope_fraction=0.75,
    rope_theta=10_000.0,
    tie_embeddings=True,
    citation="arXiv:2412.08905",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="phi4-mini-tiny", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
    )
