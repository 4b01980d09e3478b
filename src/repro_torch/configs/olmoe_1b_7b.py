"""OLMoE-1B-7B — 64-expert top-8 MoE.  [arXiv:2409.02060]"""
from repro_torch.configs.base import ModelConfig

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
    attention="gqa",
    act="swiglu",
    num_experts=64,
    top_k=8,
    num_shared_experts=0,
    moe_d_ff=1024,
    citation="arXiv:2409.02060",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="olmoe-tiny", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=32, vocab_size=512,
        num_experts=8, top_k=2, moe_d_ff=32,
    )
