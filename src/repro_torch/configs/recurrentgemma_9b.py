"""RecurrentGemma-9B (Griffin) — RG-LRU + local attention, 1 attn : 2 recurrent.

[arXiv:2402.19427].  Block cycle (rec, rec, attn); MQA local attention with a
2048-token window; GeGLU MLP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,           # MQA on the local-attention blocks
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    attention="mqa",
    act="geglu",
    window=2048,
    rms_offset=True,
    scale_embedding=True,
    tie_embeddings=True,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096,
    conv_width=4,
    citation="arXiv:2402.19427",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="recurrentgemma-tiny", num_layers=6, d_model=64, num_heads=4,
        num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=512,
        window=32, lru_width=64, chunk_size=16,
    )
