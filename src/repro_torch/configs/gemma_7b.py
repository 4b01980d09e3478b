"""Gemma-7B — dense, GeGLU, head_dim=256, scaled embeddings.  [arXiv:2403.08295]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    attention="gqa",
    act="geglu",
    rms_offset=True,
    scale_embedding=True,
    tie_embeddings=True,
    citation="arXiv:2403.08295",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="gemma-7b-tiny", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=128, vocab_size=512,
    )
