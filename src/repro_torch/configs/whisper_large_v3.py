"""Whisper-large-v3 — encoder-decoder audio transformer; conv frontend stubbed.

[arXiv:2212.04356].  32 encoder and 32 decoder layers (the published
large-v3 stack); the conv frontend is a stub: the batch carries precomputed
frame embeddings ``frame_embeds`` (B, 1500, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,            # decoder layers
    encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    attention="gqa",
    qkv_bias=True,
    act="gelu",
    norm="layernorm",
    rope_style="none",        # sinusoidal positions added to the embeddings
    cross_attention=True,
    frontend="audio_frames",
    encoder_seq=1500,
    tie_embeddings=True,
    citation="arXiv:2212.04356",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-tiny", num_layers=2, encoder_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        encoder_seq=32,
    )
