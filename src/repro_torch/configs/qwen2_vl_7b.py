"""Qwen2-VL-7B — VLM; M-RoPE decoder backbone, vision frontend stubbed.

[arXiv:2409.12191].  The ``vlm`` entry specifies the transformer backbone
only; ``launch.specs.input_specs()`` provides precomputed patch embeddings
alongside token ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    attention="gqa",
    qkv_bias=True,
    act="swiglu",
    rope_style="mrope",       # 3-section (t, h, w) rotary
    rope_theta=1_000_000.0,
    frontend="vision_patches",
    citation="arXiv:2409.12191",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2-vl-tiny", num_layers=2, d_model=96, num_heads=4,
        num_kv_heads=2, head_dim=24, d_ff=128, vocab_size=512,
    )
