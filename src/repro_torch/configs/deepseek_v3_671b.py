"""DeepSeek-V3 671B — MLA attention + 256-expert top-8 MoE (1 shared).

[arXiv:2412.19437].  d_ff=2048 (per-expert hidden), MoE 256e top-8, MLA, 128
heads.  MTP is an optional extra head, not part of the simulated or served
step.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,        # MLA: KV latent is shared; head count used for expanded form
    head_dim=128,
    d_ff=2048,               # per-expert hidden
    vocab_size=129280,
    attention="mla",
    act="swiglu",
    num_experts=256,
    top_k=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    # MLA dims (paper/HF config)
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    citation="arXiv:2412.19437",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-v3-tiny", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=32, vocab_size=512,
        num_experts=8, top_k=2, num_shared_experts=1, moe_d_ff=32,
        q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16,
    )
