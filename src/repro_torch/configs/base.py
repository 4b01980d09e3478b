"""Model configuration (counterpart of ``repro/configs/base.py``).

``ModelConfig`` is carried over field for field, so a config of the reference
and one of the port compare equal attribute by attribute; so are the run and
shape configs the trainer reads (``ShapeConfig``, ``SHAPES``, ``RunConfig``,
``supports_shape``).  ``torch_dtype`` maps the config's dtype strings to
torch.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import torch


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (family-general superset).

    Only the fields relevant to a family are read by its blocks; the rest
    stay at defaults.
    """

    name: str
    family: str                      # dense | moe | hybrid | vlm | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- attention ---
    attention: str = "gqa"           # gqa | mla | mqa
    qkv_bias: bool = False
    rope_style: str = "standard"     # standard | mrope | partial | none
    rope_fraction: float = 1.0       # fraction of head_dim rotated (phi4 partial rope)
    rope_theta: float = 10_000.0
    window: int = 0                  # sliding-window size (0 = full attention)
    logit_soft_cap: float = 0.0
    attn_score_dtype: str = "float32"
    attn_kv_block: int = 512

    # --- ffn ---
    act: str = "swiglu"              # swiglu | geglu | gelu

    # --- norm / embedding ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-6
    rms_offset: bool = False         # gemma-style (1 + w) RMSNorm weight
    scale_embedding: bool = False    # gemma-style sqrt(d_model) embed scale
    tie_embeddings: bool = False

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- MLA (deepseek) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- hybrid / ssm block pattern ---
    block_pattern: tuple[str, ...] = ()
    lru_width: int = 0
    lru_gate_blocks: int = 1
    conv_width: int = 4
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    chunk_size: int = 256

    # --- encoder/decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500
    cross_attention: bool = False

    # --- multimodal stub frontend ---
    frontend: str = "none"                # none | audio_frames | vision_patches

    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    citation: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self, active_only: bool = False) -> int:
        """Total parameter count, embedding included."""
        from repro_torch.models.params import count_params
        return count_params(self, active_only=active_only)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode
    sub_quadratic_only: bool = False


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode", sub_quadratic_only=True),
}


@dataclass(frozen=True)
class RunConfig:
    """Parallelism / training-run knobs consumed by the launcher.

    ``pod``, ``data``, ``model_axis`` and ``zero_stage`` are the reference's
    mesh and ZeRO settings, carried as fields so that a run of either package
    reads the same config.  A train step on one device reads none of them;
    the train step's specs (``training.state_pspecs``) and the dry run
    (``launch/dryrun.py``) resolve the sharding they select.
    """

    model: ModelConfig
    shape: ShapeConfig
    # mesh logical sizes (products must equal device count)
    pod: int = 1
    data: int = 16
    model_axis: int = 16
    # distribution features
    zero_stage: int = 1              # 0 off, 1 opt-state, 2 +grads, 3 +params (FSDP)
    remat_policy: str = "block"      # none | block | dots
    optimizer: str = "adamw"         # adamw | adafactor
    microbatches: int = 1            # grad-accumulation microbatches
    grad_compression: str = "none"   # none | int8
    extra: dict[str, Any] = field(default_factory=dict)


def supports_shape(model: ModelConfig, shape: ShapeConfig) -> bool:
    """Shape applicability per the assignment.

    ``long_500k`` needs sub-quadratic attention: only hybrid (windowed attn +
    recurrent state) and ssm families qualify; pure full-attention archs skip
    it.
    """
    if shape.sub_quadratic_only:
        return model.family in ("hybrid", "ssm")
    return True


_TORCH_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    """``cfg.dtype`` / ``cfg.param_dtype`` string -> ``torch.dtype``."""
    if name not in _TORCH_DTYPES:
        raise KeyError(f"unknown dtype {name!r}; known: {sorted(_TORCH_DTYPES)}")
    return _TORCH_DTYPES[name]
