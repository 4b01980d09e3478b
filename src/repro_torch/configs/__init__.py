"""Architecture registry: ``--arch <id>`` resolves through here.

``ARCH_IDS`` lists the reference's ten architectures: the four dense
decoders (block kind ``attn_ffn``), the MoE decoder with GQA attention
(olmoe, block kind ``moe_attn_ffn``), the MoE decoder with MLA attention
(deepseek, block kind ``mla_moe``), the RG-LRU hybrid (recurrentgemma, block
kinds ``griffin_rec`` and ``griffin_attn``), the xLSTM stack (xlstm, block
kinds ``mlstm`` and ``slstm``), the Whisper encoder-decoder (block kinds
``xattn`` in the decoder and ``enc`` in the encoder) and the VLM backbone
(qwen2-vl: the dense ``attn_ffn`` block with M-RoPE over (t, h, w)
positions and patch embeddings overlaid on the first rows).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    SHAPES, ModelConfig, RunConfig, ShapeConfig, supports_shape, torch_dtype,
)

_ARCH_MODULES = {
    "qwen2.5-32b": "qwen2_5_32b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "gemma-7b": "gemma_7b",
    "yi-34b": "yi_34b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "xlstm-125m": "xlstm_125m",
    "whisper-large-v3": "whisper_large_v3",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    """Full (exact public-literature) config for ``--arch``."""
    return _module(arch).CONFIG


def get_tiny_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU tests."""
    return _module(arch).tiny()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells(include_skipped: bool = False):
    """Yield every assigned (arch, shape) cell; skips sub-quadratic-only
    shapes for full-attention archs unless ``include_skipped``."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if include_skipped or supports_shape(cfg, shape):
                yield arch, shape.name


__all__ = [
    "ModelConfig", "RunConfig", "ShapeConfig", "SHAPES", "ARCH_IDS",
    "get_config", "get_tiny_config", "get_shape", "all_cells", "supports_shape", "torch_dtype",
]
