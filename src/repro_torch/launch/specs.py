"""``input_specs()`` — shape-and-dtype stand-ins for every model input
(counterpart of ``repro/launch/specs.py``).

The reference returns ``jax.ShapeDtypeStruct``s; here each stand-in is a
tensor on the ``meta`` device: it has the input's shape and torch dtype and
allocates nothing.  Modality frontends are stubs: whisper gets precomputed
frame embeddings, qwen2-vl gets precomputed patch embeddings.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, torch_dtype
from repro_torch.models.model import resolve_device

N_PATCH_STUB = 256  # vision stub: one image worth of patch embeddings


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_inputs(cfg: ModelConfig, B: int, S: int, *, kind: str) -> dict:
    """Abstract batch for train (tokens+labels) / prefill (tokens) / decode
    (single token): ``{name: meta tensor of the input's shape and dtype}``."""
    i32 = torch.int32
    dt = torch_dtype(cfg.dtype)
    if kind == "decode":
        specs = {"tokens": _spec((B, 1), i32)}
        if cfg.rope_style == "mrope":
            specs["positions"] = _spec((B, 1, 3), i32)
        return specs
    specs = {"tokens": _spec((B, S), i32)}
    if kind == "train":
        specs["labels"] = _spec((B, S), i32)
    if cfg.rope_style == "mrope":
        specs["positions"] = _spec((B, S, 3), i32)
    if cfg.encoder_layers > 0:
        specs["frame_embeds"] = _spec((B, cfg.encoder_seq, cfg.d_model), dt)
    if cfg.frontend == "vision_patches":
        specs["patch_embeds"] = _spec((B, N_PATCH_STUB, cfg.d_model), dt)
    return specs


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    return batch_inputs(cfg, shape.global_batch, shape.seq_len, kind=shape.kind)


def concrete_batch(cfg: ModelConfig, B: int, S: int, *, kind: str, seed: int = 0,
                   device=None) -> dict:
    """Small concrete batch for smoke tests / examples (mirrors
    ``input_specs``), on ``device`` (None: the card).  Positions are the
    reference's broadcast ``arange`` over the sequence, equal in the three
    M-RoPE sections; the rest is drawn, key by key in ``batch_inputs``'
    order, from one ``torch.Generator`` seeded with ``seed``: token ids
    uniform in the vocabulary, embeddings normal times 0.02 in the
    activation type."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, s in batch_inputs(cfg, B, S, kind=kind).items():
        if k == "positions":
            out[k] = torch.arange(s.shape[1], dtype=torch.int32, device=device)[None, :, None] \
                .expand(s.shape).contiguous()
        elif s.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, s.shape, generator=gen, dtype=torch.int32,
                                   device=device)
        else:
            out[k] = (torch.randn(s.shape, generator=gen, dtype=torch.float32, device=device)
                      * 0.02).to(s.dtype)
    return out
