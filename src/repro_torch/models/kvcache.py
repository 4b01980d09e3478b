"""Decode-cache construction (counterpart of ``repro/models/kvcache.py``) for
the ring caches of the ``attn_ffn`` and ``moe_attn_ffn`` blocks.

Layout: ``cache["blocks"]`` is a list with one ``{"k", "v"}`` a layer, each
``(B, T, Hkv, D)`` as in the reference (which stacks them over depth), plus
``cache["pos"]``, the per-slot absolute position, ``(B,) int32``.
"""
from __future__ import annotations

import functools
import math
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.models.params import layer_kinds

CacheCreator = Callable[..., object]  # creator(shape, dtype) -> leaf


def _kind_cache(cfg: ModelConfig, kind: str, c: CacheCreator, batch: int, cache_len: int):
    dt = torch_dtype(cfg.dtype)
    if kind in ("attn_ffn", "moe_attn_ffn"):
        shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": c(shape, dt), "v": c(shape, dt)}
    raise ValueError(kind)


def build_cache(cfg: ModelConfig, creator: CacheCreator, batch: int, cache_len: int):
    return {
        "blocks": [_kind_cache(cfg, k, creator, batch, cache_len) for k in layer_kinds(cfg)],
        "pos": creator((batch,), torch.int32),
    }


def zero_cache(cfg: ModelConfig, batch: int, cache_len: int, device):
    device = torch.device(device)
    cache = build_cache(cfg, lambda s, d: torch.zeros(s, dtype=d, device=device),
                        batch, cache_len)
    # cache "full" semantics, as in the reference; the serving engine
    # overwrites it with zeros right after
    cache["pos"] = torch.full((batch,), cache_len, dtype=torch.int32, device=device)
    return cache


@functools.lru_cache(maxsize=1024)
def cache_bytes(cfg: ModelConfig, batch: int, cache_len: int) -> int:
    """Total cache bytes; pure in (cfg, batch, cache_len)."""
    total = [0]

    def c(s, d):
        total[0] += math.prod(s) * d.itemsize
        return None

    build_cache(cfg, c, batch, cache_len)
    return total[0]
