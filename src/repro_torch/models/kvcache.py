"""Decode-cache construction (counterpart of ``repro/models/kvcache.py``) for
the ring caches of the ``attn_ffn``, ``moe_attn_ffn`` and ``mla_moe`` blocks.

Layout: ``cache["blocks"]`` is a list with one dict a layer, as in the
reference (which stacks them over depth): ``{"k", "v"}``, each ``(B, T, Hkv,
D)``, for the GQA blocks; ``{"ckv": (B, T, kv_lora_rank), "kr": (B, T,
qk_rope_head_dim)}``, MLA's compressed latent and its rotary key, for
``mla_moe``.  Plus ``cache["pos"]``, the per-slot absolute position, ``(B,)
int32``.
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
    if kind == "mla_moe":
        return {"ckv": c((batch, cache_len, cfg.kv_lora_rank), dt),
                "kr": c((batch, cache_len, cfg.qk_rope_head_dim), dt)}
    raise ValueError(kind)


def cache_len_of(cache: dict) -> int:
    """The ring's length T of a cache built here (every leaf is ``(B, T, ...)``)."""
    return next(iter(cache["blocks"][0].values())).shape[1]


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
