"""Decode-cache construction (counterpart of ``repro/models/kvcache.py``) for
the ring caches of the ``attn_ffn``, ``moe_attn_ffn``, ``mla_moe`` and
``griffin_attn`` blocks and the recurrent state of ``griffin_rec``, ``mlstm``
and ``slstm``.

Layout: ``cache["blocks"]`` is a list with one dict a layer, as in the
reference (which stacks them over depth): ``{"k", "v"}``, each ``(B, T, Hkv,
D)``, for the GQA blocks (``griffin_attn``'s ring has ``min(cache_len,
window)`` rows); ``{"ckv": (B, T, kv_lora_rank), "kr": (B, T,
qk_rope_head_dim)}``, MLA's compressed latent and its rotary key, for
``mla_moe``; ``{"h": (B, W), "conv": (B, conv_width - 1, W)}``, the RG-LRU's
state and the causal conv's last inputs, for ``griffin_rec``; ``{"conv": (B,
conv_width - 1, Di), "C": (B, H, D, D), "n": (B, H, D), "m": (B, H)}``, the
conv's last inputs and the matrix memory in float32, for ``mlstm``; ``{"c",
"n", "h", "m"}``, each (B, W) in float32, for ``slstm``; ``{"k", "v", "ck",
"cv"}`` for Whisper's ``xattn``: the self attention's ring of ``cache_len``
rows and the cross attention's keys and values of the ``encoder_seq``
encoder rows, each ``(B, rows, Hkv, D)``, in that order.  Plus
``cache["pos"]``, the per-slot absolute position, ``(B,) int32``.

The creator is ``creator(shape, logical, dtype)``: ``logical`` names each
dim's logical axis, as the reference's does.  KV sharding policy
(divisibility-aware, the reference's): the kv heads are sharded where they
divide the active mesh's model axis (Megatron TP decode), else the KV
sequence (flash-decode style).  With no active mesh the heads divide.
"""
from __future__ import annotations

import functools
import math
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.distributed.sharding import axis_size
from repro_torch.models.params import layer_kinds

CacheCreator = Callable[..., object]  # creator(shape, logical, dtype) -> leaf
SLSTM_STATE = ("c", "n", "h", "m")    # the sLSTM cell's state, in its scan's carry order


def ring_rows(cache_len: int, window: int) -> int:
    """Rows of an attention ring: ``cache_len``, or the window where it is
    shorter (a windowed layer keeps no more)."""
    return min(cache_len, window) if window else cache_len


def _kind_cache(cfg: ModelConfig, kind: str, c: CacheCreator, batch: int, cache_len: int):
    dt = torch_dtype(cfg.dtype)
    Hkv, Dh = cfg.num_kv_heads, cfg.head_dim
    heads_ok = Hkv % axis_size("model") == 0
    kv_ax = ("batch", None, "kv_heads", "head_dim") if heads_ok else \
        ("batch", "kv_seq", None, "head_dim")

    def kv(T):
        return {"k": c((batch, T, Hkv, Dh), kv_ax, dt), "v": c((batch, T, Hkv, Dh), kv_ax, dt)}

    if kind in ("attn_ffn", "moe_attn_ffn"):
        return kv(cache_len)
    if kind == "griffin_attn":
        return kv(ring_rows(cache_len, cfg.window))
    if kind == "xattn":
        # the self ring first: the ring's T is read from "k", never from "ck"
        d = kv(cache_len)
        cross = (batch, cfg.encoder_seq, Hkv, Dh)
        d["ck"], d["cv"] = c(cross, kv_ax, dt), c(cross, kv_ax, dt)
        return d
    if kind == "mla_moe":
        return {"ckv": c((batch, cache_len, cfg.kv_lora_rank), ("batch", "kv_seq", None), dt),
                "kr": c((batch, cache_len, cfg.qk_rope_head_dim), ("batch", "kv_seq", None), dt)}
    if kind == "griffin_rec":
        W = cfg.lru_width or cfg.d_model
        return {"h": c((batch, W), ("batch", "lru_width"), dt),
                "conv": c((batch, cfg.conv_width - 1, W), ("batch", None, "lru_width"), dt)}
    f32 = torch.float32
    if kind == "mlstm":
        H, D = cfg.num_heads, cfg.head_dim
        Di = int(cfg.mlstm_proj_factor * cfg.d_model)
        return {"conv": c((batch, cfg.conv_width - 1, Di), ("batch", None, "ffn"), dt),
                "C": c((batch, H, D, D), ("batch", None, None, None), f32),
                "n": c((batch, H, D), ("batch", None, None), f32),
                "m": c((batch, H), ("batch", None), f32)}
    if kind == "slstm":
        return {k: c((batch, cfg.d_model), ("batch", None), f32) for k in SLSTM_STATE}
    raise ValueError(kind)


RING_LEAVES = ("k", "ckv")     # the first leaf of an attention ring, (B, T, ...)


def cache_len_of(cache: dict) -> int | None:
    """The rows T of the attention rings of a cache built here (the first
    layer that has one: a recurrent layer's state has no T), or None for a
    stack with no ring (the xLSTM family's), whose decode writes no slot.
    An ``xattn`` layer's ring is its ``k``; its ``ck`` holds the encoder's
    rows, which no decode step writes."""
    for layer in cache["blocks"]:
        for name in RING_LEAVES:
            if name in layer:
                return layer[name].shape[1]
    return None


def build_cache(cfg: ModelConfig, creator: CacheCreator, batch: int, cache_len: int):
    return {
        "blocks": [_kind_cache(cfg, k, creator, batch, cache_len) for k in layer_kinds(cfg)],
        "pos": creator((batch,), ("batch",), torch.int32),
    }


def abstract_cache(cfg: ModelConfig, batch: int, cache_len: int):
    """The cache as tensors on the ``meta`` device: each leaf's shape and
    dtype, no storage (the reference's ``jax.ShapeDtypeStruct``s)."""
    return build_cache(cfg, lambda s, logical, d: torch.empty(s, dtype=d, device="meta"),
                       batch, cache_len)


def cache_logical_axes(cfg: ModelConfig, batch: int, cache_len: int):
    """Each leaf's logical axes, a tuple a dim."""
    return build_cache(cfg, lambda s, logical, d: tuple(logical), batch, cache_len)


def zero_cache(cfg: ModelConfig, batch: int, cache_len: int, device):
    device = torch.device(device)
    cache = build_cache(cfg, lambda s, logical, d: torch.zeros(s, dtype=d, device=device),
                        batch, cache_len)
    # cache "full" semantics, as in the reference; the serving engine
    # overwrites it with zeros right after
    cache["pos"] = torch.full((batch,), cache_len, dtype=torch.int32, device=device)
    return cache


@functools.lru_cache(maxsize=1024)
def cache_bytes(cfg: ModelConfig, batch: int, cache_len: int) -> int:
    """Total cache bytes; pure in (cfg, batch, cache_len)."""
    total = [0]

    def c(s, logical, d):
        total[0] += math.prod(s) * d.itemsize
        return None

    build_cache(cfg, c, batch, cache_len)
    return total[0]
