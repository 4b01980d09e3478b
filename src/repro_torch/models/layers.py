"""Core neural layers, dense subset (counterpart of ``repro/models/layers.py``).

Everything is functional: ``apply(params, x, ...) -> y``.  The reference's
logical sharding constraints are dropped: this slice runs on one device.

RMSNorm and attention go through the kernel wrappers of
``repro_torch.kernels``: on a CUDA tensor those launch the Hopper kernels, on
a CPU tensor they compute the same function in plain torch.  ``plain=True``
(used only to hold the kernels against their plain versions on the card)
calls the plain versions whatever the device.

Attention strategies:
  * ``dense``  — plain einsum softmax attention (the CPU path, tests)
  * ``kernel`` — flash-attention kernel for a full sequence, split-KV decode
                 kernel for one token against a ring cache
  * ``auto``   — ``kernel`` for CUDA tensors, ``dense`` for CPU tensors
The reference's ``blockwise`` strategy is not ported: the flash kernel takes
its place on the card and ``dense`` on the CPU.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rmsnorm import add_rmsnorm_plain, rmsnorm_plain

# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


def rmsnorm(w: torch.Tensor, x: torch.Tensor, *, eps: float = 1e-6, offset: bool = False,
            residual: torch.Tensor | None = None, plain: bool = False) -> torch.Tensor:
    if plain:
        return rmsnorm_plain(x, w, eps=eps, offset=offset, residual=residual)
    if residual is None:
        return ops.rmsnorm(x, w, eps=eps, offset=offset)
    return ops.rmsnorm_residual(x, residual, w, eps=eps, offset=offset)


def layernorm(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def apply_norm(cfg, p: dict, x: torch.Tensor, *, residual: torch.Tensor | None = None,
               plain: bool = False) -> torch.Tensor:
    """Norm of ``x``, or of ``x + residual`` (the sum is not returned)."""
    if cfg.norm == "layernorm":
        if residual is not None:
            x = x + residual
        return layernorm(p["w"], p["b"], x, eps=cfg.norm_eps)
    return rmsnorm(p["w"], x, eps=cfg.norm_eps, offset=cfg.rms_offset, residual=residual,
                   plain=plain)


def add_norm(cfg, p: dict, h: torch.Tensor, pending: torch.Tensor | None, *,
             plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, norm(s))`` with ``s = h + pending``: a residual add left pending
    by the block before, carried into the norm that reads its sum (one kernel
    launch for both on the card).  ``pending`` None: ``(h, norm(h))``."""
    if pending is None:
        return h, apply_norm(cfg, p, h, plain=plain)
    if cfg.norm == "layernorm":
        s = h + pending
        return s, layernorm(p["w"], p["b"], s, eps=cfg.norm_eps)
    add = add_rmsnorm_plain if plain else ops.add_rmsnorm
    return add(h, pending, p["w"], eps=cfg.norm_eps, offset=cfg.rms_offset)


# --------------------------------------------------------------------------
# Rotary position embeddings (standard / partial; M-RoPE is not ported yet)
# --------------------------------------------------------------------------

def _rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., D_rot) with cos/sin (..., D_rot/2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rot_dim(cfg, d: int) -> int:
    rot = d if cfg.rope_style != "partial" else int(d * cfg.rope_fraction)
    return rot - rot % 2


def rope_tables(cfg, positions: torch.Tensor, head_dim: int):
    """(cos, sin), each (B, S, 1, rot/2) float32, for ``apply_rope``.  They
    depend on the positions only, so a model call computes them once and
    hands them to every layer (eager torch has no compiler to share them)."""
    if cfg.rope_style == "none":
        return None
    if cfg.rope_style not in ("standard", "partial"):
        raise NotImplementedError(f"rope_style {cfg.rope_style!r} is not ported yet")
    inv = _rope_freqs(_rot_dim(cfg, head_dim), cfg.rope_theta, positions.device)   # (half,)
    angles = positions.float()[..., None, None] * inv                              # (B, S, 1, half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(cfg, x: torch.Tensor, positions: torch.Tensor, *, tables=None) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integer.  ``tables``: what
    :func:`rope_tables` gave for these positions and this D, if the caller
    has it already."""
    if cfg.rope_style == "none":
        return x
    d = x.shape[-1]
    rot = _rot_dim(cfg, d)
    cos, sin = tables if tables is not None else rope_tables(cfg, positions, d)
    out = _rotate(x[..., :rot], cos, sin).to(x.dtype)
    return torch.cat([out, x[..., rot:]], dim=-1) if rot < d else out


# --------------------------------------------------------------------------
# Softmax attention over GQA layouts
# --------------------------------------------------------------------------

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _soft_cap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(s / cap) * cap if cap > 0 else s


def attend_dense(q, k, v, *, q_offset, causal: bool, window: int = 0,
                 kv_valid_len=None, soft_cap: float = 0.0, scale: float | None = None):
    """q: (B, Sq, Hkv, G, Dq), k: (B, T, Hkv, Dq), v: (B, T, Hkv, Dv).

    ``q_offset``: absolute position of q[0].
    ``kv_valid_len``: scalar or (B,) — entries >= this in T are masked (ring caches).
    """
    B, Sq, Hkv, G, Dq = q.shape
    T = k.shape[1]
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(Dq)
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    s = _soft_cap(s, soft_cap)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    t_pos = torch.arange(T, device=dev)
    mask = torch.ones((Sq, T), dtype=torch.bool, device=dev)
    if causal:
        mask &= t_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= t_pos[None, :] > q_pos[:, None] - window
    mask = mask.expand(B, 1, 1, Sq, T)
    if kv_valid_len is not None:
        vl = torch.as_tensor(kv_valid_len, device=dev)
        vl = vl.reshape(-1, 1, 1, 1, 1) if vl.ndim else vl
        mask = mask & (t_pos[None, None, None, None, :] < vl)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.to(q.dtype)


def _attend_kernel(q, k, v, *, q_offset, causal, window, kv_valid_len, soft_cap, scale, plain):
    """Route one attention call to the kernel that computes it."""
    B, Sq, Hkv, G, D = q.shape
    if soft_cap != 0.0 or q_offset != 0:
        raise ValueError("attention(strategy='kernel'): soft_cap and q_offset are not "
                         "taken by the kernels")
    if kv_valid_len is None:
        if plain:
            qh = q.reshape(B, Sq, Hkv * G, D).permute(0, 2, 1, 3)
            o = flash_attention_plain(qh, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                                      causal=causal, window=window, scale=scale)
            return o.permute(0, 2, 1, 3).reshape(B, Sq, Hkv, G, D)
        return ops.flash_attention_bshd(q, k, v, causal=causal, window=window, scale=scale)
    if Sq == 1 and not causal and window == 0:
        vl = kv_valid_len
        if not (torch.is_tensor(vl) and vl.dtype == torch.int32 and vl.shape == (B,)):
            vl = torch.as_tensor(vl, device=q.device).to(torch.int32).expand(B).contiguous()
        if plain:
            o = decode_attention_plain(q.reshape(B, Hkv * G, D), k.permute(0, 2, 1, 3),
                                       v.permute(0, 2, 1, 3), kv_valid_len=vl, scale=scale)
            return o.reshape(B, 1, Hkv, G, D)
        return ops.decode_attention_bthd(q, k, v, vl, scale=scale)
    raise ValueError("attention(strategy='kernel'): kv_valid_len is taken only for one "
                     "unmasked query token a sequence (decode)")


def attention(q, k, v, *, q_offset=0, causal=True, window=0, kv_valid_len=None,
              soft_cap=0.0, strategy="auto", scale=None, plain=False):
    """Dispatch over attention strategies.  Shapes as in :func:`attend_dense`."""
    if strategy == "auto":
        strategy = "kernel" if q.device.type == "cuda" else "dense"
    if strategy == "kernel":
        return _attend_kernel(q, k, v, q_offset=q_offset, causal=causal, window=window,
                              kv_valid_len=kv_valid_len, soft_cap=soft_cap, scale=scale,
                              plain=plain)
    if strategy != "dense":
        raise ValueError(f"unknown attention strategy {strategy!r}")
    return attend_dense(q, k, v, q_offset=q_offset, causal=causal, window=window,
                        kv_valid_len=kv_valid_len, soft_cap=soft_cap, scale=scale)


# --------------------------------------------------------------------------
# Dense projections / FFN
# --------------------------------------------------------------------------

def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def ffn(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU / GeGLU / plain-GELU feed-forward."""
    if cfg.act in ("swiglu", "geglu"):
        g = linear(p["gate"], x)
        u = linear(p["up"], x)
        g = F.silu(g) if cfg.act == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * u
    else:
        h = F.gelu(linear(p["up"], x), approximate="tanh")
    return linear(p["down"], h)
