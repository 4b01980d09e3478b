"""Plain-torch oracles for the kernels (counterpart of ``repro/kernels/ref.py``).

These follow the reference's oracles line for line, including their treatment
of a fully masked row: scores are masked with -1e30 and ``softmax`` then
returns the *mean of V* for such a row.  The kernels (and the plain versions
that sit beside them) return 0 there instead; the serving path never produces
such a row.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B,H,Sq,D); k/v: (B,Hkv,Sk,D) -> (B,H,Sq,D)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = H // Hkv
    kk = k.repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kk.float()) * scale
    qp = torch.arange(Sq, device=q.device)[:, None]
    tp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= tp <= qp
    if window > 0:
        mask &= tp > qp - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, vv.float()).to(q.dtype)


def decode_attention_ref(q, k, v, *, kv_valid_len=None, scale=None):
    """q: (B,H,D); k/v: (B,Hkv,T,D) -> (B,H,D)."""
    B, H, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = H // Hkv
    kk = k.repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bhd,bhtd->bht", q.float(), kk.float()) * scale
    if kv_valid_len is not None:
        t = torch.arange(T, device=q.device)[None, None, :]
        s = torch.where(t < kv_valid_len[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bhtd->bhd", p, vv.float()).to(q.dtype)


def rmsnorm_ref(x, w, *, eps=1e-6, offset=False, residual=None):
    if residual is not None:
        x = x + residual
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if offset else w.float()
    return (y * scale).to(x.dtype)
