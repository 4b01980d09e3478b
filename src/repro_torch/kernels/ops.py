"""Public wrappers for the kernels (counterpart of ``repro/kernels/ops.py``).

The reference picks interpret mode by backend; here the choice is made by
the tensor's device inside each kernel wrapper: a CUDA tensor launches the
kernel or raises, a CPU tensor takes the plain version.  The ``_bshd`` /
``_bthd`` forms take the model's layouts and hand the kernels strided views,
so nothing is transposed in memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import decode_attention as _decode_attention
from repro_torch.kernels.flash_attention import flash_attention as _flash_attention
from repro_torch.kernels.rmsnorm import add_rmsnorm as _add_rmsnorm, rmsnorm as _rmsnorm


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,H,Sq,D); k/v: (B,Hkv,Sk,D)."""
    return _flash_attention(q, k, v, causal=causal, window=window)


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """Model layout: q (B,S,Hkv,G,D); k/v (B,T,Hkv,D) -> (B,S,Hkv,G,D)."""
    B, S, Hkv, G, D = q.shape
    qh = q.reshape(B, S, Hkv * G, D).permute(0, 2, 1, 3)
    out = torch.empty((B, S, Hkv * G, D), dtype=q.dtype, device=q.device)
    _flash_attention(qh, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), causal=causal,
                     window=window, scale=scale, out=out.permute(0, 2, 1, 3))
    return out.reshape(B, S, Hkv, G, D)


def decode_attention(q, k, v, kv_valid_len=None):
    """q: (B,H,D); k/v: (B,Hkv,T,D)."""
    return _decode_attention(q, k, v, kv_valid_len=kv_valid_len)


def decode_attention_bthd(q, k, v, kv_valid_len=None, *, scale=None):
    """Model layout: q (B,1,Hkv,G,D); k/v caches (B,T,Hkv,D) -> (B,1,Hkv,G,D).
    The caches are read where they lie (a permuted view, no copy)."""
    B, S, Hkv, G, D = q.shape
    if S != 1:
        raise ValueError(f"decode_attention_bthd: one query token a sequence, got {S}")
    # q is one small row a sequence; the kernel wants it dense
    o = _decode_attention(q.reshape(B, Hkv * G, D).contiguous(), k.permute(0, 2, 1, 3),
                          v.permute(0, 2, 1, 3), kv_valid_len=kv_valid_len, scale=scale)
    return o.reshape(B, 1, Hkv, G, D)


def rmsnorm(x, w, *, eps: float = 1e-6, offset: bool = False):
    return _rmsnorm(x, w, eps=eps, offset=offset)


def rmsnorm_residual(x, residual, w, *, eps: float = 1e-6, offset: bool = False):
    """Norm of ``x + residual``; the sum itself is not returned."""
    return _rmsnorm(x, w, eps=eps, offset=offset, residual=residual)


def add_rmsnorm(x, residual, w, *, eps: float = 1e-6, offset: bool = False):
    """``(x + residual, norm(x + residual))`` in one launch: the model's
    residual add carried into the norm that reads its result."""
    return _add_rmsnorm(x, residual, w, eps=eps, offset=offset)
