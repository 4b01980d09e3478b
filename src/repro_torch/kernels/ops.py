"""Public wrappers for the kernels (counterpart of ``repro/kernels/ops.py``).

The reference picks interpret mode by backend; here the choice is made by
the tensor's device inside each kernel wrapper: a CUDA tensor launches the
kernel or raises, a CPU tensor takes the plain version.  The ``_bshd`` /
``_bthd`` forms take the model's layouts and hand the kernels strided views,
so nothing is transposed in memory.

``flash_attention_bshd``, ``rmsnorm``, ``rmsnorm_residual`` and
``add_rmsnorm`` are differentiable: where autograd records (grad mode on and
an input that requires grad) they go through a ``torch.autograd.Function``
whose forward is the kernel (K1's variant that also writes the row
log-sum-exp; K3 writing the sum where there is a residual, which the
backward reads) and whose backward is the backward kernel of the same module.
The reference's Pallas kernels are forward only; it trains through its plain
attention and norm.  Without autograd the forward kernels run as they are.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import decode_attention as _decode_attention
from repro_torch.kernels.flash_attention import (
    flash_attention as _flash_attention, flash_attention_bwd as _flash_attention_bwd,
)
from repro_torch.kernels.rmsnorm import (
    add_rmsnorm as _add_rmsnorm, rmsnorm as _rmsnorm, rmsnorm_bwd as _rmsnorm_bwd,
)


def _records(*tensors) -> bool:
    """Whether autograd records a call on these tensors."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,H,Sq,D); k: (B,Hkv,Sk,D); v: (B,Hkv,Sk,Dv)."""
    return _flash_attention(q, k, v, causal=causal, window=window)


def _heads(t: torch.Tensor) -> torch.Tensor:
    """(B,S,heads,D) -> the (B,heads,S,D) view the kernels take."""
    return t.permute(0, 2, 1, 3)


class _FlashAttentionBSHD(torch.autograd.Function):
    """K1 forward (LSE variant) and K1 backward, in the model's layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        B, S, Hkv, G, D = q.shape
        out = torch.empty((B, S, Hkv * G, v.shape[-1]), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, Hkv * G, S), dtype=torch.float32, device=q.device)
        _flash_attention(_heads(q.reshape(B, S, Hkv * G, D)), _heads(k), _heads(v),
                         causal=causal, window=window, scale=scale, out=_heads(out), lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out.reshape(B, S, Hkv, G, -1)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        B, S, Hkv, G, D = q.shape
        dq = torch.empty((B, S, Hkv * G, D), dtype=q.dtype, device=q.device)
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        do = do.contiguous().reshape(B, S, Hkv * G, v.shape[-1])
        _flash_attention_bwd(_heads(q.reshape(B, S, Hkv * G, D)), _heads(k), _heads(v),
                             _heads(out), lse, _heads(do), causal=ctx.causal, window=ctx.window,
                             scale=ctx.scale, dq=_heads(dq), dk=_heads(dk), dv=_heads(dv))
        return dq.reshape(q.shape), dk, dv, None, None, None


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """Model layout: q (B,S,Hkv,G,D); k (B,T,Hkv,D); v (B,T,Hkv,Dv) ->
    (B,S,Hkv,G,Dv).  Differentiable through K1's backward kernels where
    autograd records (at MLA's (192, 128) too)."""
    if _records(q, k, v):
        return _FlashAttentionBSHD.apply(q, k, v, causal, window, scale)
    B, S, Hkv, G, D = q.shape
    Dv = v.shape[-1]
    out = torch.empty((B, S, Hkv * G, Dv), dtype=q.dtype, device=q.device)
    _flash_attention(_heads(q.reshape(B, S, Hkv * G, D)), _heads(k), _heads(v), causal=causal,
                     window=window, scale=scale, out=_heads(out))
    return out.reshape(B, S, Hkv, G, Dv)


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


class _RMSNorm(torch.autograd.Function):
    """K3 forward and K3 backward.  With a residual the forward writes the
    rounded sum (the backward's input); ``with_sum`` returns it as well, and
    its gradient joins dx.  x and the residual get the same gradient."""

    @staticmethod
    def forward(ctx, x, w, residual, eps, offset, with_sum):
        if residual is None:
            s, y = x, _rmsnorm(x, w, eps=eps, offset=offset)
        else:
            s, y = _add_rmsnorm(x, residual, w, eps=eps, offset=offset)
        ctx.save_for_backward(s, w)
        ctx.eps, ctx.offset, ctx.has_residual, ctx.with_sum = eps, offset, residual is not None, with_sum
        return (s, y) if with_sum else y

    @staticmethod
    def backward(ctx, *grads):
        s, w = ctx.saved_tensors
        ds, dy = grads if ctx.with_sum else (None, grads[0])
        dy = torch.zeros_like(s) if dy is None else dy.contiguous()
        dx, dw = _rmsnorm_bwd(s, w, dy, eps=ctx.eps, offset=ctx.offset,
                              ds=None if ds is None else ds.contiguous())
        return dx, dw, (dx if ctx.has_residual else None), None, None, None


def rmsnorm(x, w, *, eps: float = 1e-6, offset: bool = False):
    if _records(x, w):
        return _RMSNorm.apply(x, w, None, eps, offset, False)
    return _rmsnorm(x, w, eps=eps, offset=offset)


def rmsnorm_residual(x, residual, w, *, eps: float = 1e-6, offset: bool = False):
    """Norm of ``x + residual``; the sum itself is not returned."""
    if _records(x, residual, w):
        return _RMSNorm.apply(x, w, residual, eps, offset, False)
    return _rmsnorm(x, w, eps=eps, offset=offset, residual=residual)


def add_rmsnorm(x, residual, w, *, eps: float = 1e-6, offset: bool = False):
    """``(x + residual, norm(x + residual))`` in one launch: the model's
    residual add carried into the norm that reads its result."""
    if _records(x, residual, w):
        return _RMSNorm.apply(x, w, residual, eps, offset, True)
    return _add_rmsnorm(x, residual, w, eps=eps, offset=offset)
