"""Abstract attention operator for simulator tracing.

When the simulator ingests a model it wants attention as ONE operator (the
paper traces at torch-op granularity where sdpa/flash-attention is a single
node), not as the score/softmax/value decomposition.  ``charon_attention``
is a ``torch.library`` custom op whose fake implementation gives the output's
shape and dtype; simulation never executes it (``make_fx`` over FakeTensors
is enough).  Its autograd formula routes backward tracing to a second op,
``charon_attention_bwd``, so attention is one node forward and one backward.

``attention_stub(...)`` is installed into ``repro_torch.models.layers`` by
the :func:`ingest_attention` context manager during tracing; the model's
``gqa_full`` and ``gqa_decode`` call attention through that module, so the
swap reaches them.
"""
from __future__ import annotations

import contextlib

import torch

_NOT_RUN = "is a tracing stub: it has shapes only and is never executed"


@torch.library.custom_op("charon::charon_attention", mutates_args=())
def charon_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                     window: int) -> torch.Tensor:
    # q: (B, Sq, Hkv, G, Dq); v: (B, T, Hkv, Dv) -> (B, Sq, Hkv, G, Dv)
    raise NotImplementedError(f"charon_attention {_NOT_RUN}")


@charon_attention.register_fake
def _attn_fake(q, k, v, causal, window):
    return q.new_empty((*q.shape[:-1], v.shape[-1]))


@torch.library.custom_op("charon::charon_attention_bwd", mutates_args=())
def charon_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ct: torch.Tensor,
                         causal: bool, window: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    raise NotImplementedError(f"charon_attention_bwd {_NOT_RUN}")


@charon_attention_bwd.register_fake
def _attn_bwd_fake(q, k, v, ct, causal, window):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _attn_setup(ctx, inputs, output):
    q, k, v, causal, window = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.window = causal, window


def _attn_bwd(ctx, ct):
    q, k, v = ctx.saved_tensors
    dq, dk, dv = charon_attention_bwd(q, k, v, ct, ctx.causal, ctx.window)
    return dq, dk, dv, None, None


charon_attention.register_autograd(_attn_bwd, setup_context=_attn_setup)


def attention_stub(q, k, v, *, q_offset=0, causal=True, window=0, kv_valid_len=None,
                   soft_cap=0.0, strategy="auto", scale=None, plain=False):
    """Signature-compatible replacement for layers.attention."""
    return charon_attention(q, k, v, bool(causal), int(window))


@contextlib.contextmanager
def ingest_attention():
    """Swap layers.attention for the abstract stub while tracing."""
    from repro_torch.models import layers as L
    orig = L.attention
    L.attention = attention_stub
    try:
        yield
    finally:
        L.attention = orig


def attention_flops(q_shape, v_shape, *, causal: bool, window: int) -> float:
    """2 matmuls over the (possibly windowed / causal) score matrix."""
    b, sq, hkv, g, dq = q_shape
    t, dv = v_shape[1], v_shape[-1]
    eff_t = min(t, window) if window else t
    frac = 0.5 if (causal and sq == t and not window) else 1.0
    return 2.0 * b * hkv * g * sq * eff_t * (dq + dv) * frac
