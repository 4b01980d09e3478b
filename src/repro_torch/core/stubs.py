"""Abstract attention operator and traced loop for simulator tracing.

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


@torch.library.custom_op("charon::scan_enter", mutates_args=())
def scan_enter(tensors: list[torch.Tensor], length: int, n_carry: int) -> list[torch.Tensor]:
    # the first n_carry tensors pass; the others, (length, ...), give one step's slice
    raise NotImplementedError(f"scan_enter {_NOT_RUN}")


@scan_enter.register_fake
def _scan_enter_fake(tensors, length, n_carry):
    return [t.new_empty(t.shape if i < n_carry else t.shape[1:]) for i, t in enumerate(tensors)]


@torch.library.custom_op("charon::scan_exit", mutates_args=())
def scan_exit(tensors: list[torch.Tensor], length: int, n_carry: int) -> list[torch.Tensor]:
    # the first n_carry tensors pass; the others, one step's outputs, are stacked
    raise NotImplementedError(f"scan_exit {_NOT_RUN}")


@scan_exit.register_fake
def _scan_exit_fake(tensors, length, n_carry):
    return [t.new_empty(t.shape if i < n_carry else (length, *t.shape))
            for i, t in enumerate(tensors)]


def _scan_setup(ctx, inputs, output):
    ctx.length, ctx.n_carry = inputs[1], inputs[2]
    ctx.outs = [(t.shape, t.dtype, t.device) for t in output]


def _grads(ctx, grads) -> list:
    """The outputs' gradients, zeros where an output had none (made before
    the mark, as JAX instantiates a loop's zero cotangents outside it)."""
    return [torch.zeros(s, dtype=d, device=dev) if g is None else g
            for g, (s, d, dev) in zip(grads, ctx.outs)]


def _scan_enter_bwd(ctx, grads):
    return scan_exit(_grads(ctx, grads), ctx.length, ctx.n_carry), None, None


def _scan_exit_bwd(ctx, grads):
    return scan_enter(_grads(ctx, grads), ctx.length, ctx.n_carry), None, None


scan_enter.register_autograd(_scan_enter_bwd, setup_context=_scan_setup)
scan_exit.register_autograd(_scan_exit_bwd, setup_context=_scan_setup)

SCAN_MARKS = ("scan_enter", "scan_exit")


def attention_stub(q, k, v, *, q_offset=0, causal=True, window=0, kv_valid_len=None,
                   soft_cap=0.0, strategy="auto", scale=None, q_block=2048, kv_block=512,
                   score_dtype=torch.float32, plain=False):
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


@contextlib.contextmanager
def ingest_scan():
    """While tracing, each ``layers.scan`` is one step traced between the
    loop's marks (``layers.marked_loops``)."""
    from repro_torch.models import layers as L
    with L.marked_loops():
        yield


def attention_flops(q_shape, v_shape, *, causal: bool, window: int) -> float:
    """2 matmuls over the (possibly windowed / causal) score matrix."""
    b, sq, hkv, g, dq = q_shape
    t, dv = v_shape[1], v_shape[-1]
    eff_t = min(t, window) if window else t
    frac = 0.5 if (causal and sq == t and not window) else 1.0
    return 2.0 * b * hkv * g * sq * eff_t * (dq + dv) * frac
