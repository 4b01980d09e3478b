"""``layers.attend_blockwise`` (online softmax over kv blocks in
``layers.scan``) against the reference's, on the same inputs drawn from a
numpy seed.  Tolerances: 2e-6 absolute for float32 scores, 2e-2 for bfloat16
scores (the PV product in bf16; the statistics stay float32 in both).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

B, HKV, G, D = 2, 2, 3, 16

CASES = [
    # (Sq, T, causal, window, q_offset, valid, q_block, kv_block)
    (40, 40, True, 0, 0, None, 16, 12),       # blocks that do not divide
    (40, 40, False, 0, 0, None, 7, 9),
    (33, 33, True, 10, 0, None, 8, 8),        # windowed
    (8, 40, True, 0, 32, None, 4, 16),        # Sq != T, q_offset
    (1, 50, False, 0, 0, "vec", 1, 16),       # decode with per-row valid length
    (5, 29, False, 0, 0, 17, 3, 8),           # scalar valid length
    (24, 24, True, 6, 0, "vec", 24, 24),      # one block each
    (16, 64, True, 0, 48, None, 16, 64),
]


def _inputs(Sq, T, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, HKV, G, D)).astype(np.float32)
    k = rng.standard_normal((B, T, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, T, HKV, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("score", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_blockwise_matches_the_reference(case, score):
    Sq, T, causal, window, q_offset, valid, qb, kb = case
    q, k, v = _inputs(Sq, T, seed=CASES.index(case))
    if valid == "vec":
        valid = np.array([T - 3, T // 2], dtype=np.int32)
    kw = dict(q_offset=q_offset, causal=causal, window=window, q_block=qb, kv_block=kb)
    want = JL.attend_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               kv_valid_len=None if valid is None else jnp.asarray(valid),
                               score_dtype=jnp.dtype(score), **kw)
    got = TL.attend_blockwise(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                              kv_valid_len=None if valid is None else torch.tensor(valid),
                              score_dtype=getattr(torch, score), **kw)
    tol = 2e-6 if score == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)


@pytest.mark.parametrize("case", CASES[:4], ids=[str(i) for i in range(4)])
def test_blockwise_matches_dense(case):
    """The online softmax is the dense softmax (float32 scores)."""
    Sq, T, causal, window, q_offset, _, qb, kb = case
    q, k, v = (torch.tensor(a) for a in _inputs(Sq, T, seed=7))
    kw = dict(q_offset=q_offset, causal=causal, window=window)
    got = TL.attend_blockwise(q, k, v, q_block=qb, kv_block=kb, **kw)
    want = TL.attend_dense(q, k, v, **kw)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


def test_bf16_inputs_match_the_reference():
    q, k, v = _inputs(20, 20, seed=3)
    kw = dict(q_offset=0, causal=True, q_block=8, kv_block=8)
    want = JL.attend_blockwise(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), **kw)
    got = TL.attend_blockwise(*(torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=0)


@pytest.mark.parametrize("Sq,T,strategy", [(16, 16, "dense"), (1, 1024, "dense"),
                                           (1, 1025, "blockwise"), (4096, 1024, "dense"),
                                           (4097, 1024, "blockwise"), (2048, 2048, "blockwise")])
def test_auto_rule_off_the_card_is_the_references(Sq, T, strategy, monkeypatch):
    """Off the card ``attention(strategy="auto")`` takes blockwise when
    Sq*T > 2048^2 or T > 1024, else dense, with the q and kv blocks given."""
    q = torch.zeros((1, Sq, 1, 1, 4))
    k = v = torch.zeros((1, T, 1, 4))
    assert TL._auto_strategy(q, k) == strategy
    seen = {}
    monkeypatch.setattr(TL, "attend_blockwise",
                        lambda *a, **kw: seen.update(kind="blockwise", **kw))
    monkeypatch.setattr(TL, "attend_dense", lambda *a, **kw: seen.update(kind="dense", **kw))
    TL.attention(q, k, v, q_block=64, kv_block=32, score_dtype=torch.bfloat16)
    assert seen["kind"] == strategy
    if strategy == "blockwise":
        assert (seen["q_block"], seen["kv_block"], seen["score_dtype"]) == \
            (64, 32, torch.bfloat16)


def test_blockwise_loop_goes_through_layers_scan(monkeypatch):
    """The kv loop is ``layers.scan`` (so the ingest and the dry run see one
    loop with its length), one call a q block, over the kv blocks the
    static causal truncation keeps."""
    lengths = []
    orig = TL.scan

    def counting(step, carry, xs, length=None):
        lengths.append(xs[0].shape[0])
        return orig(step, carry, xs, length)
    monkeypatch.setattr(TL, "scan", counting)
    q, k, v = (torch.tensor(a) for a in _inputs(40, 40, seed=1))
    TL.attend_blockwise(q, k, v, q_offset=0, causal=True, q_block=16, kv_block=8)
    assert lengths == [2, 4, 5]          # q rows 0-15, 16-31, 32-39 over 8-row kv blocks
