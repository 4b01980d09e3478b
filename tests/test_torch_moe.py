"""The port's routed experts (``repro_torch.models.layers``: ``_moe_dispatch``,
``_expert_mlp``, ``_moe_combine``, ``moe_ffn``) against the reference's
single-device path (``repro.models.layers``), on the CPU.

Inputs come from numpy with a seed; parameters are built by the reference's
``build_params`` names and carried by ``repro_torch.convert``.  Tolerances:

* the dispatch's integer outputs (``order``, ``sorted_ids``, ``pos``,
  ``keep``) and its buffer are equal: the buffer holds copies of the inputs;
* float32 gates and aux loss 1e-6, outputs 1e-5 (absolute and relative):
  the router's and the experts' products are summed in another order;
* bfloat16 outputs 2e-2 of the largest output, as ``tests/test_kernels.py``
  holds bf16 kernels: the reference rounds the sum over k where XLA puts it,
  the port accumulates it in float32 and rounds once.

Routing is discontinuous, so every case first checks that both packages
chose the same experts; the seeds here leave no near-tie.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_tiny_config as j_tiny
from repro.models import layers as JL
from repro_torch.configs import get_tiny_config as t_tiny
from repro_torch.models import layers as TL

F32_GATE = 1e-6
F32_OUT = 1e-5
BF16_OUT = 2e-2


def configs(**kw):
    cj = j_tiny("olmoe-1b-7b").replace(dtype="float32", param_dtype="float32", **kw)
    ct = t_tiny("olmoe-1b-7b").replace(dtype="float32", param_dtype="float32", **kw)
    return cj, ct


def moe_params(cfg, seed=0):
    """The reference's ``moe`` subtree (router, experts, optional shared MLP)
    as float32 numpy, from a seed."""
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / math.sqrt(fan_in)).astype(np.float32)

    p = {"router": {"w": w(D, E, fan_in=D)},
         "experts": {"gate": w(E, D, F, fan_in=D), "up": w(E, D, F, fan_in=D),
                     "down": w(E, F, D, fan_in=F)}}
    if cfg.num_shared_experts:
        Fs = F * cfg.num_shared_experts
        p["shared"] = {"gate": {"w": w(D, Fs, fan_in=D)}, "up": {"w": w(D, Fs, fan_in=D)},
                       "down": {"w": w(Fs, D, fan_in=Fs)}}
    return p


def to_jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def to_torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)).to(dtype), tree)


def inputs(cfg, shape, seed=1):
    return np.random.default_rng(seed).standard_normal((*shape, cfg.d_model)).astype(np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def dispatch_pair(cj, ct, xf, router_w, cap):
    rj = JL._moe_dispatch(cj, jnp.asarray(xf), jnp.asarray(router_w), cap)
    rt = TL._moe_dispatch(ct, torch.tensor(xf), torch.tensor(router_w), cap)
    return rj, rt


def assert_dispatch_equal(rj, rt):
    (bj, mj, aj), (bt, mt, at) = rj, rt
    for a, b in zip(mj[:4], mt[:4]):           # order, sorted_ids, pos, keep
        assert np.array_equal(np.asarray(a), b.numpy())
    assert bt.shape == bj.shape
    assert np.array_equal(np.asarray(bj), bt.numpy())
    close(mt[4], mj[4], F32_GATE)               # gates
    close(at, aj, F32_GATE)                     # aux loss


# --------------------------------------------------------------------------
# dispatch, experts, combine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [2, 5, 40])
def test_dispatch_matches_the_reference(cap):
    """T 20 tokens, K 2 of E 8 experts: 40 choices, so cap 2 drops most, cap
    5 some, cap 40 none; each expert keeps its first ``cap`` choices."""
    cj, ct = configs()
    p = moe_params(cj)
    xf = inputs(cj, (20,))
    rj, rt = dispatch_pair(cj, ct, xf, p["router"]["w"], cap)
    assert_dispatch_equal(rj, rt)
    counts = np.bincount(rt[1][1].numpy(), minlength=cj.num_experts)
    assert int(rt[1][3].sum()) == int(np.minimum(counts, cap).sum())
    assert (counts.max() > cap) == (cap < 6)


@settings(max_examples=12, deadline=None)
@given(T=st.integers(1, 48), E=st.sampled_from([4, 8, 16]), K=st.integers(1, 4),
       cap=st.integers(1, 24), seed=st.integers(0, 2 ** 16))
def test_dispatch_matches_the_reference_over_shapes(T, E, K, cap, seed):
    K = min(K, E)
    cj, ct = configs(num_experts=E, top_k=K)
    p = moe_params(cj, seed)
    xf = inputs(cj, (T,), seed + 1)
    assert_dispatch_equal(*dispatch_pair(cj, ct, xf, p["router"]["w"], cap))


def test_expert_mlp_and_combine_match_the_reference():
    cj, ct = configs()
    p = moe_params(cj)
    T, K, cap = 24, cj.top_k, 5
    xf = inputs(cj, (T,))
    rj, rt = dispatch_pair(cj, ct, xf, p["router"]["w"], cap)
    eo_j = JL._expert_mlp(to_jax(p["experts"]), rj[0], jnp.float32)
    eo_t = TL._expert_mlp(to_torch(p["experts"]), rt[0], torch.float32)
    close(eo_t, eo_j, F32_OUT)
    # the combine of one and the same expert output
    out_j = JL._moe_combine(eo_j, rj[1], T, K, jnp.float32)
    out_t = TL._moe_combine(torch.tensor(np.asarray(eo_j)), rt[1], T, K, torch.float32)
    close(out_t, out_j, F32_OUT)
    assert not bool(rt[1][3].all())            # cap 5 of 48 choices over 8 experts drops some


# --------------------------------------------------------------------------
# moe_ffn
# --------------------------------------------------------------------------

def ffn_pair(cj, ct, p, x, dtype=(jnp.float32, torch.float32)):
    oj, aj = JL.moe_ffn(cj, to_jax(p, dtype[0]), jnp.asarray(x, dtype[0]))
    ot, at = TL.moe_ffn(ct, to_torch(p, dtype[1]), torch.tensor(x).to(dtype[1]))
    return (oj, aj), (ot, at)


def routes(cfg, p, x):
    """The port's dispatch of ``x``: the sorted expert ids, the keep flags
    in that order, and whether each token kept all its choices."""
    xf = torch.tensor(x).reshape(-1, cfg.d_model)
    _, (order, sorted_ids, pos, keep, _), _ = TL._moe_dispatch(
        cfg, xf, torch.tensor(p["router"]["w"]), TL.moe_capacity(cfg, xf.shape[0]))
    by_choice = torch.zeros_like(keep)
    by_choice[order] = keep
    return sorted_ids, keep, by_choice.reshape(-1, cfg.top_k).all(1)


@pytest.mark.parametrize("capacity_factor,drops", [(1.25, True), (8.0, False)])
def test_moe_ffn_matches_the_reference(capacity_factor, drops):
    """64 choices over 8 experts: capacity 10 at 1.25 (these inputs send 5
    choices past it), 64 at 8.0."""
    cj, ct = configs(capacity_factor=capacity_factor)
    p = moe_params(cj, seed=1)
    x = inputs(cj, (2, 16), seed=3)
    (oj, aj), (ot, at) = ffn_pair(cj, ct, p, x)
    assert ot.shape == (2, 16, cj.d_model)
    close(ot, oj, F32_OUT)
    close(at, aj, F32_GATE)
    _, keep, _ = routes(ct, p, x)
    assert (not bool(keep.all())) == drops


def test_moe_ffn_with_a_shared_expert_matches_the_reference():
    """``num_shared_experts > 0``: the reference adds a dense MLP of width
    ``moe_d_ff * num_shared_experts`` (``layers.py:350-351``)."""
    cj, ct = configs(num_shared_experts=1)
    p = moe_params(cj)
    assert p["shared"]["up"]["w"].shape == (cj.d_model, cj.moe_d_ff)
    x = inputs(cj, (2, 12))
    (oj, aj), (ot, at) = ffn_pair(cj, ct, p, x)
    close(ot, oj, F32_OUT)
    close(at, aj, F32_GATE)
    plain, _ = TL.moe_ffn(ct.replace(num_shared_experts=0), to_torch(p), torch.tensor(x))
    close(ot - plain, TL.ffn(ct, to_torch(p["shared"]), torch.tensor(x)).numpy(), F32_OUT)


def test_moe_ffn_in_bfloat16_on_identical_inputs():
    cj, ct = configs()
    cj, ct = (c.replace(dtype="bfloat16", param_dtype="bfloat16") for c in (cj, ct))
    p = moe_params(cj, seed=4)
    x = np.asarray(jnp.asarray(inputs(cj, (2, 16), seed=5), jnp.bfloat16).astype(jnp.float32))
    p = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), p)
    (oj, aj), (ot, at) = ffn_pair(cj, ct, p, x, (jnp.bfloat16, torch.bfloat16))
    assert ot.dtype == torch.bfloat16
    # the same routes: the router runs in float32 on the same bf16 inputs
    xf = jnp.asarray(x, jnp.bfloat16).reshape(-1, cj.d_model)
    cap = TL.moe_capacity(ct, xf.shape[0])
    _, mj, _ = JL._moe_dispatch(cj, xf, jnp.asarray(p["router"]["w"], jnp.bfloat16), cap)
    _, mt, _ = TL._moe_dispatch(ct, torch.tensor(x).reshape(-1, ct.d_model).bfloat16(),
                                torch.tensor(p["router"]["w"]).bfloat16(), cap)
    assert np.array_equal(np.asarray(mj[1]), mt[1].numpy())
    scale = float(np.abs(np.asarray(oj, np.float32)).max())
    np.testing.assert_allclose(ot.float().numpy(), np.asarray(oj, np.float32),
                               atol=BF16_OUT * scale, rtol=0)
    close(at, aj, F32_GATE)


def test_a_free_slot_takes_the_last_capacity_row_in_both_packages():
    """The serving engine decodes every slot, free ones included, as the
    reference's does.  In a decode batch of 8 slots the capacity is 4 rows an
    expert; when every token's first choice is expert 0, slots 0-3 take its
    rows and slots 4-7 lose that choice.  Slot 3 is free here (its token is
    whatever the engine left there), and it still takes expert 0's last row
    ahead of the live slots 4-7: same in both packages."""
    cj, ct = configs()
    p = moe_params(cj, seed=7)
    p["router"]["w"][0] = 0.0
    p["router"]["w"][0, 0] = 50.0               # feature 0 sends a token to expert 0
    x = inputs(cj, (8, 1), seed=8)
    x[..., 0] = 1.0
    x[3] = 0.0
    x[3, 0, 0] = 1.0                            # the free slot: a stale token
    cap = TL.moe_capacity(ct, 8)
    assert cap == 4
    sorted_ids, keep, whole = routes(ct, p, x)
    # the sort is stable, so expert 0's choices are in slot order: slot 3 is the 4th
    first = (sorted_ids == 0).nonzero()[:, 0]
    assert len(first) == 8 and keep[first[:4]].all() and not keep[first[4:]].any()
    assert not whole[4:].any()
    (oj, aj), (ot, at) = ffn_pair(cj, ct, p, x)
    close(ot, oj, F32_OUT)
    # the live slots 4-7 lose expert 0's share, which a roomy capacity keeps
    roomy, _ = TL.moe_ffn(ct.replace(capacity_factor=8.0), to_torch(p), torch.tensor(x))
    close(ot[whole], roomy[whole].numpy(), F32_OUT)
    assert float((ot[4:] - roomy[4:]).abs().amax(-1).min()) > 1e-3
