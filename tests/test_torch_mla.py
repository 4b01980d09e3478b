"""The MLA family (``deepseek-v3-671b``, block ``mla_moe``) in the port against
the reference, on the CPU.

Inputs come from numpy with a seed; weights are the reference's tiny tree,
carried by ``repro_torch.convert``.  Tolerances: float32 1e-4, as
``tests/test_torch_model.py`` holds the models (products and softmaxes summed
in another order); the plain attention at Dqk != Dv 1e-5 (one softmax over a
few keys); bfloat16 logits 2e-2 of the largest logit, as
``tests/test_torch_moe.py`` holds bf16 outputs (the two frameworks round at
other places; measured 0.9 %).

K1 at MLA's dims (q/k head dim 192, v head dim 128) runs on the card only;
here its wrapper takes the plain version, held against the reference's
``attend_dense`` with scale 1/sqrt(Dqk), and its bf16 plan is held to the
shared-memory arithmetic that ``chip_smoke.py`` holds the compiled plan to.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config, get_tiny_config as j_tiny
from repro.core import model_ingest as r_ingest
from repro.models import Model as JModel, layers as JL, model as JM
from repro.serving import Request as JRequest, ServingEngine as JEngine
from repro_torch.configs import get_config as t_config, get_tiny_config as t_tiny
from repro_torch.convert import from_reference_cache, from_reference_params, reference_layout
from repro_torch.core import model_ingest as t_ingest
from repro_torch.core.backend import profiling as P
from repro_torch.core.ir import OpNode
from repro_torch.kernels import ops
from repro_torch.models import Model, layers as TL, model as TM
from repro_torch.serving import Request, ServingEngine

FA = importlib.import_module("repro_torch.kernels.flash_attention")   # the module, not its function
ARCH = "deepseek-v3-671b"
TOL = 1e-4


def configs(dtype="float32"):
    return (j_tiny(ARCH).replace(dtype=dtype, param_dtype=dtype),
            t_tiny(ARCH).replace(dtype=dtype, param_dtype=dtype))


def reference_params(dtype="float32", seed=0):
    """(reference cfg, port cfg, reference params, the port's tree of them)."""
    cj, ct = configs(dtype)
    pj = JModel(cj).init(jax.random.PRNGKey(seed))
    pn = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), pj)
    return cj, ct, pj, from_reference_params(pn, ct, "cpu")


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def to_reference_cache(cache, cfg):
    """The port's cache in the reference's layout (blocks stacked over
    depth), as float32 numpy."""
    host = {"blocks": [{k: v.float().numpy() for k, v in c.items()} for c in cache["blocks"]],
            "pos": cache["pos"].numpy()}
    return reference_layout(host, cfg, stack=np.stack)


def layer_attn(pj, pt):
    """Layer 0's MLA parameters in both packages."""
    return jax.tree.map(lambda a: a[0], pj["blocks"]["cycle"][0]["attn"]), pt["blocks"][0]["attn"]


def test_mla_full_matches_the_reference():
    cj, ct, pj, pt = reference_params()
    aj, at = layer_attn(pj, pt)
    B, S = 2, 11
    x = np.random.default_rng(1).standard_normal((B, S, ct.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    want, (ckv_j, kr_j) = JM.mla_full(cj, aj, jnp.asarray(x), jnp.asarray(pos))
    got, (ckv, kr) = TM.mla_full(ct, at, torch.from_numpy(x), torch.from_numpy(pos).long())
    assert got.shape == (B, S, ct.d_model)
    assert ckv.shape == (B, S, ct.kv_lora_rank) and kr.shape == (B, S, ct.qk_rope_head_dim)
    close(got, want)
    close(ckv, ckv_j)
    close(kr, kr_j)


def test_mla_decode_matches_the_reference_and_writes_its_rows_in_place():
    cj, ct, pj, pt = reference_params()
    aj, at = layer_attn(pj, pt)
    B, T = 3, 10
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 1, ct.d_model)).astype(np.float32)
    ckv = rng.standard_normal((B, T, ct.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, T, ct.qk_rope_head_dim)).astype(np.float32)
    pos = np.array([0, 6, 13], np.int32)          # an empty ring, a part-full one, a wrapped one
    want, cj_out = JM.mla_decode(cj, aj, jnp.asarray(x), jnp.asarray(pos),
                                 {"ckv": jnp.asarray(ckv), "kr": jnp.asarray(kr)})
    cache = {"ckv": torch.from_numpy(ckv.copy()), "kr": torch.from_numpy(kr.copy())}
    got, c = TM.mla_decode(ct, at, torch.from_numpy(x), torch.from_numpy(pos), cache)
    close(got, want)
    assert c["ckv"] is cache["ckv"] and c["kr"] is cache["kr"]
    close(c["ckv"], cj_out["ckv"])
    close(c["kr"], cj_out["kr"])


def test_the_compressed_cache_is_carried_both_ways():
    """The reference's ``{ckv, kr}`` cache into the port and back, and the
    port's prefill cache into the reference's decode."""
    cj, ct, pj, pt = reference_params(seed=3)
    toks = np.random.default_rng(4).integers(0, ct.vocab_size, (2, 9)).astype(np.int32)
    jm, tm = JModel(cj), Model(ct, "cpu")
    _, cache_j = jm.prefill(pj, {"tokens": jnp.asarray(toks[:, :8])}, cache_len=12)
    np_cache = jax.tree.map(np.asarray, cache_j)
    cache_t = from_reference_cache(np_cache, ct, "cpu")
    assert {k: tuple(v.shape) for k, v in cache_t["blocks"][0].items()} == {
        "ckv": (2, 12, ct.kv_lora_rank), "kr": (2, 12, ct.qk_rope_head_dim)}
    back = to_reference_cache(cache_t, ct)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_cache)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        from_reference_cache(np_cache, ct.replace(kv_lora_rank=8), "cpu")
    _, port_cache = tm.prefill(pt, {"tokens": toks[:, :8]}, cache_len=12)
    lj, _ = jm.decode_step(pj, jax.tree.map(jnp.asarray, to_reference_cache(port_cache, ct)),
                           {"tokens": jnp.asarray(toks[:, 8:])})
    lt, _ = tm.decode_step(pt, port_cache, {"tokens": toks[:, 8:]})
    close(lt, lj)


def test_bfloat16_forward_matches_the_reference():
    cj, ct, pj, pt = reference_params("bfloat16")
    toks = np.random.default_rng(5).integers(0, ct.vocab_size, (2, 16)).astype(np.int32)
    want, _ = JModel(cj).forward(pj, {"tokens": jnp.asarray(toks)})
    got, _ = Model(ct, "cpu").forward(pt, {"tokens": toks})
    want = np.asarray(want, np.float32)
    assert float(np.abs(got.numpy() - want).max()) <= 2e-2 * float(np.abs(want).max())


# ---------------- K1 at Dqk != Dv ----------------

MLA_CASES = [dict(B=1, H=4, Hkv=4, Sq=33, Sk=33, causal=True, window=0),
             dict(B=2, H=6, Hkv=2, Sq=20, Sk=20, causal=True, window=0),      # G = 3
             dict(B=1, H=2, Hkv=2, Sq=9, Sk=17, causal=False, window=0),      # Sq != Sk
             dict(B=1, H=2, Hkv=1, Sq=24, Sk=24, causal=True, window=8)]


def mla_inputs(*, B, H, Hkv, Sq, Sk, Dqk=192, Dv=128, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hkv, H // Hkv, Dqk)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, Dqk)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, Dv)).astype(np.float32))


@pytest.mark.parametrize("case", MLA_CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_flash_attention_plain_at_mla_dims_matches_attend_dense(case):
    """``flash_attention_plain`` and its LSE form (the kernel's function) at
    q/k 192, v 128 against the reference's ``attend_dense`` with scale
    1/sqrt(192); the row log-sum-exp against numpy's."""
    c = dict(case)
    causal, window = c.pop("causal"), c.pop("window")
    q, k, v = mla_inputs(**c)
    B, Sq, Hkv, G, Dqk = q.shape
    scale = 1.0 / math.sqrt(Dqk)
    want = JL.attend_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=0,
                           causal=causal, window=window, scale=scale)
    qh = torch.from_numpy(q).reshape(B, Sq, Hkv * G, Dqk).permute(0, 2, 1, 3)
    kh, vh = (torch.from_numpy(t).permute(0, 2, 1, 3) for t in (k, v))
    o, lse = FA.flash_attention_lse_plain(qh, kh, vh, causal=causal, window=window)
    assert o.shape == (B, Hkv * G, Sq, 128)
    close(o.permute(0, 2, 1, 3).reshape(B, Sq, Hkv, G, 128), want, 1e-5)
    close(FA.flash_attention_plain(qh, kh, vh, causal=causal, window=window), o.numpy(), 0)
    # the wrapper on a CPU tensor is the plain version, lse and out included
    out = torch.empty((B, Hkv * G, Sq, 128))
    lse_w = torch.empty((B, Hkv * G, Sq))
    FA.flash_attention(qh, kh, vh, causal=causal, window=window, out=out, lse=lse_w)
    assert torch.equal(out, o) and torch.equal(lse_w, lse)
    s = np.einsum("bskgd,btkd->bkgst", q, k) * scale
    qp, tp = np.arange(Sq)[:, None], np.arange(k.shape[1])[None, :]
    mask = np.ones((Sq, k.shape[1]), bool)
    if causal:
        mask &= tp <= qp
    if window:
        mask &= tp > qp - window
    s = np.where(mask, s, -np.inf)
    mx = s.max(-1, keepdims=True)
    want_lse = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    close(lse, want_lse.reshape(B, Hkv * G, Sq), 1e-5)


@pytest.mark.parametrize("case", MLA_CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_flash_attention_bwd_plain_at_mla_dims_matches_jax_grad(case):
    """``flash_attention_bwd_plain`` (the backward kernels' arithmetic) at
    q/k 192, v 128 against ``jax.grad`` of the reference's ``attend_dense``
    with the same dO, in float32 to 2e-6 (a few sums over 20-odd keys), from
    the plain forward's output and log-sum-exp."""
    c = dict(case)
    causal, window = c.pop("causal"), c.pop("window")
    q, k, v = mla_inputs(**c)
    B, Sq, Hkv, G, Dqk = q.shape
    do = np.random.default_rng(5).standard_normal((B, Sq, Hkv, G, 128)).astype(np.float32)
    fn = lambda q_, k_, v_: JL.attend_dense(q_, k_, v_, q_offset=0, causal=causal,  # noqa: E731
                                            window=window)
    _, vjp = jax.vjp(fn, *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(do))
    qh = torch.from_numpy(q).reshape(B, Sq, Hkv * G, Dqk).permute(0, 2, 1, 3)
    kh, vh = (torch.from_numpy(t).permute(0, 2, 1, 3) for t in (k, v))
    doh = torch.from_numpy(do).reshape(B, Sq, Hkv * G, 128).permute(0, 2, 1, 3)
    o, lse = FA.flash_attention_lse_plain(qh, kh, vh, causal=causal, window=window)
    dq, dk, dv = FA.flash_attention_bwd_plain(qh, kh, vh, o, lse, doh, causal=causal,
                                              window=window)
    assert (dq.shape, dk.shape, dv.shape) == (qh.shape, kh.shape, vh.shape)
    close(dq.permute(0, 2, 1, 3).reshape(q.shape), want[0], 2e-6)
    close(dk.permute(0, 2, 1, 3), want[1], 2e-6)
    close(dv.permute(0, 2, 1, 3), want[2], 2e-6)


def test_attention_backward_at_mla_dims_on_the_cpu():
    """The plain backward at Dqk != Dv equals autograd of the plain forward;
    ``ops.flash_attention_bshd`` records through it on the CPU (on the card
    through the backward's FMA kernels at those dims)."""
    q, k, v = (torch.from_numpy(t) for t in mla_inputs(B=1, H=4, Hkv=2, Sq=19, Sk=19))
    do = torch.from_numpy(np.random.default_rng(9).standard_normal((1, 19, 2, 2, 128),
                                                                   dtype=np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ops.flash_attention_bshd(*leaves, causal=True)
    assert o.shape == (1, 19, 2, 2, 128)
    got = torch.autograd.grad(o, leaves, do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(TL.attend_dense(*ref, q_offset=0, causal=True), ref, do)
    for a, b in zip(got, want):
        close(a, b.numpy(), 1e-5)


def test_k1_plans_at_mla_dims():
    """Q (24 KB) and two stages of a K and V ring of 24 + 16 KB a stage: 104
    KB and 256 of barriers, two blocks an SM.  Three stages would take 144
    KB and leave one block an SM (the slower plan on the card).  The
    single-D plan at D 256 is what it was; D 64's has two stages of 128 kv
    rows, 72 KB, three blocks an SM; D 128's a block of 128 q rows (two
    consumer warpgroups and a producer) and three stages of 128 kv rows, 224
    KB, one an SM."""
    assert FA.tile_plan(192, 128) == {"q_rows": 64, "kv_rows": 64, "stages": 2, "threads": 256,
                                      "blocks_per_sm": 2, "smem_bytes": 106_752, "flat_grid": 0}
    three = 64 * 192 * 2 + 3 * 64 * (192 + 128) * 2 + 256
    assert three == 147_712 and 2 * (three + 1024) > FA.SM_SMEM
    assert [(FA.tile_plan(D)["blocks_per_sm"], FA.tile_plan(D)["smem_bytes"])
            for D in FA.SUPPORTED_D] == [(3, 73_984), (1, 229_632), (1, 229_632)]
    for bad in ((192, 192), (128, 64), (64, 128)):
        assert not FA.supported(*bad)
        with pytest.raises(ValueError):
            FA.tile_plan(*bad)
    assert [FA.tile_plan(D)["stages"] for D in FA.SUPPORTED_D] == [2, 3, 3]


# ---------------- the simulator's side ----------------

def mla_attention_node(dv, backward=False):
    node = OpNode("attn", "attention", dtype="f32", out_shape=(1, 20, 4, 1, dv))
    node.attrs.update(attn_dims=(1, 4, 20, 20, 192), causal=True, window=0, G=1)
    if dv != 192:
        node.attrs["dv"] = dv          # as the tracer records it (next test)
    if backward:
        node.attrs["backward"] = True
    return node


def test_profiling_engine_synthesises_an_mla_attention_node():
    """v's head dim from the node's ``dv``, the output's last dim: K1's plain
    version runs at (192, 128) on the CPU, and the key keeps it apart from
    (192, 192)."""
    mla, square = mla_attention_node(128), mla_attention_node(192)
    assert P.attn_v_dim(mla) == 128 and P.attn_v_dim(square) == 192
    assert P.node_key(mla, "h100_sxm") == "h100_sxm|attention|1,4,20,20,192|f32|G1|Dv128"
    assert P.node_key(square, "h100_sxm") == "h100_sxm|attention|1,4,20,20,192|f32|G1"
    us = P.synthesize_and_measure(mla, device="cpu")
    assert us is not None and us > 0
    assert P.synthesize_and_measure(square, device="cpu") is None     # no kernel at (192, 192)
    # a backward node's output is dq: the tracer records v's dim, and the
    # engine times K1's backward at (192, 128) (its plain version here)
    bwd = mla_attention_node(128, backward=True)
    assert P.attn_v_dim(bwd) == 128
    assert P.node_key(bwd, "h100_sxm").endswith("|G1|Dv128|bwd")
    us_bwd = P.synthesize_and_measure(bwd, device="cpu")
    assert us_bwd is not None and us_bwd > 0
    assert P.synthesize_and_measure(mla_attention_node(192, backward=True), device="cpu") is None


def test_traced_prefill_attention_carries_both_head_dims():
    mg = t_ingest.block_graphs(t_config(ARCH), 1, 512, "prefill")
    (node,) = [n for n in mg.blocks[0].fwd if n.kind == "attention"]
    assert node.attrs["attn_dims"] == (1, 128, 512, 512, 192)
    assert node.out_shape[-1] == node.attrs["dv"] == 128
    assert P.node_key(node, "h100_sxm").endswith("|bf16|G1|Dv128")


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_moe_expert_tags_match_the_reference(mode):
    """``_tag_moe`` tags the same batched expert products (out_shape[0] =
    256) in both packages; as for olmoe, JAX's router weight gradient (E, D)
    is tagged too in the reference's joint graph."""
    import collections
    cfgs = (j_config(ARCH), t_config(ARCH))
    B, S, cl = {"train": (8, 2048, 0), "prefill": (1, 512, 0), "decode": (8, 1, 2048)}[mode]
    r, t = (m.block_graphs(c, B, S, mode, cache_len=cl) for m, c in zip((r_ingest, t_ingest), cfgs))
    for which in ("fwd", "joint"):
        rg, tg = getattr(r.blocks[0], which), getattr(t.blocks[0], which)
        if rg is None:
            continue

        def tagged(g, ndim):
            return collections.Counter((tuple(sorted(n.out_shape[1:])), n.flops) for n in g
                                       if n.attrs.get("moe_expert") and len(n.out_shape) == ndim)

        assert tagged(rg, 3) == tagged(tg, 3)
        assert sum(tagged(tg, 3).values()) == (9 if which == "joint" else 3)
        assert not tagged(tg, 2)


def test_moe_batch_extrapolation_bites_past_102_tokens_in_both_packages():
    """deepseek's decode capacity ``max(ceil(B * 8 / 256 * 1.25), 4)`` is 4 up
    to B 102 and 5 from B 103.  Both packages verify at B 8 and 16 and then
    extrapolate with the anchors' capacity of 4: right at B 32 and 64, wrong
    at B 128 (5) and 256 (10), the fault the reference keeps (ROADMAP queue
    C).  The stats and the capacities given are the reference's."""
    got = {}
    for name, mod, cfg in (("ref", r_ingest, j_config(ARCH)), ("port", t_ingest, t_config(ARCH))):
        mod.ingest_extrapolation_clear()
        try:
            caps = []
            for B in (1, 2, 4, 8, 16, 32, 64, 128, 256):
                g = mod.ingest_graphs(cfg, B, 1, "decode", cache_len=512)
                caps.append(next(n.out_shape[1] for n in g.blocks[0].fwd
                                 if n.kind == "elementwise" and len(n.out_shape) == 3
                                 and n.out_shape[::2] == (cfg.num_experts, cfg.moe_d_ff)))
            got[name] = (mod.ingest_extrapolation_stats(), caps)
        finally:
            mod.ingest_extrapolation_clear()
    assert got["port"] == got["ref"]
    stats, caps = got["port"]
    assert stats == {"extrapolated": 4, "traced": 5} and caps == [4] * 9
    assert [TL.moe_capacity(t_config(ARCH), B) for B in (102, 103, 128, 256)] == [4, 5, 5, 10]


# ---------------- serving ----------------

PROMPTS = [[1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5]]      # 3 requests, 2 slots


@pytest.mark.parametrize("cache_len", [64, 8])      # 8: positions reach 9, so pos % T wraps
def test_engine_serves_the_tiny_config_as_the_reference_engine(cache_len):
    """The engine admits into the compressed ``{ckv, kr}`` cache (every leaf
    copied into the slot) and decodes the absorbed form: the greedy tokens
    and the slots are the reference engine's."""
    cj, ct, pj, pt = reference_params()
    je = JEngine(cj, pj, slots=2, cache_len=cache_len)
    te = ServingEngine(ct, pt, slots=2, cache_len=cache_len, device="cpu")
    assert set(te.cache["blocks"][0]) == {"ckv", "kr"}
    for i, p in enumerate(PROMPTS):
        je.submit(JRequest(rid=i, prompt=p, max_new_tokens=5))
        te.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    want = {r.rid: r.tokens for r in je.run_until_drained(max_steps=200)}
    got = {r.rid: r.tokens for r in te.run_until_drained(max_steps=200)}
    assert len(got) == 3 and all(len(t) == 5 for t in got.values())
    assert got == want
    assert [r.slot for r in sorted(te.finished, key=lambda r: r.rid)] == \
           [r.slot for r in sorted(je.finished, key=lambda r: r.rid)]
