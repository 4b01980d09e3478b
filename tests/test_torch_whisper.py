"""The Whisper family (whisper-large-v3: the ``enc`` encoder block, the
``xattn`` decoder block with its cross attention, LayerNorm, sinusoidal
positions) in ``repro_torch`` against the reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
models' weights are the reference's init with numpy noise on every leaf
(the reference starts norm scales at 1 and biases at 0, which would leave
them untested), carried by ``repro_torch.convert``.  Frame embeddings are
drawn times 0.1, as ``tests/test_archs.py`` draws them.  Tolerances, as
``tests/test_torch_rglru.py``'s:

* float32 2e-6 (absolute and relative) for a function or a block: the
  products and the transcendentals round their last bits in another place;
* bfloat16 2e-2: the two frameworks round bf16 at other places;
* model logits 1e-4 in float32, as ``tests/test_torch_model.py``: the error
  grows through the layers; in bfloat16 5e-2, as that file's bf16 forward
  holds them (a function's 2e-2 does not hold through this model's four
  layers).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config, get_tiny_config as j_tiny
from repro.core import model_ingest as r_ingest
from repro.models import Model as JModel
from repro.models import layers as JL, model as JM
from repro.serving.engine import Request as JRequest, ServingEngine as JEngine
from repro.training.data import SyntheticTokenPipeline as JPipe
from repro.training.train_step import make_loss_fn as j_loss
from repro_torch import kernels as K
from repro_torch.configs import get_config as t_config, get_tiny_config as t_tiny
from repro_torch.convert import (
    from_reference_cache, from_reference_params, port_layout, reference_layout,
    to_reference_params,
)
from repro_torch.core import model_ingest as t_ingest
from repro_torch.models import Model as TModel
from repro_torch.models import layers as TL, model as TM
from repro_torch.models.kvcache import build_cache, cache_len_of
from repro_torch.serving.engine import ServingEngine
from repro_torch.training import SyntheticTokenPipeline, make_loss_fn
from repro_torch.training.optimizer import tree_leaves

ARCH = "whisper-large-v3"
TOL = {"float32": 2e-6, "bfloat16": 2e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def close(got, want, tol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(jnp.asarray(want, jnp.float32)), atol=tol, rtol=tol)


def data(rng, shape, dtype, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, J_DT[dtype]), torch.from_numpy(x).to(T_DT[dtype])


def reference_params(dtype="float32", seed=0):
    """(reference cfg, port cfg, reference params, the same as float32
    numpy): the reference's init with numpy noise on every leaf."""
    cj = j_tiny(ARCH).replace(dtype=dtype, param_dtype=dtype)
    ct = t_tiny(ARCH).replace(dtype=dtype, param_dtype=dtype)
    params = JModel(cj).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: (a.astype(jnp.float32) + jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32) * 0.05)).astype(a.dtype), params)
    return cj, ct, params, jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)


def tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def frames(cfg, B, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)


def attn_params(rng, D, H, Dh, dtype):
    """A biased attention projection set as numpy, then (reference, port)."""
    p = {"q": {"w": rng.standard_normal((D, H, Dh)) / np.sqrt(D), "b": rng.standard_normal((H, Dh))},
         "k": {"w": rng.standard_normal((D, H, Dh)) / np.sqrt(D), "b": rng.standard_normal((H, Dh))},
         "v": {"w": rng.standard_normal((D, H, Dh)) / np.sqrt(D), "b": rng.standard_normal((H, Dh))},
         "o": {"w": rng.standard_normal((H, Dh, D)) / np.sqrt(H * Dh)}}
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    return (jax.tree.map(lambda a: jnp.asarray(a, J_DT[dtype]), p),
            jax.tree.map(lambda a: torch.from_numpy(a).to(T_DT[dtype]), p))


# ---------------- the layers ----------------

@pytest.mark.parametrize("d_model", [64, 1280, 6])
def test_sinusoidal_positions_match_the_reference(d_model):
    """float32; ``half - 1`` in the divisor, sines then cosines; positions
    up to Whisper's 1500 frames.  The two frameworks' float32 ``exp`` differ
    in the last bit for some frequencies, and an
    angle ``pos * freq`` carries that difference times the position, and
    the two products round apart once it does: so the frequencies are held to
    one ulp of each other, and each element to 2e-6 plus its position times
    its frequencies' difference plus one ulp of its angle (2e-6 alone
    wherever the frequencies are equal, and everywhere below position 32)."""
    pos = np.stack([np.arange(1500), np.arange(1500)[::-1]]).astype(np.int32)
    want = np.asarray(JL.sinusoidal_positions(jnp.asarray(pos), d_model))
    got = TL.sinusoidal_positions(torch.from_numpy(pos.astype(np.int64)), d_model)
    assert got.dtype == torch.float32 and got.shape == (2, 1500, d_model)
    half = d_model // 2
    step = math.log(10_000.0) / max(half - 1, 1)
    fj = np.asarray(jnp.exp(-jnp.arange(half, dtype=jnp.float32) * step))    # the reference's
    ft = torch.exp(-torch.arange(half, dtype=torch.float32) * step).numpy()
    np.testing.assert_array_max_ulp(ft, fj, maxulp=1)
    ang = np.abs(pos[..., None].astype(np.float32) * fj)
    bound = TOL["float32"] + np.tile(pos[..., None] * np.abs(ft - fj) + np.spacing(ang), 2)
    assert (np.abs(got.numpy() - want) <= bound).all()
    close(got[0, :32], want[0, :32], TOL["float32"])            # row 0: positions 0..31


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_the_reference(dtype):
    rng = np.random.default_rng(5)
    xj, xt = data(rng, (3, 7, 64), dtype, 3.0)
    wj, wt = data(rng, (64,), dtype)
    bj, bt = data(rng, (64,), dtype)
    got = TL.layernorm(wt, bt, xt, eps=1e-5)
    assert got.dtype == T_DT[dtype]
    close(got, JL.layernorm(wj, bj, xj, eps=1e-5), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 5, 12])
def test_cross_full_matches_the_reference(S, dtype):
    """q from the decoder's rows, k and v from the encoder's 32 rows, not
    causal; the (k, v) the cache keeps as ck/cv."""
    cj, ct = j_tiny(ARCH), t_tiny(ARCH)
    rng = np.random.default_rng(S)
    pj, pt = attn_params(rng, ct.d_model, ct.num_heads, ct.head_dim, dtype)
    xj, xt = data(rng, (2, S, ct.d_model), dtype)
    ej, et = data(rng, (2, ct.encoder_seq, ct.d_model), dtype)
    want, (kj, vj) = JM.cross_full(cj, pj, xj, ej)
    got, (kt, vt) = TM.cross_full(ct, pt, xt, et)
    assert got.shape == (2, S, ct.d_model) and kt.shape == (2, ct.encoder_seq, ct.num_kv_heads,
                                                            ct.head_dim)
    close(got, want, TOL[dtype])
    close(kt, kj, TOL[dtype])
    close(vt, vj, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_decode_matches_the_reference_and_writes_nothing(dtype):
    cj, ct = j_tiny(ARCH), t_tiny(ARCH)
    rng = np.random.default_rng(9)
    pj, pt = attn_params(rng, ct.d_model, ct.num_heads, ct.head_dim, dtype)
    xj, xt = data(rng, (3, 1, ct.d_model), dtype)
    shape = (3, ct.encoder_seq, ct.num_kv_heads, ct.head_dim)
    ckj, ckt = data(rng, shape, dtype)
    cvj, cvt = data(rng, shape, dtype)
    before = (ckt.clone(), cvt.clone())
    want = JM.cross_decode(cj, pj, xj, {"ck": ckj, "cv": cvj})
    got = TM.cross_decode(ct, pt, xt, {"ck": ckt, "cv": cvt})
    close(got, want, TOL[dtype])
    assert torch.equal(ckt, before[0]) and torch.equal(cvt, before[1])


def test_one_query_token_with_no_valid_length_takes_the_decode_kernels_route(monkeypatch):
    """``_attend_kernel`` sends an Sq == 1, unmasked call with no valid
    length (the cross decode) to K2, here its plain version (``plain=True``),
    with every key row valid; the same call recorded by autograd stays on
    K1, whose backward K2 lacks."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 1, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 32, 4, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 32, 4, 16)).astype(np.float32))
    calls = []
    for name in ("decode_attention_plain", "flash_attention_plain"):
        monkeypatch.setattr(TL, name, lambda *a, _real=getattr(TL, name), _n=name, **kw:
                            calls.append((_n, kw.get("kv_valid_len"))) or _real(*a, **kw))
    got = TL.attention(q, k, v, causal=False, strategy="kernel", plain=True)
    assert [n for n, _ in calls] == ["decode_attention_plain"] and calls[0][1] is None
    close(got, TL.attend_dense(q, k, v, q_offset=0, causal=False).numpy(), TOL["float32"])
    calls.clear()
    TL.attention(q, k.requires_grad_(), v, causal=False, strategy="kernel", plain=True)
    assert [n for n, _ in calls] == ["flash_attention_plain"]
    calls.clear()
    TL.attention(q.expand(2, 3, 4, 1, 16), k.detach(), v, causal=False, strategy="kernel",
                 plain=True)
    assert [n for n, _ in calls] == ["flash_attention_plain"]      # Sq 3: K1


def test_cross_decode_on_a_cpu_tensor_launches_nothing():
    K.reset_launch_counts()
    cj, ct, pj, pn = reference_params()
    pt = from_reference_params(pn, ct, "cpu")
    m = TModel(ct, "cpu")
    _, cache = m.prefill(pt, {"tokens": tokens(ct, 2, 4), "frame_embeds": frames(ct, 2)},
                         cache_len=8)
    m.decode_step(pt, cache, {"tokens": tokens(ct, 2, 1)})
    assert set(K.launch_counts().values()) == {0}


# ---------------- the blocks ----------------

def block_params(pj, pn, ct, kind, layer):
    """One layer of ``kind`` (``xattn`` of the decoder, ``enc`` of the
    encoder) in both packages."""
    tree = from_reference_params(pn, ct, "cpu")
    if kind == "enc":
        return (jax.tree.map(lambda a: a[layer], pj["encoder"]["blocks"]["cycle"][0]),
                tree["encoder"]["blocks"][layer])
    return jax.tree.map(lambda a: a[layer], pj["blocks"]["cycle"][0]), tree["blocks"][layer]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", [0, 1])
def test_enc_block_matches_the_reference(layer, dtype):
    """The encoder's block over its 32 frames, not causal, no cache."""
    cj, ct, pj, pn = reference_params(dtype)
    pjl, ptl = block_params(pj, pn, ct, "enc", layer)
    rng = np.random.default_rng(layer)
    B, S = 2, ct.encoder_seq
    hj, ht = data(rng, (B, S, ct.d_model), dtype)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want, cache_j, _ = JM.apply_block_full(cj, "enc", pjl, hj, {"positions": jnp.asarray(pos)},
                                           False)
    h, f, cache_t, aux = TM.apply_block_full(ct, "enc", ptl, ht, None,
                                             {"positions": torch.from_numpy(pos.copy())}, False)
    assert cache_j is None and cache_t is None and aux is None
    close(h + f, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xattn_block_matches_the_reference_in_full_and_decode_mode(dtype):
    """A prefill of 12 tokens against 32 encoder rows (its output and its
    ``{k, v, ck, cv}`` cache), then two decode steps against that cache, the
    second wrapping the ring of 13 rows.  The port's block returns
    the residual stream and the add it leaves pending; their sum is the
    reference's output."""
    cj, ct, pj, pn = reference_params(dtype)
    pjl, ptl = block_params(pj, pn, ct, "xattn", 1)
    rng = np.random.default_rng(3)
    B, S, T = 2, 12, 13
    hj, ht = data(rng, (B, S, ct.d_model), dtype)
    ej, et = data(rng, (B, ct.encoder_seq, ct.d_model), dtype)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want, cache_j, _ = JM.apply_block_full(cj, "xattn", pjl, hj, {
        "positions": jnp.asarray(pos), "cache_len": T, "enc_out": ej}, True)
    h, f, cache_t, aux = TM.apply_block_full(ct, "xattn", ptl, ht, None, {
        "positions": torch.from_numpy(pos.copy()), "cache_len": T, "enc_out": et}, True)
    assert aux is None and list(cache_t) == ["k", "v", "ck", "cv"]
    close(h + f, want, TOL[dtype])
    assert set(cache_t) == set(cache_j)
    for name in cache_t:
        close(cache_t[name], cache_j[name], TOL[dtype])
    ck = cache_t["ck"].clone()
    for step in range(2):
        xj, xt = data(rng, (B, 1, ct.d_model), dtype)
        pos1 = np.full((B,), S + step, np.int32)
        want, cache_j = JM.apply_block_decode(cj, "xattn", pjl, xj, cache_j,
                                              {"pos": jnp.asarray(pos1)})
        h, f, new_t = TM.apply_block_decode(ct, "xattn", ptl, xt, None, cache_t,
                                            {"pos": torch.from_numpy(pos1)})
        assert all(new_t[n] is cache_t[n] for n in cache_t)     # written in place
        close(h + f, want, TOL[dtype])
        for name in new_t:
            close(new_t[name], cache_j[name], TOL[dtype])
    assert torch.equal(cache_t["ck"], ck)                         # read, never written


# ---------------- the model ----------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_model_forward_prefill_and_decode_match_the_reference(dtype):
    """forward over 16 tokens; prefill of 12 into a ring of 14, then three
    decode steps, the third past the ring's end; logits and caches."""
    cj, ct, pj, pn = reference_params(dtype)
    pt = from_reference_params(pn, ct, "cpu")
    B, S, T = 2, 12, 14
    toks, fe = tokens(ct, B, S + 4), frames(ct, B)
    jm, tm = JModel(cj), TModel(ct, "cpu")
    want, _ = jm.forward(pj, {"tokens": jnp.asarray(toks), "frame_embeds": jnp.asarray(fe)})
    got, aux = tm.forward(pt, {"tokens": toks, "frame_embeds": fe})
    assert float(aux) == 0.0
    close(got, want, MODEL_TOL[dtype])
    lj, cache_j = jm.prefill(pj, {"tokens": jnp.asarray(toks[:, :S]),
                                  "frame_embeds": jnp.asarray(fe)}, cache_len=T)
    lt, cache_t = tm.prefill(pt, {"tokens": toks[:, :S], "frame_embeds": fe}, cache_len=T)
    close(lt, lj, MODEL_TOL[dtype])
    want_cache = from_reference_cache(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                                                   cache_j), ct, "cpu", torch.float32)
    for mine, theirs in zip(cache_t["blocks"], want_cache["blocks"], strict=True):
        assert list(mine) == list(theirs) == ["k", "v", "ck", "cv"]
        for name in mine:
            close(mine[name], theirs[name], MODEL_TOL[dtype])
    for i in range(3):
        step = toks[:, S + i:S + i + 1]
        lj, cache_j = jm.decode_step(pj, cache_j, {"tokens": jnp.asarray(step)})
        lt, cache_t = tm.decode_step(pt, cache_t, {"tokens": step})
        close(lt, lj, MODEL_TOL[dtype])
    assert int(cache_t["pos"][0]) == S + 3


def test_encoder_matches_the_reference():
    cj, ct, pj, pn = reference_params()
    pt = from_reference_params(pn, ct, "cpu")
    fe = frames(ct, 2)
    want = JModel(cj).encode(pj, jnp.asarray(fe))
    got = TModel(ct, "cpu").encode(pt, fe)
    assert got.shape == (2, ct.encoder_seq, ct.d_model)
    close(got, want, MODEL_TOL["float32"])


def test_embed_adds_the_rounded_sinusoid_at_the_prompts_positions():
    """bf16: the sinusoid is rounded to bf16 and then added, as the
    reference does; decode adds the position of each row's token."""
    _, ct, pj, pn = reference_params("bfloat16")
    pt = from_reference_params(pn, ct, "cpu")
    toks = torch.from_numpy(tokens(ct, 2, 5).astype(np.int64))
    pos = torch.tensor([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]])
    got = TModel(ct, "cpu")._embed(pt, toks, pos)
    want = (pt["embed"]["w"][toks].to(torch.bfloat16)
            + TL.sinusoidal_positions(pos, ct.d_model).to(torch.bfloat16))
    assert torch.equal(got, want)


def test_decode_from_a_carried_over_cache():
    """The reference prefills (its encoder's ck/cv included), the port decodes."""
    cj, ct, pj, pn = reference_params(seed=3)
    pt = from_reference_params(pn, ct, "cpu")
    toks, fe = tokens(ct, 2, 9, seed=4), frames(ct, 2, seed=5)
    jm, tm = JModel(cj), TModel(ct, "cpu")
    _, cache_j = jm.prefill(pj, {"tokens": jnp.asarray(toks[:, :8]),
                                 "frame_embeds": jnp.asarray(fe)}, cache_len=16)
    cache_t = from_reference_cache(jax.tree.map(np.asarray, cache_j), ct, "cpu")
    assert [list(c) for c in cache_t["blocks"]] == [["k", "v", "ck", "cv"]] * ct.num_layers
    lj, _ = jm.decode_step(pj, cache_j, {"tokens": jnp.asarray(toks[:, 8:])})
    lt, _ = tm.decode_step(pt, cache_t, {"tokens": toks[:, 8:]})
    close(lt, lj, MODEL_TOL["float32"])


# ---------------- the cache and the converters ----------------

def test_cache_len_of_reads_the_self_ring_and_not_the_encoder_rows():
    ct = t_tiny(ARCH)
    cache = build_cache(ct, lambda s, logical, d: torch.zeros(s, dtype=d), 2, 10)
    assert [list(c) for c in cache["blocks"]] == [["k", "v", "ck", "cv"]] * ct.num_layers
    assert cache["blocks"][0]["ck"].shape[1] == ct.encoder_seq == 32
    assert cache_len_of(cache) == 10
    # whatever the order of the layer's dict
    cache["blocks"] = [{n: c[n] for n in ("ck", "cv", "k", "v")} for c in cache["blocks"]]
    assert cache_len_of(cache) == 10


def test_params_round_trip_with_the_encoder_tree_and_reject_another_config():
    cj, ct, pj, pn = reference_params()
    pt = from_reference_params(pn, ct, "cpu")
    assert len(pt["encoder"]["blocks"]) == ct.encoder_layers
    assert np.array_equal(pt["encoder"]["blocks"][1]["attn"]["k"]["b"].numpy(),
                          pn["encoder"]["blocks"]["cycle"][0]["attn"]["k"]["b"][1])
    back = to_reference_params(pt, ct)
    assert jax.tree.structure(back) == jax.tree.structure(pn)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pn)):
        assert np.array_equal(a, b)
    stacked = reference_layout(pt, ct)
    assert stacked["encoder"]["blocks"]["cycle"][0]["mlp"]["up"]["w"].shape == (
        ct.encoder_layers, ct.d_model, ct.d_ff)
    again = port_layout(stacked, ct)
    for a, b in zip(tree_leaves(again), tree_leaves(pt)):
        assert torch.equal(a, b)
    for layers in (1, 3):                                      # the tree has 2
        with pytest.raises(ValueError):
            from_reference_params(pn, ct.replace(encoder_layers=layers), "cpu")
    with pytest.raises(ValueError):
        from_reference_params(pn, ct.replace(encoder_layers=0), "cpu")
    with pytest.raises(ValueError):
        from_reference_params(pn, t_tiny("phi4-mini-3.8b"), "cpu")


def test_cache_of_another_config_is_rejected():
    cj, ct, pj, pn = reference_params()
    _, cache_j = JModel(cj).prefill(pj, {"tokens": jnp.asarray(tokens(ct, 2, 4)),
                                         "frame_embeds": jnp.asarray(frames(ct, 2))},
                                    cache_len=8)
    np_cache = jax.tree.map(np.asarray, cache_j)
    assert from_reference_cache(np_cache, ct, "cpu")["blocks"][0]["cv"].shape == (2, 32, 4, 16)
    with pytest.raises(ValueError):
        from_reference_cache(np_cache, ct.replace(encoder_seq=16), "cpu")


# ---------------- training ----------------

def test_loss_and_gradients_match_the_reference_the_encoders_included():
    cj, ct, pj, pn = reference_params()
    rng = np.random.default_rng(11)
    toks = rng.integers(0, ct.vocab_size, (2, 13)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy(), "frame_embeds": frames(ct, 2)}
    (lj, _), gj = jax.value_and_grad(j_loss(JModel(cj)), has_aux=True)(
        pj, jax.tree.map(jnp.asarray, batch))
    pt = from_reference_params(pn, ct, "cpu")
    for p in tree_leaves(pt):
        p.requires_grad_()
    lt, _ = make_loss_fn(TModel(ct, "cpu", remat_policy="block"))(pt, batch)
    gt = torch.autograd.grad(lt, tree_leaves(pt))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=2e-5, atol=2e-5)
    want = tree_leaves(from_reference_params(jax.tree.map(np.asarray, gj), ct, "cpu"))
    names = [" ".join(map(str, k)) for k, _ in jax.tree_util.tree_flatten_with_path(
        to_reference_params(pt, ct))[0]]
    assert any("encoder" in n for n in names)
    enc = tree_leaves(pt["encoder"])
    assert any(float(g.abs().max()) > 1e-3 for g, p in zip(gt, tree_leaves(pt))
               if any(p is e for e in enc))           # the encoder is trained through
    for a, b in zip(gt, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-5)


def test_pipeline_yields_the_references_frame_embeddings():
    kw = dict(global_batch=2, seq_len=8, seed=3, host_id=0, num_hosts=1, start_step=0)
    jp, tp = JPipe(j_tiny(ARCH), **kw), SyntheticTokenPipeline(t_tiny(ARCH), **kw)
    try:
        a, b = next(jp), next(tp)
        assert a["frame_embeds"].shape == (2, 32, 64)
        for k in a:
            assert np.array_equal(a[k], b[k])
    finally:
        jp.close()
        tp.close()


# ---------------- serving and the simulator ----------------

def test_engine_raises_for_an_encoder_decoder_where_the_reference_fails():
    """The reference's engine prefills ``{"tokens": prompt}`` alone, so its
    encoder fails on the missing frame embeddings; the port's engine says so
    when it is made."""
    cj = j_tiny(ARCH)
    eng = JEngine(cj, JModel(cj).init(jax.random.PRNGKey(0)), slots=2, cache_len=16)
    eng.submit(JRequest(0, [1, 2, 3], max_new_tokens=2))
    with pytest.raises(KeyError, match="frame_embeds"):
        eng.step()
    ct = t_tiny(ARCH)
    with pytest.raises(ValueError, match="encoder-decoder"):
        ServingEngine(ct, TModel(ct, "cpu").init(torch.Generator().manual_seed(0)),
                      slots=2, cache_len=16, device="cpu")


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_ingest_prices_the_encoder_and_the_cross_attention_as_the_reference(mode):
    """Full width: the encoder is one ``enc`` block repeated 32 times (none
    in decode); the cross attention is one node at Sq the prompt, Sk 1500,
    not causal (one query row in decode, on K2's route); the decode graph
    reads ck/cv and writes only the self ring's row."""
    cfg = t_config(ARCH)
    B, S, cl = {"train": (2, 448, 0), "prefill": (1, 224, 0), "decode": (8, 1, 448)}[mode]
    r = r_ingest.block_graphs(j_config(ARCH), B, S, mode, cache_len=cl)
    t = t_ingest.block_graphs(cfg, B, S, mode, cache_len=cl)
    assert [(b.kind, b.repeat) for b in t.all_blocks()] == \
        [(b.kind, b.repeat) for b in r.all_blocks()]
    assert (t.encoder is None) == (mode == "decode")
    if t.encoder is not None:
        assert t.encoder.repeat == 32 and (t.encoder.joint is None) == (mode != "train")
        enc_attn = [n.attrs["attn_dims"] + (n.attrs["causal"],) for n in t.encoder.fwd
                    if n.kind == "attention"]
        assert enc_attn == [(B, 20, 1500, 1500, 64, False)]
    attn = sorted(n.attrs["attn_dims"] + (n.attrs["causal"],) for n in t.blocks[0].fwd
                  if n.kind == "attention")
    Sq = 1 if mode == "decode" else S
    self_T = cl if mode == "decode" else S
    assert attn == sorted([(B, 20, Sq, self_T, 64, mode != "decode"),
                           (B, 20, Sq, 1500, 64, False)])
    if mode == "decode":
        written = [n for n in t.blocks[0].fwd if n.kind == "scatter"]
        assert written and all(n.out_shape[1] == cl for n in written)


def test_simulator_prices_the_encoder_in_train_and_prefill():
    from repro_torch.api import PrefillWorkload, SimSpec, TrainWorkload
    from repro_torch.core import Simulator
    sim = Simulator("h100_sxm")
    cfg = t_config(ARCH)
    pre = sim.run(SimSpec(cfg, workload=PrefillWorkload(global_batch=1, seq_len=224)))
    assert pre.detail["t_fwd"]["enc"] > pre.detail["t_fwd"]["xattn"] > 0
    train = sim.run(SimSpec(cfg, workload=TrainWorkload(global_batch=8, seq_len=448)))
    assert train.detail["t_bwd"]["enc"] > 0
    assert train.memory.weights == 2 * 1_535_587_840
