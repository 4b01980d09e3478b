"""The port's dense model against ``repro.models.Model`` with weights carried
across.  The reference initialises its parameters; they go to numpy, norm
weights and biases get numpy noise (the reference sets them to exactly 1 or
0, which would leave ``w``, ``1 + w`` and the bias adds untested), and both
models run on the same tree.

float32 logits agree to 1e-4: the two frameworks sum the matrix products and
the softmax in another order, and the error grows through the layers.

An encoder-decoder (whisper) takes frame embeddings beside its prompt
(``frames``: numpy from a seed, times 0.1, as ``tests/test_archs.py`` draws
them); its decode steps take tokens only.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.configs import get_config as j_config, get_tiny_config as j_tiny
from repro.models import Model as JModel, count_params as j_count
from repro.models.kvcache import cache_bytes as j_cache_bytes
from repro_torch.configs import ARCH_IDS, get_config as t_config, get_tiny_config as t_tiny
from repro_torch.configs import torch_dtype
from repro_torch.convert import from_reference_cache, from_reference_params, to_reference_params
from repro_torch import kernels as K
from repro_torch.models import Model as TModel, cache_bytes as t_cache_bytes, count_params as t_count
from repro_torch.models import layers as TL, model as TM
from repro_torch.models.kvcache import cache_len_of

TOL = 1e-4
FULL_COUNTS = {"phi4-mini-3.8b": 3_836_021_760, "gemma-7b": 8_537_680_896,
               "olmoe-1b-7b": 6_919_096_320, "deepseek-v3-671b": 703_797_812_224,
               "whisper-large-v3": 1_535_587_840}
ACTIVE_COUNTS = {"olmoe-1b-7b": 1_281_951_744, "deepseek-v3-671b": 37_557_787_648}


def to_np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def perturbed_reference_params(arch, dtype="float32", seed=0):
    """(reference cfg, port cfg, reference params, the same tree as float32 numpy)."""
    cj = j_tiny(arch).replace(dtype=dtype, param_dtype=dtype)
    ct = t_tiny(arch).replace(dtype=dtype, param_dtype=dtype)
    params = JModel(cj).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        names = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        is_norm = any(str(n).startswith("ln") or "norm" in str(n) for n in names)
        if is_norm or names[-1] == "b":
            noise = rng.standard_normal(a.shape).astype(np.float32) * 0.1
            return (a.astype(jnp.float32) + noise).astype(a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(perturb, params)
    return cj, ct, params, to_np(params)


def tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def frames(cfg, B, seed=2):
    """(B, encoder_seq, d_model) float32 frame embeddings, or None for a
    decoder-only config."""
    if not cfg.encoder_layers:
        return None
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)


def batch(cfg, toks, seed=2, *, jax_arrays=False):
    """``{"tokens"}`` plus, for an encoder-decoder, ``frame_embeds`` of the
    same batch; as jax arrays for the reference."""
    b = {"tokens": toks}
    fe = frames(cfg, toks.shape[0], seed)
    if fe is not None:
        b["frame_embeds"] = fe
    return {k: jnp.asarray(v) for k, v in b.items()} if jax_arrays else b


def close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32),
                               atol=tol, rtol=tol)


def cache_close(cfg, t_cache, j_cache, tol=TOL):
    want = from_reference_cache(to_np(j_cache), cfg, "cpu", torch.float32)
    assert torch.equal(t_cache["pos"], want["pos"])
    for mine, theirs in zip(t_cache["blocks"], want["blocks"], strict=True):
        assert set(mine) == set(theirs)                   # {k, v}, or MLA's {ckv, kr}
        for name in mine:
            close(mine[name], theirs[name].numpy(), tol)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch):
    cj, ct, pj, pn = perturbed_reference_params(arch)
    pt = from_reference_params(pn, ct, "cpu")
    toks = tokens(cj, 2, 24)
    want, want_aux = JModel(cj).forward(pj, batch(cj, toks, jax_arrays=True))
    got, aux = TModel(ct, "cpu").forward(pt, batch(ct, toks))
    assert got.shape == (2, 24, ct.vocab_size) and got.dtype == torch.float32
    assert aux.shape == () and aux.dtype == torch.float32
    if ct.is_moe:     # the router's load-balancing loss, summed over the layers
        assert float(want_aux) > 0.0
        assert float(aux) == pytest.approx(float(want_aux), rel=TOL, abs=TOL * 1e-3)
    else:
        assert float(aux) == float(want_aux) == 0.0
    close(got, want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_three_decode_steps_match_reference(arch):
    cj, ct, pj, pn = perturbed_reference_params(arch)
    pt = from_reference_params(pn, ct, "cpu")
    B, S, T = 2, 12, 14      # T = 14: the third decode step wraps the ring (pos % T)
    toks = tokens(cj, B, S + 3)
    jm, tm = JModel(cj), TModel(ct, "cpu")
    lj, cache_j = jm.prefill(pj, batch(cj, toks[:, :S], jax_arrays=True), cache_len=T)
    lt, cache_t = tm.prefill(pt, batch(ct, toks[:, :S]), cache_len=T)
    assert lt.shape == (B, 1, ct.vocab_size)
    close(lt, lj)
    cache_close(ct, cache_t, cache_j)
    for i in range(3):
        step = toks[:, S + i:S + i + 1]
        lj, cache_j = jm.decode_step(pj, cache_j, {"tokens": jnp.asarray(step)})
        lt, cache_t = tm.decode_step(pt, cache_t, {"tokens": step})
        close(lt, lj)
        cache_close(ct, cache_t, cache_j)
    assert int(cache_t["pos"][0]) == S + 3


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_from_a_carried_over_cache(arch):
    """State carried across: the reference prefills, the port decodes."""
    cj, ct, pj, pn = perturbed_reference_params(arch, seed=3)
    pt = from_reference_params(pn, ct, "cpu")
    toks = tokens(cj, 2, 9, seed=4)
    jm, tm = JModel(cj), TModel(ct, "cpu")
    _, cache_j = jm.prefill(pj, batch(cj, toks[:, :8], jax_arrays=True), cache_len=16)
    cache_t = from_reference_cache(to_np(cache_j), ct, "cpu")
    lj, _ = jm.decode_step(pj, cache_j, {"tokens": jnp.asarray(toks[:, 8:])})
    lt, _ = tm.decode_step(pt, cache_t, {"tokens": toks[:, 8:]})
    close(lt, lj)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_match_forward_inside_the_port(arch):
    """Twin of test_archs.py::test_prefill_decode_match_forward, in the
    config's own bfloat16 and with the port's own init."""
    cfg = t_tiny(arch)
    if cfg.num_experts:
        # as the twin does: capacity depends on the tokens of a call, so only
        # a capacity no choice exceeds makes the three calls route alike
        cfg = cfg.replace(capacity_factor=float(cfg.num_experts))
    m = TModel(cfg, "cpu")
    params = m.init(torch.Generator().manual_seed(0))
    B, S = 2, 12
    toks = tokens(cfg, B, S + 1)
    lf, _ = m.forward(params, batch(cfg, toks))
    lp, cache = m.prefill(params, batch(cfg, toks[:, :S]), cache_len=S + 4)
    ld, cache2 = m.decode_step(params, cache, {"tokens": toks[:, S:S + 1]})
    tol = 0.08
    assert bool(torch.isfinite(lf).all())
    assert float((lp - lf[:, S - 1:S]).abs().max()) < tol
    assert float((ld - lf[:, S:S + 1]).abs().max()) < tol
    assert int(cache2["pos"][0]) == S + 1
    # the cache is updated in place: the returned tensors are the ones passed in
    for name, t in cache["blocks"][0].items():
        assert cache2["blocks"][0][name] is t


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma-7b"])
def test_bfloat16_forward_matches_reference(arch):
    """The working type: bf16 rounds at other places in the two frameworks,
    hence 5e-2.  gemma also scales its embeddings by sqrt(d_model), rounded
    to bf16 before the product on both sides."""
    cj, ct, pj, pn = perturbed_reference_params(arch, dtype="bfloat16")
    pt = from_reference_params(pn, ct, "cpu")
    assert pt["embed"]["w"].dtype == torch.bfloat16
    toks = tokens(cj, 2, 16)
    want, _ = JModel(cj).forward(pj, {"tokens": jnp.asarray(toks)})
    got, _ = TModel(ct, "cpu").forward(pt, {"tokens": toks})
    close(got, want, 5e-2)


def test_plain_kernels_switch_gives_the_same_numbers_on_cpu():
    _, ct, _, pn = perturbed_reference_params("gemma-7b")
    pt = from_reference_params(pn, ct, "cpu")
    toks = tokens(ct, 2, 10)
    a, _ = TModel(ct, "cpu").forward(pt, {"tokens": toks})
    b, _ = TModel(ct, "cpu", plain_kernels=True).forward(pt, {"tokens": toks})
    close(a, b.numpy(), 1e-5)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_equal_on_full_configs(arch):
    n = t_count(t_config(arch))
    assert n == j_count(j_config(arch))
    assert n == t_config(arch).param_count()
    if arch in FULL_COUNTS:
        assert n == FULL_COUNTS[arch]
    active = t_count(t_config(arch), active_only=True)
    assert active == j_count(j_config(arch), active_only=True)
    assert active == ACTIVE_COUNTS.get(arch, n)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_bytes_equal(arch):
    for cfg_j, cfg_t in ((j_config(arch), t_config(arch)), (j_tiny(arch), t_tiny(arch))):
        assert t_cache_bytes(cfg_t, 8, 2048) == j_cache_bytes(cfg_j, 8, 2048)


def test_from_reference_params_rejects_a_tree_of_another_config():
    _, _, _, pn = perturbed_reference_params("gemma-7b")
    with pytest.raises(ValueError):
        from_reference_params(pn, t_tiny("qwen2.5-32b"), "cpu")     # qwen has biases, other widths


def test_moe_tree_round_trips_and_rejects_other_configs():
    cj, ct, pj, pn = perturbed_reference_params("olmoe-1b-7b")
    pt = from_reference_params(pn, ct, "cpu")
    blk = pt["blocks"][1]["moe"]
    E, D, F = ct.num_experts, ct.d_model, ct.moe_d_ff
    assert blk["router"]["w"].shape == (D, E)
    assert blk["experts"]["gate"].shape == blk["experts"]["up"].shape == (E, D, F)
    assert blk["experts"]["down"].shape == (E, F, D)
    assert np.array_equal(blk["experts"]["down"].numpy(),
                          pn["blocks"]["cycle"][0]["moe"]["experts"]["down"][1])
    back = to_reference_params(pt, ct)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pn)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        from_reference_params(pn, t_tiny("phi4-mini-3.8b"), "cpu")        # a dense config
    with pytest.raises(ValueError):
        from_reference_params(pn, ct.replace(num_experts=4), "cpu")       # other widths
    _, _, _, dense = perturbed_reference_params("phi4-mini-3.8b")
    with pytest.raises(ValueError):
        from_reference_params(dense, ct, "cpu")


def test_cache_of_another_config_is_rejected():
    cj, ct, pj, pn = perturbed_reference_params("olmoe-1b-7b")
    _, cache_j = JModel(cj).prefill(pj, {"tokens": jnp.asarray(tokens(cj, 2, 8))}, cache_len=12)
    np_cache = to_np(cache_j)
    assert from_reference_cache(np_cache, ct, "cpu")["blocks"][0]["k"].shape == (2, 12, 4, 16)
    with pytest.raises(ValueError):
        from_reference_cache(np_cache, ct.replace(num_kv_heads=2), "cpu")


def test_mla_moe_is_left_to_its_own_slice():
    """MLA came with a slice of its own: a MoE config with MLA attention
    builds ``mla_moe`` blocks and their compressed caches.  So did the
    hybrid (RG-LRU): a tiny hybrid config builds its (rec, rec, attn) cycle,
    its recurrent state and its windowed ring.  So did the xLSTM stack: a
    tiny xLSTM builds its (m, m, m, s) cycle and its float32 states.  So did
    the audio family (Whisper): a tiny audio config builds its ``xattn``
    cycle, its encoder tree and its ``{k, v, ck, cv}`` cache.  So did the
    VLM backbone (Qwen2-VL): a tiny VLM config builds its ``attn_ffn``
    cycle with QKV biases and an untied head, and prefills patch embeddings
    at (t, h, w) positions into the dense ``{k, v}`` ring.  A family the
    reference lacks still raises."""
    cfg = t_tiny("olmoe-1b-7b").replace(attention="mla", q_lora_rank=32, kv_lora_rank=16,
                                        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    m = TModel(cfg, "cpu")
    assert m.kinds == ("mla_moe",) * cfg.num_layers
    params = m.init(torch.Generator().manual_seed(0))
    assert params["blocks"][0]["attn"]["uq"]["w"].shape == (32, cfg.num_heads, 24)
    _, cache = m.prefill(params, {"tokens": tokens(cfg, 1, 5)}, cache_len=8)
    assert {k: tuple(v.shape) for k, v in cache["blocks"][0].items()} == {
        "ckv": (1, 8, 16), "kr": (1, 8, 8)}
    hyb = t_tiny("recurrentgemma-9b").replace(num_layers=4, window=6)
    m = TModel(hyb, "cpu")
    assert m.kinds == ("griffin_rec", "griffin_rec", "griffin_attn", "griffin_rec")
    params = m.init(torch.Generator().manual_seed(0))
    W = hyb.lru_width
    assert params["blocks"][0]["rglru"]["wa"].shape == (W, W)
    assert params["blocks"][0]["rglru"]["lam"].dtype == torch.float32
    a = torch.exp(-8.0 * torch.nn.functional.softplus(params["blocks"][0]["rglru"]["lam"]))
    assert 0.9 <= float(a.min()) and float(a.max()) <= 0.999    # Griffin's init of the decay
    _, cache = m.prefill(params, {"tokens": tokens(hyb, 1, 5)}, cache_len=8)
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in cache["blocks"][1:3]] == [
        {"h": (1, W), "conv": (1, hyb.conv_width - 1, W)},
        {"k": (1, 6, 1, hyb.head_dim), "v": (1, 6, 1, hyb.head_dim)}]   # min(cache_len, window)
    xl = t_tiny("xlstm-125m")
    m = TModel(xl, "cpu")
    assert m.kinds == ("mlstm", "mlstm", "mlstm", "slstm")
    params = m.init(torch.Generator().manual_seed(0))
    Di, H, Dh = int(xl.mlstm_proj_factor * xl.d_model), xl.num_heads, xl.head_dim
    assert params["blocks"][0]["q"]["w"].shape == (Di, H * Dh)
    assert params["blocks"][3]["r"].shape == (xl.d_model, 4 * xl.d_model)
    _, cache = m.prefill(params, {"tokens": tokens(xl, 1, 5)}, cache_len=8)
    assert [{k: (tuple(v.shape), v.dtype) for k, v in c.items()} for c in cache["blocks"][2:]] == [
        {"conv": ((1, xl.conv_width - 1, Di), torch.bfloat16),
         "C": ((1, H, Dh, Dh), torch.float32), "n": ((1, H, Dh), torch.float32),
         "m": ((1, H), torch.float32)},
        {k: ((1, xl.d_model), torch.float32) for k in ("c", "n", "h", "m")}]
    wh = t_tiny("whisper-large-v3")
    m = TModel(wh, "cpu")
    assert m.kinds == ("xattn",) * wh.num_layers
    params = m.init(torch.Generator().manual_seed(0))
    D, H, Dh, E = wh.d_model, wh.num_heads, wh.head_dim, wh.encoder_seq
    assert len(params["encoder"]["blocks"]) == wh.encoder_layers
    assert set(params["encoder"]) == {"blocks", "final_norm"}
    assert set(params["encoder"]["final_norm"]) == {"w", "b"}                  # LayerNorm
    assert set(params["encoder"]["blocks"][0]) == {"ln1", "attn", "ln2", "mlp"}
    assert params["encoder"]["blocks"][0]["mlp"]["up"]["b"].shape == (wh.d_ff,)
    assert set(params["blocks"][0]) == {"ln1", "self_attn", "ln2", "cross_attn", "ln3", "mlp"}
    assert params["blocks"][0]["cross_attn"]["k"]["b"].shape == (H, Dh)
    assert params["blocks"][0]["mlp"]["down"]["b"].shape == (D,)
    _, cache = m.prefill(params, {"tokens": tokens(wh, 1, 5), "frame_embeds": frames(wh, 1)},
                         cache_len=8)
    assert [(k, tuple(v.shape)) for k, v in cache["blocks"][0].items()] == [
        ("k", (1, 8, H, Dh)), ("v", (1, 8, H, Dh)), ("ck", (1, E, H, Dh)), ("cv", (1, E, H, Dh))]
    vl = t_tiny("qwen2-vl-7b")
    m = TModel(vl, "cpu")
    assert m.kinds == ("attn_ffn",) * vl.num_layers
    params = m.init(torch.Generator().manual_seed(0))
    assert set(params) == {"embed", "blocks", "final_norm", "lm_head"}      # untied head
    assert params["blocks"][0]["attn"]["q"]["b"].shape == (vl.num_heads, vl.head_dim)
    pe = np.zeros((1, 3, vl.d_model), np.float32)
    pos = np.zeros((1, 5, 3), np.int32)
    _, cache = m.prefill(params, {"tokens": tokens(vl, 1, 5), "positions": pos,
                                  "patch_embeds": pe}, cache_len=8)
    assert [(k, tuple(v.shape)) for k, v in cache["blocks"][0].items()] == [
        ("k", (1, 8, vl.num_kv_heads, vl.head_dim)), ("v", (1, 8, vl.num_kv_heads, vl.head_dim))]
    with pytest.raises(ValueError, match="not ported"):
        TModel(cfg.replace(family="speech"), "cpu")


def test_init_params_shapes_dtypes_and_statistics():
    cfg = t_tiny("qwen2.5-32b")
    params = TModel(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert len(params["blocks"]) == cfg.num_layers
    blk = params["blocks"][0]
    assert blk["attn"]["q"]["w"].shape == (cfg.d_model, cfg.num_heads, cfg.head_dim)
    assert blk["attn"]["q"]["b"].shape == (cfg.num_heads, cfg.head_dim)
    assert blk["attn"]["q"]["w"].dtype == torch.bfloat16
    assert float(blk["attn"]["q"]["b"].abs().max()) == 0.0
    assert float(blk["ln1"]["w"].min()) == 1.0
    std = float(params["embed"]["w"].float().std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    gem = TModel(t_tiny("gemma-7b"), "cpu").init(torch.Generator().manual_seed(0))
    assert float(gem["final_norm"]["w"].abs().max()) == 0.0        # the 1 + w form starts at 0
    assert "lm_head" not in gem and "lm_head" in params


# --------------------------------------------------------------------------
# The residual adds carried into the norms
# --------------------------------------------------------------------------

def _unfused(m, params, tokens, positions, attend, recur=None, cross=None):
    """The block as it reads in the reference: ``h = h + a``, then ``h = h +
    ffn(norm(h))`` (the MoE block's ``moe_ffn``), each add a pass of its own,
    and the norm of ``h``.  ``a`` is the attention (``attend``) or, in an
    RG-LRU block, the recurrent branch (``recur``).  An xLSTM block has one
    add: its branch (``recur``) holds the cell and its projections.  A
    whisper block adds its self attention, its cross attention (``cross``)
    and its FFN, each after its own norm."""
    cfg = m.cfg
    h = m._embed(params, tokens, positions)
    for i, p in enumerate(params["blocks"]):
        x = TL.apply_norm(cfg, p["ln" if "ln" in p else "ln1"], h)
        if "cross_attn" in p:
            h = h + attend(i, p["self_attn"], x)
            h = h + cross(i, p["cross_attn"], TL.apply_norm(cfg, p["ln2"], h))
            h = h + TL.ffn(cfg, p["mlp"], TL.apply_norm(cfg, p["ln3"], h))
            continue
        h = h + (attend(i, p["attn"], x) if "attn" in p else recur(i, p, x))
        if "ln2" not in p:
            continue
        x = TL.apply_norm(cfg, p["ln2"], h)
        h = h + (TL.moe_ffn(cfg, p["moe"], x)[0] if "moe" in p else TL.ffn(cfg, p["mlp"], x))
    return TL.apply_norm(cfg, params["final_norm"], h)


def _xlstm_branch(cfg, kind, p, y, state):
    """An xLSTM block's branch over a sequence (``state`` None) or one
    token; (output, new state)."""
    if kind == "slstm":
        st = None if state is None else tuple(state[k] for k in TM.SLSTM_STATE)
        hs, st = TL.slstm_scan(p, TL.linear(p["gates_in"], y), st)
        return TM._slstm_out(cfg, p, hs, False), dict(zip(TM.SLSTM_STATE, st))
    q, k, v, i_g, f_g, conv = TM._mlstm_in(cfg, p, y, None if state is None else state["conv"])
    if state is None:
        yc, (C, n, m_) = TL.mlstm_chunkwise(q, k, v, i_g, f_g, chunk=cfg.chunk_size)
    else:
        yc, (C, n, m_) = TL.mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_g[:, 0], f_g[:, 0],
                                       (state["C"].clone(), state["n"].clone(),
                                        state["m"].clone()))
        yc = yc[:, None]
    return TM._mlstm_out(cfg, p, y, yc, False), {"conv": conv, "C": C, "n": n, "m": m_}


def _recur_full(cfg, p, y):
    """The RG-LRU block's recurrent branch over a sequence; (output, state)."""
    g = torch.nn.functional.gelu(TL.linear(p["in_gate"], y), approximate="tanh")
    r, conv = TL.causal_conv1d(p["conv"], TL.linear(p["in_rec"], y), None)
    r, h_last = TL.rglru_scan(p["rglru"], r, None)
    return TL.linear(p["out"], g * r), {"h": h_last.to(y.dtype), "conv": conv}


def unfused_encode(m, params, fe):
    """The encoder (whisper) as the reference reads it, each add a pass of its own."""
    cfg = m.cfg
    h = torch.as_tensor(fe).to(torch_dtype(cfg.dtype))
    B, S, _ = h.shape
    positions = torch.arange(S).expand(B, S)
    h = h + TL.sinusoidal_positions(positions, cfg.d_model).to(h.dtype)
    for p in params["encoder"]["blocks"]:
        a, _ = TM.gqa_full(cfg, p["attn"], TL.apply_norm(cfg, p["ln1"], h), positions,
                           causal=False, rope=False)
        h = h + a
        h = h + TL.ffn(cfg, p["mlp"], TL.apply_norm(cfg, p["ln2"], h))
    return TL.apply_norm(cfg, params["encoder"]["final_norm"], h)


def unfused_forward(m, params, toks, cache_len=None, fe=None):
    """Logits (and, with ``cache_len``, the prefill cache) of the unfused
    composition; ``fe`` the frame embeddings of an encoder-decoder."""
    tokens = torch.as_tensor(toks).long()
    B, S = tokens.shape
    positions = torch.arange(S).expand(B, S)
    enc_out = unfused_encode(m, params, fe) if fe is not None else None
    tables = TL.rope_tables(m.cfg, positions, TL.rope_head_dim(m.cfg))
    mla = m.cfg.attention == "mla"
    window = m.cfg.window if m.cfg.family == "hybrid" else 0
    caches = []

    def attend(i, p, x):
        full = TM.mla_full if mla else functools.partial(TM.gqa_full, window=window)
        a, rows = full(m.cfg, p, x, positions, rope_tables=tables)
        if cache_len:
            T = min(cache_len, window) if window else cache_len
            ring = {}
            for name, t in zip(("ckv", "kr") if mla else ("k", "v"), rows):
                ring[name] = torch.zeros((B, T, *t.shape[2:]), dtype=t.dtype)
                ring[name][:, :min(S, T)] = t[:, -T:]
            caches.append(ring)
        return a

    def recur(i, p, y):
        if m.kinds[i] == "griffin_rec":
            out, state = _recur_full(m.cfg, p, y)
        else:
            out, state = _xlstm_branch(m.cfg, m.kinds[i], p, y, None)
        caches.append(state)
        return out

    def cross(i, p, x):
        a, (ck, cv) = TM.cross_full(m.cfg, p, x, enc_out)
        if cache_len:
            caches[-1].update(ck=ck, cv=cv)      # beside the self attention's ring
        return a

    h = _unfused(m, params, tokens, positions, attend, recur, cross)
    return m._logits(params, h), {"blocks": caches, "pos": torch.full((B,), S, dtype=torch.int32)}


def unfused_decode_step(m, params, cache, toks):
    tokens = torch.as_tensor(toks).long()
    pos = cache["pos"]
    positions = pos[:, None]
    tables = TL.rope_tables(m.cfg, positions, TL.rope_head_dim(m.cfg))
    T = cache_len_of(cache)
    indices = TM.decode_indices(pos, T) if T is not None else None
    decode = TM.mla_decode if m.cfg.attention == "mla" else TM.gqa_decode

    def attend(i, p, x):
        return decode(m.cfg, p, x, pos, cache["blocks"][i], positions=positions,
                      rope_tables=tables, indices=indices)[0]

    def recur(i, p, y):
        c = cache["blocks"][i]
        if m.kinds[i] != "griffin_rec":
            out, state = _xlstm_branch(m.cfg, m.kinds[i], p, y, c)
            c.update(state)
            return out
        g = torch.nn.functional.gelu(TL.linear(p["in_gate"], y), approximate="tanh")
        r, conv = TL.causal_conv1d(p["conv"], TL.linear(p["in_rec"], y), c["conv"])
        r_t, h_state = TL.rglru_step(p["rglru"], r[:, 0], c["h"])
        c["h"], c["conv"] = h_state.to(y.dtype), conv
        return TL.linear(p["out"], g * r_t[:, None, :])

    def cross(i, p, x):
        return TM.cross_decode(m.cfg, p, x, cache["blocks"][i])

    h = _unfused(m, params, tokens, positions, attend, recur, cross)
    return m._logits(params, h[:, -1:]), {"blocks": cache["blocks"], "pos": pos + 1}


def caches_equal(a, b):
    assert torch.equal(a["pos"], b["pos"])
    for x, y in zip(a["blocks"], b["blocks"], strict=True):
        assert set(x) == set(y) and all(torch.equal(x[n], y[n]) for n in x)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fused_residual_adds_are_bit_identical_to_the_unfused_block(arch):
    """bf16: ``h + a`` rounds the same whether a pass of its own or inside the
    norm's call, so logits and caches are equal bit for bit."""
    _, ct, _, pn = perturbed_reference_params(arch, dtype="bfloat16")
    pt = from_reference_params(pn, ct, "cpu")
    m = TModel(ct, "cpu")
    B, S, T = 2, 10, 12     # the second decode step wraps the ring
    toks = tokens(ct, B, S + 3)
    fe = frames(ct, B)
    got, _ = m.forward(pt, batch(ct, toks[:, :S]))
    want, _ = unfused_forward(m, pt, toks[:, :S], fe=fe)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    lf, cf = m.prefill(pt, batch(ct, toks[:, :S]), cache_len=T)
    lu, cu = unfused_forward(m, pt, toks[:, :S], cache_len=T, fe=fe)
    assert torch.equal(lf, lu[:, -1:])
    caches_equal(cf, cu)
    for i in range(3):
        step = toks[:, S + i:S + i + 1]
        lf, cf = m.decode_step(pt, cf, {"tokens": step})
        lu, cu = unfused_decode_step(m, pt, cu, step)
        assert torch.equal(lf, lu)
        caches_equal(cf, cu)


class ResidualAdds(TorchFunctionMode):
    """Counts adds of two tensors of one shape ``(B, S, d_model)``: the
    block's residual adds.  Adds inside the norm wrappers are not counted
    (``inside`` > 0 there)."""

    ADDS = {torch.add, torch.Tensor.add, torch.Tensor.__add__, torch.Tensor.__radd__,
            torch.Tensor.add_, torch.Tensor.__iadd__}

    def __init__(self, d_model):
        super().__init__()
        self.d_model, self.adds, self.inside = d_model, 0, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        a = args[:2]
        if (not self.inside and func in self.ADDS and len(a) == 2
                and all(torch.is_tensor(t) and t.ndim == 3 and t.shape[-1] == self.d_model for t in a)
                and a[0].shape == a[1].shape):
            self.adds += 1
        return func(*args, **(kwargs or {}))


def test_decode_step_carries_the_residual_adds_into_the_norms(monkeypatch):
    cfg = t_tiny("phi4-mini-3.8b")
    m = TModel(cfg, "cpu")
    params = m.init(torch.Generator().manual_seed(0))
    toks = tokens(cfg, 2, 9)
    _, cache = m.prefill(params, {"tokens": toks[:, :8]}, cache_len=16)
    _, cache_u = m.prefill(params, {"tokens": toks[:, :8]}, cache_len=16)
    counter = ResidualAdds(cfg.d_model)
    calls = {}
    for name in ("rmsnorm", "rmsnorm_residual", "add_rmsnorm"):
        def counted(*a, _real=getattr(K.ops, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            counter.inside += 1
            try:
                return _real(*a, **kw)
            finally:
                counter.inside -= 1
        monkeypatch.setattr(K.ops, name, counted)
    with counter:
        m.decode_step(params, cache, {"tokens": toks[:, 8:]})
    L = cfg.num_layers
    assert calls == {"rmsnorm": 1, "add_rmsnorm": 2 * L - 1, "rmsnorm_residual": 1}   # 2L + 1
    assert counter.adds == 0                          # no residual add of its own
    unfused = ResidualAdds(cfg.d_model)
    with unfused:                                     # the counter does see them where they are
        unfused_decode_step(m, params, cache_u, toks[:, 8:])
    assert unfused.adds == 2 * L
