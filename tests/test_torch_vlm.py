"""The VLM family (qwen2-vl-7b: the dense ``attn_ffn`` backbone with QKV
bias, M-RoPE over (t, h, w) positions, patch embeddings overlaid on the
first rows) in ``repro_torch`` against the reference, on the CPU.

Every test the reference has for this family feeds positions whose three
sections are equal, where M-RoPE is plain RoPE; the positions here are
distinct: an image of g x g merged patches at the start of the sequence
takes (0, i // g, i % g), and the text after it takes t = h = w, counting on
from one past the image's largest position (Qwen2-VL's layout,
arXiv:2409.12191), built here as input data.

Inputs are made with numpy from a seed and handed to both packages; the
models' weights are the reference's init with numpy noise on every leaf,
carried by ``repro_torch.convert``.  Patch embeddings are drawn times 0.02,
as ``training/data.py`` draws them.  Tolerances:

* float32 2e-6 (absolute and relative) for a function: the products and the
  transcendentals round their last bits in another place;
* bfloat16 2e-2: the two frameworks round bf16 at other places;
* model logits and gradients 1e-4 in float32, as ``tests/test_torch_model.py``
  holds a model: the error grows through the layers; 1e-1 in bfloat16: the
  tiny model's logits reach about 4.8, where one bf16 step is 0.03125, and
  the same backbone with standard RoPE and no patches already differs by
  0.0625-0.080 (two steps and more) on seeds 0-2, so the 5e-2 of
  ``tests/test_torch_model.py``'s bf16 forward (phi4, gemma) does not hold
  for it; 0.1 is about three steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config, get_tiny_config as j_tiny
from repro.core import model_ingest as r_ingest
from repro.models import Model as JModel
from repro.models import layers as JL
from repro.serving.engine import Request as JRequest, ServingEngine as JEngine
from repro.training.data import SyntheticTokenPipeline as JPipe
from repro.training.train_step import make_loss_fn as j_loss
from repro_torch.configs import get_config as t_config, get_tiny_config as t_tiny
from repro_torch.convert import from_reference_cache, from_reference_params
from repro_torch.core import model_ingest as t_ingest
from repro_torch.models import Model as TModel, count_params
from repro_torch.models import layers as TL
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.training import SyntheticTokenPipeline, make_loss_fn
from repro_torch.training.optimizer import tree_leaves

from test_torch_ingest import REST_BYTES, REST_NODES, TOTAL_FLOPS, _core, _rest
from test_torch_simulator import check_report, sims, spec_pair

ARCH = "qwen2-vl-7b"
TOL = {"float32": 2e-6, "bfloat16": 2e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def close(got, want, tol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(jnp.asarray(want, jnp.float32)), atol=tol, rtol=tol)


def mrope_positions(B, S, grid):
    """(B, S, 3) int32: an image of ``grid`` x ``grid`` patches on rows
    0..grid^2-1 at (0, i // grid, i % grid), then text at t = h = w from
    ``grid`` on; row b starts its text b steps later (another prompt)."""
    n = grid * grid
    pos = np.zeros((B, S, 3), np.int32)
    i = np.arange(n)
    pos[:, :n, 1], pos[:, :n, 2] = i // grid, i % grid
    for b in range(B):
        pos[b, n:, :] = (grid + b + np.arange(S - n))[:, None]
    return pos


def patches(cfg, B, N, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, N, cfg.d_model)) * 0.02).astype(np.float32)


def tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


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


# ---------------- M-RoPE ----------------

@pytest.mark.parametrize("head_dim", [128, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mrope_with_distinct_sections_matches_the_reference(dtype, head_dim):
    """Distinct (t, h, w) positions against the reference; standard RoPE on
    the t positions misses by far more than the tolerance, so a port that
    ignored the sections, or read them in another order, fails here."""
    cj, ct = j_config(ARCH), t_config(ARCH)
    rng = np.random.default_rng(3)
    B, S, H = 2, 40, 4
    x = rng.standard_normal((B, S, H, head_dim)).astype(np.float32)
    pos = mrope_positions(B, S, 4)
    want = JL.apply_rope(cj, jnp.asarray(x, J_DT[dtype]), jnp.asarray(pos))
    got = TL.apply_rope(ct, torch.from_numpy(x).to(T_DT[dtype]), torch.from_numpy(pos))
    assert got.dtype == T_DT[dtype] and got.shape == (B, S, H, head_dim)
    close(got, want, TOL[dtype])
    plain = TL.apply_rope(ct.replace(rope_style="standard"), torch.from_numpy(x).to(T_DT[dtype]),
                          torch.from_numpy(pos[..., 0]))
    miss = np.abs(plain.float().numpy() - np.asarray(jnp.asarray(want, jnp.float32))).max()
    assert miss > 5 * TOL[dtype]
    reversed_ = TL.apply_rope(ct, torch.from_numpy(x).to(T_DT[dtype]),
                              torch.from_numpy(np.ascontiguousarray(pos[..., ::-1])))
    miss = np.abs(reversed_.float().numpy() - np.asarray(jnp.asarray(want, jnp.float32))).max()
    assert miss > 5 * TOL[dtype]


def test_mrope_sections_are_qwen2_vls():
    assert torch.bincount(TL.mrope_sections(64, "cpu")).tolist() == [16, 24, 24]
    assert torch.bincount(TL.mrope_sections(12, "cpu")).tolist() == [3, 4, 5]
    sec = TL.mrope_sections(64, "cpu")
    assert torch.equal(sec, torch.sort(sec).values)          # t, then h, then w


def test_mrope_angles_are_the_reference_product_bit_for_bit():
    """The angles are the float32 positions, gathered by section, times the
    reference's frequencies: the reference's ``pos * inv`` bit for bit; the
    tables are their cos and sin in float32."""
    ct = t_config(ARCH)
    pos = mrope_positions(2, 300, 16)
    half = ct.head_dim // 2
    sec = np.array([0] * (half // 4) + [1] * (3 * half // 8) + [2] * (half - half // 4
                                                                       - 3 * half // 8))
    inv = np.asarray(JL._rope_freqs(ct.head_dim, ct.rope_theta))
    want = np.take_along_axis(pos.astype(np.float32),
                              np.broadcast_to(sec, (*pos.shape[:2], half)), -1)[..., None, :] * inv
    assert want.dtype == np.float32
    angles = TL.rope_angles(ct, torch.from_numpy(pos), ct.head_dim)
    assert angles.dtype == torch.float32 and angles.shape == (2, 300, 1, half)
    assert torch.equal(angles, torch.from_numpy(want))
    cos, sin = TL.rope_tables(ct, torch.from_numpy(pos), ct.head_dim)
    assert torch.equal(cos, torch.cos(angles)) and torch.equal(sin, torch.sin(angles))


def test_mrope_of_2d_positions_is_standard_rope_as_in_the_reference():
    """(B, S) positions broadcast to three equal sections: standard RoPE's
    angles, bit for bit, and the reference's rotation."""
    ct = t_config(ARCH)
    pos = np.random.default_rng(4).integers(0, 4000, (3, 17)).astype(np.int32)
    mine = TL.rope_angles(ct, torch.from_numpy(pos), 128)
    std = TL.rope_angles(ct.replace(rope_style="standard"), torch.from_numpy(pos), 128)
    assert torch.equal(mine, std)
    x = np.random.default_rng(5).standard_normal((3, 17, 2, 128)).astype(np.float32)
    close(TL.apply_rope(ct, torch.from_numpy(x), torch.from_numpy(pos)),
          JL.apply_rope(j_config(ARCH), jnp.asarray(x), jnp.asarray(pos)), TOL["float32"])


# ---------------- the patch embeddings ----------------

def test_embed_overlays_the_patches_with_zero_gradient_below_them():
    """Rows 0..N-1 are the patch embeddings in the activation type, the rest
    the tokens' embeddings, as the reference's; the tokens under the patches
    get exactly zero gradient in the embedding table, the others do not."""
    cj, ct, pj, pn = reference_params("bfloat16")
    pt = from_reference_params(pn, ct, "cpu")
    B, S, N = 2, 12, 5
    toks = tokens(ct, B, S)
    toks[:, :N] = np.arange(B * N).reshape(B, N) + 400         # ids found nowhere else
    toks[:, N:] %= 400
    pe = patches(ct, B, N)
    m = TModel(ct, "cpu")
    w = pt["embed"]["w"].detach().requires_grad_()
    h = m._embed({"embed": {"w": w}}, torch.from_numpy(toks).long(),
                 torch.from_numpy(mrope_positions(B, S, 2)), pe)
    assert h.dtype == torch.bfloat16 and h.shape == (B, S, ct.d_model)
    assert torch.equal(h[:, :N], torch.from_numpy(pe).to(torch.bfloat16))
    assert torch.equal(h[:, N:], w[torch.from_numpy(toks[:, N:]).long()].detach())
    want = JModel(cj)._embed(pj, jnp.asarray(toks), jnp.asarray(mrope_positions(B, S, 2)),
                             {"patch_embeds": jnp.asarray(pe)})
    close(h, want, 0.0)
    (g,) = torch.autograd.grad((h.float() * torch.randn(h.shape)).sum(), w)
    under = torch.from_numpy(toks[:, :N]).long().flatten()
    assert torch.count_nonzero(g[under]) == 0
    assert torch.count_nonzero(g[torch.from_numpy(toks[:, N:]).long().flatten()]) > 0
    # decode_step never overlays: patch embeddings in its batch change nothing
    logits = [m.decode_step(pt, m.prefill(pt, {"tokens": toks[:, :4]}, cache_len=8)[1],
                            {"tokens": toks[:, 4:5], **extra})[0]
              for extra in ({}, {"patch_embeds": pe[:, :1]})]
    assert torch.equal(*logits)


def test_more_patches_than_tokens_raise_as_the_reference_fails():
    cj, ct, pj, pn = reference_params()
    pt = from_reference_params(pn, ct, "cpu")
    batch = {"tokens": tokens(ct, 1, 4), "patch_embeds": patches(ct, 1, 6)}
    with pytest.raises(ValueError, match="do not fit"):
        TModel(ct, "cpu").forward(pt, batch)
    with pytest.raises(TypeError):
        JModel(cj).forward(pj, {k: jnp.asarray(v) for k, v in batch.items()})


# ---------------- the model ----------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_model_with_patches_and_3d_positions_matches_the_reference(dtype):
    """forward over 16 tokens with 4 patches; prefill of 12 with 4 patches
    into a ring of 14, then three decode steps at (B, 1, 3) positions that
    continue the text's, the third past the ring's end; logits and caches."""
    cj, ct, pj, pn = reference_params(dtype)
    pt = from_reference_params(pn, ct, "cpu")
    B, S, T, g = 2, 12, 14, 2
    toks, pe = tokens(ct, B, S + 4), patches(ct, B, g * g)
    pos = mrope_positions(B, S + 4, g)
    jm, tm = JModel(cj), TModel(ct, "cpu")
    fwd = {"tokens": toks, "positions": pos, "patch_embeds": pe}
    want, _ = jm.forward(pj, {k: jnp.asarray(v) for k, v in fwd.items()})
    got, aux = tm.forward(pt, fwd)
    assert float(aux) == 0.0
    close(got, want, MODEL_TOL[dtype])
    pre = {"tokens": toks[:, :S], "positions": pos[:, :S], "patch_embeds": pe}
    lj, cache_j = jm.prefill(pj, {k: jnp.asarray(v) for k, v in pre.items()}, cache_len=T)
    lt, cache_t = tm.prefill(pt, pre, cache_len=T)
    close(lt, lj, MODEL_TOL[dtype])
    want_cache = from_reference_cache(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                                                   cache_j), ct, "cpu", torch.float32)
    for mine, theirs in zip(cache_t["blocks"], want_cache["blocks"], strict=True):
        assert list(mine) == list(theirs) == ["k", "v"]
        for name in mine:
            close(mine[name], theirs[name], MODEL_TOL[dtype])
    for i in range(3):
        step = {"tokens": toks[:, S + i:S + i + 1], "positions": pos[:, S + i:S + i + 1]}
        lj, cache_j = jm.decode_step(pj, cache_j, {k: jnp.asarray(v) for k, v in step.items()})
        lt, cache_t = tm.decode_step(pt, cache_t, step)
        close(lt, lj, MODEL_TOL[dtype])
    assert int(cache_t["pos"][0]) == S + 3


def test_decode_writes_the_ring_row_of_cache_pos_not_of_the_rotary_positions():
    """The ring index is ``cache["pos"] % T``, whatever the (t, h, w)
    positions say; both packages write the same row."""
    cj, ct, pj, pn = reference_params()
    pt = from_reference_params(pn, ct, "cpu")
    B, S, T = 2, 6, 8
    toks = tokens(ct, B, S + 1)
    jm, tm = JModel(cj), TModel(ct, "cpu")
    _, cache_j = jm.prefill(pj, {"tokens": jnp.asarray(toks[:, :S])}, cache_len=T)
    _, cache_t = tm.prefill(pt, {"tokens": toks[:, :S]}, cache_len=T)
    before = cache_t["blocks"][0]["k"].clone()
    far = np.full((B, 1, 3), 50, np.int32)
    step = {"tokens": toks[:, S:], "positions": far}
    lj, cache_j = jm.decode_step(pj, cache_j, {k: jnp.asarray(v) for k, v in step.items()})
    lt, cache_t = tm.decode_step(pt, cache_t, step)
    close(lt, lj, MODEL_TOL["float32"])
    changed = (cache_t["blocks"][0]["k"] != before).any(-1).any(-1)        # (B, T)
    assert changed.nonzero()[:, 1].tolist() == [S] * B
    close(cache_t["blocks"][0]["k"], np.asarray(cache_j["blocks"]["cycle"][0]["k"][0]),
          MODEL_TOL["float32"])


def test_loss_and_gradients_with_patches_and_3d_positions_match_the_reference():
    cj, ct, pj, pn = reference_params()
    rng = np.random.default_rng(11)
    B, S, g = 2, 12, 2
    toks = rng.integers(0, ct.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy(),
             "positions": mrope_positions(B, S, g), "patch_embeds": patches(ct, B, g * g)}
    (lj, _), gj = jax.value_and_grad(j_loss(JModel(cj)), has_aux=True)(
        pj, jax.tree.map(jnp.asarray, batch))
    pt = from_reference_params(pn, ct, "cpu")
    for p in tree_leaves(pt):
        p.requires_grad_()
    lt, _ = make_loss_fn(TModel(ct, "cpu", remat_policy="block"))(pt, batch)
    gt = torch.autograd.grad(lt, tree_leaves(pt))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=2e-5, atol=2e-5)
    want = tree_leaves(from_reference_params(jax.tree.map(np.asarray, gj), ct, "cpu"))
    assert len(gt) == len(want)
    for a, b in zip(gt, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=MODEL_TOL["float32"],
                                   atol=MODEL_TOL["float32"])


def test_pipeline_yields_the_references_positions_and_patches():
    kw = dict(global_batch=2, seq_len=300, seed=3, host_id=0, num_hosts=1, start_step=0)
    jp, tp = JPipe(j_tiny(ARCH), **kw), SyntheticTokenPipeline(t_tiny(ARCH), **kw)
    try:
        a, b = next(jp), next(tp)
        assert a["positions"].shape == (2, 300, 3) and a["patch_embeds"].shape == (2, 256, 96)
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(a[k], b[k])
    finally:
        jp.close()
        tp.close()


def test_count_params_is_the_references_exact_count():
    cfg = t_config(ARCH)
    n = count_params(cfg)
    assert n == 7_615_616_512 == cfg.param_count()
    D, H, Hkv, Dh, F, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                           cfg.d_ff, cfg.vocab_size)
    layer = D * (H + 2 * Hkv) * Dh + (H + 2 * Hkv) * Dh + H * Dh * D + 3 * D * F + 2 * D
    assert layer == 233_057_792 and V * D == 544_997_376
    assert n == cfg.num_layers * layer + 2 * V * D + D


# ---------------- serving ----------------

def test_engine_serves_text_only_with_the_reference_engines_tokens():
    """The reference's engine prefills ``{"tokens": prompt}`` alone; so does
    the port's, with 2-D positions (three equal sections)."""
    cj = j_tiny(ARCH).replace(dtype="float32", param_dtype="float32")
    ct = t_tiny(ARCH).replace(dtype="float32", param_dtype="float32")
    pj = JModel(cj).init(jax.random.PRNGKey(0))
    pt = from_reference_params(jax.tree.map(np.asarray, pj), ct, "cpu")
    prompts = [[1, 2, 3, 4, 5], [7, 8], [9, 10, 11]]
    je = JEngine(cj, pj, slots=2, cache_len=8)
    te = ServingEngine(ct, pt, slots=2, cache_len=8, device="cpu")
    for i, p in enumerate(prompts):
        je.submit(JRequest(rid=i, prompt=p, max_new_tokens=5))
        te.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    want = {r.rid: r.tokens for r in je.run_until_drained(max_steps=200)}
    got = {r.rid: r.tokens for r in te.run_until_drained(max_steps=200)}
    assert len(got) == 3 and got == want


# ---------------- the ingest and the simulator at full width ----------------

@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_ingest_traces_the_section_gather_within_the_block_bounds(mode):
    """qwen2-vl-7b at full width: a full-sequence block takes positions
    (B, S, 3) and gathers each frequency's section once, a (B, S, 64)
    float32 gather of no flops; a decode block broadcasts ``pos[:, None]``
    to the sections and gathers (B, 1, 64).  Products and attention are the
    reference's (G 7), the rest within the ``block`` bounds."""
    B, S, cl = {"train": (2, 512, 0), "prefill": (1, 512, 0), "decode": (8, 1, 2048)}[mode]
    r = r_ingest.block_graphs(j_config(ARCH), B, S, mode, cache_len=cl)
    t = t_ingest.block_graphs(t_config(ARCH), B, S, mode, cache_len=cl)
    assert [(b.kind, b.repeat) for b in t.all_blocks()] == [("attn_ffn", 28), ("head", 1)]
    rb, tb = r.blocks[0], t.blocks[0]
    gathers = [n for n in tb.fwd if n.kind == "gather"]
    assert [n.out_shape for n in gathers] == [(B, S, 64)]
    assert gathers[0].flops == 0 and gathers[0].bytes_out == B * S * 64 * 4
    att = [n for n in tb.fwd if n.kind == "attention"]
    assert len(att) == 1 and att[0].attrs["G"] == 7
    assert _core(rb.fwd) == _core(tb.fwd)
    assert tb.fwd.total("flops") == pytest.approx(rb.fwd.total("flops"), rel=TOTAL_FLOPS)
    (rn, rbytes), (tn, tbytes) = _rest(rb.fwd), _rest(tb.fwd)
    assert REST_BYTES["block"][0] <= tbytes / rbytes <= REST_BYTES["block"][1]
    assert REST_NODES[0] <= tn / rn <= REST_NODES[1]


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_simulator_report_matches_the_reference(mode):
    rs, ts = spec_pair(ARCH, mode)
    r_sim, t_sim = sims()
    check_report(ARCH, mode, r_sim.run(rs), t_sim.run(ts))
