"""The RG-LRU family (recurrentgemma-9b: ``griffin_rec`` and ``griffin_attn``
blocks) in ``repro_torch`` against the reference, on the CPU.

Inputs are made with numpy and handed to both packages; the models' weights
are the reference's init with numpy noise on every leaf (the reference
starts the conv filter at 0, which would leave the recurrence untested),
carried by ``repro_torch.convert``.  Tolerances:

* float32 2e-6 (absolute and relative), as ``tests/test_kernels.py``: the
  gate products and the transcendentals (``logaddexp``, ``sigmoid``,
  ``exp``, ``sqrt``) round their last bits in another place; the scan
  itself is the reference's ``associative_scan`` bit for bit;
* bfloat16 2e-2, as ``tests/test_kernels.py``: the two frameworks round bf16
  at other places;
* model logits 1e-4 in float32, as ``tests/test_torch_model.py``: the error
  grows through the layers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as j_tiny
from repro.models import Model as JModel
from repro.models import layers as JL, model as JM
from repro_torch.configs import get_tiny_config as t_tiny
from repro_torch.convert import from_reference_cache, from_reference_params
from repro_torch.models import Model as TModel
from repro_torch.models import layers as TL, model as TM
from repro_torch.models.kvcache import build_cache, cache_len_of

ARCH = "recurrentgemma-9b"
TOL = {"float32": 2e-6, "bfloat16": 2e-2}
MODEL_TOL = 1e-4
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def close(got, want, tol):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(jnp.asarray(want, jnp.float32)), atol=tol, rtol=tol)


def gate_params(rng, W, nb):
    """The RG-LRU's gates as numpy: full (W, W) or block-diagonal (nb, Wb, Wb)."""
    shp = (W, W) if nb == 1 else (nb, W // nb, W // nb)
    p = {k: (rng.standard_normal(shp) / np.sqrt(shp[-1])).astype(np.float32) for k in ("wa", "wx")}
    p.update({k: (rng.standard_normal(W) * 0.5).astype(np.float32) for k in ("ba", "bx")})
    u = rng.uniform(0.9, 0.999, W)
    p["lam"] = np.log(np.expm1(-np.log(u) / 8.0)).astype(np.float32)
    return p


def both(p: dict, dtype: str):
    """numpy leaves -> (reference tree, port tree) in ``dtype``; ``lam`` stays
    float32 in both, as the reference's init makes it."""
    def j(k, v):
        return jnp.asarray(v, jnp.float32 if k == "lam" else J_DT[dtype])

    def t(k, v):
        return torch.from_numpy(v).to(torch.float32 if k == "lam" else T_DT[dtype])

    return {k: j(k, v) for k, v in p.items()}, {k: t(k, v) for k, v in p.items()}


def data(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, J_DT[dtype]), torch.from_numpy(x).to(T_DT[dtype])


# ---------------- the layers ----------------

@pytest.mark.parametrize("S", [1, 2, 3, 7, 16, 33, 512])
def test_associative_scan_is_the_references_bit_for_bit(S):
    """The log-depth scan pairs its products as ``jax.lax.associative_scan``
    does, so the state ``h`` comes out with the reference's bits."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 8)).astype(np.float32)
    b = rng.standard_normal((2, S, 8)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    ja, jh = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ta, th = TL._associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(th.numpy(), np.asarray(jh))
    close(ta, ja, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [1, 2, 7, 16, 33])
def test_rglru_scan_matches_the_reference(S, with_h0, nb, dtype):
    """S odd and even, 1 and a power of two; with and without an initial
    state; both gate layouts (``lru_gate_blocks`` 1 and 2)."""
    rng = np.random.default_rng(100 * S + 10 * nb + with_h0)
    W = 64
    pj, pt = both(gate_params(rng, W, nb), dtype)
    xj, xt = data(rng, (2, S, W), dtype)
    h0 = rng.standard_normal((2, W)).astype(np.float32) if with_h0 else None
    yj, hj = JL.rglru_scan(pj, xj, None if h0 is None else jnp.asarray(h0))
    yt, ht = TL.rglru_scan(pt, xt, None if h0 is None else torch.from_numpy(h0))
    assert yt.dtype == T_DT[dtype] and ht.dtype == torch.float32 and ht.shape == (2, W)
    close(yt, yj, TOL[dtype])
    close(ht, hj, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nb", [1, 2])
def test_rglru_step_matches_the_reference(nb, dtype):
    rng = np.random.default_rng(7 + nb)
    W = 64
    pj, pt = both(gate_params(rng, W, nb), dtype)
    xj, xt = data(rng, (3, W), dtype)
    hj0, ht0 = data(rng, (3, W), dtype)
    yj, hj = JL.rglru_step(pj, xj, hj0)
    yt, ht = TL.rglru_step(pt, xt, ht0)
    assert yt.dtype == T_DT[dtype] and ht.dtype == torch.float32
    close(yt, yj, TOL[dtype])
    close(ht, hj, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 9])
def test_causal_conv1d_matches_the_reference(S, with_state, dtype):
    rng = np.random.default_rng(S + with_state)
    K, W = 4, 32
    pj, pt = both({"w": rng.standard_normal((K, W)).astype(np.float32),
                   "b": rng.standard_normal(W).astype(np.float32)}, dtype)
    xj, xt = data(rng, (2, S, W), dtype)
    sj, st = data(rng, (2, K - 1, W), dtype) if with_state else (None, None)
    yj, cj = JL.causal_conv1d(pj, xj, sj)
    yt, ct = TL.causal_conv1d(pt, xt, st)
    assert yt.dtype == T_DT[dtype] and ct.shape == (2, K - 1, W)
    close(yt, yj, TOL[dtype])
    close(ct, cj, 0.0)              # the state is the last K - 1 inputs, as they were


# ---------------- the blocks and the model ----------------

def reference_params(dtype="float32", seed=0, **replace):
    """(reference cfg, port cfg, reference params, the same as float32
    numpy): the reference's init with numpy noise on every leaf."""
    cj = j_tiny(ARCH).replace(dtype=dtype, param_dtype=dtype, **replace)
    ct = t_tiny(ARCH).replace(dtype=dtype, param_dtype=dtype, **replace)
    params = JModel(cj).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: (a.astype(jnp.float32) + jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32) * 0.05)).astype(a.dtype), params)
    return cj, ct, params, jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)


def tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,layer", [("griffin_rec", 0), ("griffin_attn", 2)])
def test_blocks_match_the_reference_in_full_and_decode_mode(kind, layer, dtype):
    """One block of each kind: a prefill of 12 tokens (its output and its
    cache), then a decode step against that cache.  The port's block returns
    the residual stream and the add it leaves pending; their sum is the
    reference's output."""
    cj, ct, pj, pn = reference_params(dtype)
    pt = from_reference_params(pn, ct, "cpu")["blocks"][layer]
    pjl = jax.tree.map(lambda a: a[layer // len(cj.block_pattern)],
                       pj["blocks"]["cycle"][layer % len(cj.block_pattern)])
    rng = np.random.default_rng(3)
    B, S, T = 2, 12, 16
    hj, ht = data(rng, (B, S, ct.d_model), dtype)
    pos = np.broadcast_to(np.arange(S), (B, S))
    want, cache_j, _ = JM.apply_block_full(cj, kind, pjl, hj, {"positions": jnp.asarray(pos),
                                                               "cache_len": T}, True)
    h, f, cache_t, aux = TM.apply_block_full(ct, kind, pt, ht, None, {
        "positions": torch.from_numpy(pos.copy()), "cache_len": T}, True)
    assert aux is None
    close(h + f, want, TOL[dtype])
    assert set(cache_t) == set(cache_j)
    for name in cache_t:
        close(cache_t[name], cache_j[name], TOL[dtype])
    xj, xt = data(rng, (B, 1, ct.d_model), dtype)
    pos1 = np.full((B,), S, np.int32)
    want, new_j = JM.apply_block_decode(cj, kind, pjl, xj, cache_j, {"pos": jnp.asarray(pos1)})
    h, f, new_t = TM.apply_block_decode(ct, kind, pt, xt, None, cache_t,
                                        {"pos": torch.from_numpy(pos1)})
    assert all(new_t[n] is cache_t[n] for n in cache_t)     # written in place
    close(h + f, want, TOL[dtype])
    for name in new_t:
        close(new_t[name], new_j[name], TOL[dtype])


def test_tiny_model_forward_prefill_and_decode_match_the_reference():
    """Every leaf perturbed (the recurrence carries signal), prefill of 12
    tokens into a ring of 14, then three decode steps, the third past the
    ring's end."""
    cj, ct, pj, pn = reference_params()
    pt = from_reference_params(pn, ct, "cpu")
    toks = tokens(cj, 2, 15)
    jm, tm = JModel(cj), TModel(ct, "cpu")
    want, _ = jm.forward(pj, {"tokens": jnp.asarray(toks)})
    got, _ = tm.forward(pt, {"tokens": toks})
    close(got, want, MODEL_TOL)
    lj, cache_j = jm.prefill(pj, {"tokens": jnp.asarray(toks[:, :12])}, cache_len=14)
    lt, cache_t = tm.prefill(pt, {"tokens": toks[:, :12]}, cache_len=14)
    close(lt, lj, MODEL_TOL)
    for i in range(3):
        step = toks[:, 12 + i:13 + i]
        lj, cache_j = jm.decode_step(pj, cache_j, {"tokens": jnp.asarray(step)})
        lt, cache_t = tm.decode_step(pt, cache_t, {"tokens": step})
        close(lt, lj, MODEL_TOL)
    want = from_reference_cache(jax.tree.map(np.asarray, cache_j), ct, "cpu")
    for mine, theirs in zip(cache_t["blocks"], want["blocks"], strict=True):
        assert set(mine) == set(theirs)
        for name in mine:
            close(mine[name], theirs[name].numpy(), MODEL_TOL)


def test_tiny_model_bfloat16_forward_matches_the_reference():
    """The working type, every leaf perturbed: each package's bf16 logits
    carry their own rounding (measured 0.055 for the reference and 0.067
    for the port from the float32 forward of the same weights, logits up to
    6), so the two are held to each other within 1e-1 and the port to the
    float32 forward within 1.5 times the reference's own error there."""
    cj, ct, pj, pn = reference_params("bfloat16")
    pt = from_reference_params(pn, ct, "cpu")
    assert pt["blocks"][0]["rglru"]["lam"].dtype == torch.float32
    toks = tokens(cj, 2, 16)
    want, _ = JModel(cj).forward(pj, {"tokens": jnp.asarray(toks)})
    got, _ = TModel(ct, "cpu").forward(pt, {"tokens": toks})
    close(got, want, 1e-1)
    c32 = cj.replace(dtype="float32", param_dtype="float32")
    exact, _ = JModel(c32).forward(jax.tree.map(lambda a: a.astype(jnp.float32), pj),
                                   {"tokens": jnp.asarray(toks)})
    exact = np.asarray(exact)
    ref_err = float(np.abs(np.asarray(want, np.float32) - exact).max())
    assert float(np.abs(got.float().numpy() - exact).max()) <= 1.5 * ref_err


def test_train_step_loss_and_gradients_go_through_the_scan():
    """The loss and every gradient (autograd through the log-depth scan, the
    conv and the gates) against ``jax.value_and_grad`` of the reference's
    loss, float32, 2e-5 as ``tests/test_torch_training.py``."""
    from repro.training.train_step import make_loss_fn as j_loss
    from repro_torch.training import make_loss_fn
    from repro_torch.training.optimizer import tree_leaves
    cj, ct, pj, pn = reference_params()
    toks = tokens(cj, 2, 17, seed=5)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    (lj, _), gj = jax.value_and_grad(j_loss(JModel(cj)), has_aux=True)(
        pj, jax.tree.map(jnp.asarray, batch))
    pt = from_reference_params(pn, ct, "cpu")
    for p in tree_leaves(pt):
        p.requires_grad_()
    lt, _ = make_loss_fn(TModel(ct, "cpu"))(pt, batch)
    gt = torch.autograd.grad(lt, tree_leaves(pt))
    np.testing.assert_allclose(float(lt.detach()), float(lj), atol=2e-5, rtol=2e-5)
    want = tree_leaves(from_reference_params(jax.tree.map(np.asarray, gj), ct, "cpu"))
    assert len(gt) == len(want)
    scan_grads = [g for g, p in zip(gt, tree_leaves(pt)) if p.shape == (ct.lru_width,)]
    assert scan_grads and all(float(g.abs().max()) > 0 for g in scan_grads)
    for a, b in zip(gt, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S", [40, 64])
def test_windowed_ring_past_the_window_is_the_references(S):
    """A prompt longer than the window (32; a cache of 48 makes a ring of
    32 rows) keeps its last 32 rows, written from row 0, in both packages.

    This keeps a fault of the reference (ROADMAP queue C): the first decode
    step writes ring slot ``S % T``, which holds position ``S - T + S % T``,
    not the oldest (``S - T``), so with ``S % T != 0`` (S = 40) the ring goes
    on holding one position outside the window and drops one inside it.
    The port does the same, and the two stay equal over three steps."""
    cj, ct, pj, pn = reference_params(window=32)
    pt = from_reference_params(pn, ct, "cpu")
    toks = tokens(cj, 2, S + 3, seed=S)
    jm, tm = JModel(cj), TModel(ct, "cpu")
    lj, cache_j = jm.prefill(pj, {"tokens": jnp.asarray(toks[:, :S])}, cache_len=48)
    lt, cache_t = tm.prefill(pt, {"tokens": toks[:, :S]}, cache_len=48)
    ring = cache_t["blocks"][2]["k"]
    assert ring.shape[1] == cache_len_of(cache_t) == 32
    close(lt, lj, MODEL_TOL)
    for i in range(3):
        step = toks[:, S + i:S + i + 1]
        lj, cache_j = jm.decode_step(pj, cache_j, {"tokens": jnp.asarray(step)})
        lt, cache_t = tm.decode_step(pt, cache_t, {"tokens": step})
        close(lt, lj, MODEL_TOL)
    want = from_reference_cache(jax.tree.map(np.asarray, cache_j), ct, "cpu")
    close(cache_t["blocks"][2]["k"], want["blocks"][2]["k"].numpy(), MODEL_TOL)


def test_cache_len_of_reads_the_attention_ring():
    """recurrentgemma's layer 0 is recurrent: its first leaf ``h`` is (B, W),
    so T comes from the first attention ring; a stack with no ring (the
    xLSTM family's) has no T."""
    ct = t_tiny(ARCH)
    cache = build_cache(ct, lambda s, logical, d: torch.zeros(s, dtype=d), 2, 20)
    assert "h" in cache["blocks"][0] and cache["blocks"][0]["h"].shape == (2, ct.lru_width)
    assert cache_len_of(cache) == 20
    cache = build_cache(ct, lambda s, logical, d: torch.zeros(s, dtype=d), 2, 100)
    assert cache_len_of(cache) == ct.window == 32           # min(cache_len, window)
    rec_only = {"blocks": [b for b in cache["blocks"] if "h" in b], "pos": cache["pos"]}
    assert cache_len_of(rec_only) is None


def test_profiling_engine_takes_the_hybrid_nodes_to_the_kernels():
    """recurrentgemma's decode attention (16 q heads on one kv head, D 256)
    is synthesised for K2, its windowed prefill attention for K1, and the
    RG-LRU's gate products are float32 nodes, timed in float32; on the CPU
    the kernels' plain versions run."""
    from repro_torch.configs import get_config as t_config
    from repro_torch.core import model_ingest as t_ingest
    from repro_torch.core.backend import profiling as P
    cfg = t_config(ARCH)
    dec = t_ingest.block_graphs(cfg, 8, 1, "decode", cache_len=2048)
    assert [b.kind for b in dec.blocks] == ["griffin_rec", "griffin_attn"]
    (node,) = [n for n in dec.blocks[1].fwd if n.kind == "attention"]
    assert node.attrs["G"] == 16 and node.attrs["attn_dims"] == (8, 16, 1, 2048, 256)
    assert 16 in P.SUPPORTED_G
    assert P.synthesize_and_measure(node, device="cpu") > 0
    gates = [n for n in dec.blocks[0].fwd if n.kind == "matmul" and n.dtype == "f32"]
    assert [n.attrs["mm_dims"] for n in gates] == [(8, cfg.lru_width, cfg.lru_width)] * 2
    assert P._DTYPES["f32"] == torch.float32
    pre = t_ingest.block_graphs(cfg, 1, 512, "prefill")
    (node,) = [n for n in pre.blocks[1].fwd if n.kind == "attention"]
    assert node.attrs["window"] == 2048 and node.attrs["G"] == 16
    assert P.synthesize_and_measure(node, device="cpu") > 0
