"""The main path's three dense decoders at their own head geometry, in
``repro_torch`` against the reference, on the CPU.

The tiny configs of gemma-7b, qwen2.5-32b and yi-34b cut the heads too (4 q
heads on 4 or 2 kv heads of 32 or 16), so no model-level test held the
port's paths at their published groups: gemma-7b's 16 heads of 256 (G 1),
qwen2.5-32b's 40 on 8 (G 5) and yi-34b's 56 on 8 (G 7).  Here each config
keeps its heads, kv heads, head dim, activation, QKV bias, ``rms_offset``,
tying, scaled embedding and ``rope_theta``, and narrows the rest: d_model 64,
d_ff 128, vocab 512, 2 layers, float32.

Weights are the reference's init with numpy noise (on the norms and biases
for the model tests, as ``tests/test_torch_model.py`` draws it; on every leaf
for the train step, as ``tests/test_torch_training.py`` does), carried by
``repro_torch.convert.from_reference_params``.  Tolerances:

* logits 1e-4 (absolute and relative), ``tests/test_torch_model.py``'s
  ``TOL``: the two frameworks sum the products and the softmax in another
  order, and the error grows through the layers;
* the serving engines' greedy tokens equal;
* loss and gradients 2e-5 (absolute and relative), ``tests/test_torch_training.py``'s
  ``TOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.models import Model as JModel
from repro.serving import Request as JRequest, ServingEngine as JEngine
from repro.training.train_step import make_loss_fn as j_loss
from repro_torch.configs import get_config as t_config
from repro_torch.convert import from_reference_params
from repro_torch.models import Model as TModel
from repro_torch.serving import Request, ServingEngine
from repro_torch.training import make_loss_fn
from repro_torch.training.optimizer import tree_leaves

from test_torch_model import TOL, batch, cache_close, close, to_np, tokens
from test_torch_serving import PROMPTS
from test_torch_training import TOL as TRAIN_TOL, token_batch

ARCHS = ("gemma-7b", "qwen2.5-32b", "yi-34b")
# what each config keeps of its published geometry
KEPT = ("num_heads", "num_kv_heads", "head_dim", "act", "qkv_bias", "rms_offset",
        "tie_embeddings", "scale_embedding", "rope_theta")
NARROW = dict(d_model=64, d_ff=128, vocab_size=512, num_layers=2, dtype="float32",
              param_dtype="float32")


def configs(arch):
    """(reference cfg, port cfg): the published config narrowed by ``NARROW``."""
    return j_config(arch).replace(**NARROW), t_config(arch).replace(**NARROW)


def reference_params(arch, seed=0, *, every_leaf=False):
    """(reference cfg, port cfg, reference params, the same tree as float32
    numpy): the reference's init with numpy noise, times 0.1 on the norms and
    biases (the init sets them to exactly 1 or 0), or with ``every_leaf``
    times 0.05 on every leaf."""
    cj, ct = configs(arch)
    params = JModel(cj).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        names = [str(getattr(k, "key", getattr(k, "idx", None))) for k in path]
        is_norm = any(n.startswith("ln") or "norm" in n for n in names)
        if every_leaf or is_norm or names[-1] == "b":
            noise = rng.standard_normal(a.shape).astype(np.float32) * (0.05 if every_leaf else 0.1)
            return (a.astype(jnp.float32) + noise).astype(a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(perturb, params)
    return cj, ct, params, to_np(params)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_narrowed_config_keeps_the_published_geometry(arch):
    cj, ct = configs(arch)
    full = t_config(arch)
    assert {k: getattr(ct, k) for k in KEPT} == {k: getattr(full, k) for k in KEPT}
    assert {k: getattr(ct, k) for k in KEPT} == {k: getattr(cj, k) for k in KEPT}
    group = ct.num_heads // ct.num_kv_heads
    assert (group, ct.head_dim) == {"gemma-7b": (1, 256), "qwen2.5-32b": (5, 128),
                                    "yi-34b": (7, 128)}[arch]
    # the parameter leaves carry the geometry: q projected to H heads of Dh, k and v to
    # Hkv, the QKV bias where the config has one
    pt = TModel(ct, "cpu").init(torch.Generator().manual_seed(0))
    attn = pt["blocks"][0]["attn"]
    H, Hkv, Dh = ct.num_heads, ct.num_kv_heads, ct.head_dim
    assert {n: tuple(attn[n]["w"].shape) for n in "qkvo"} == {
        "q": (64, H, Dh), "k": (64, Hkv, Dh), "v": (64, Hkv, Dh), "o": (H, Dh, 64)}
    assert all(("b" in attn[n]) == ct.qkv_bias for n in "qkv")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_the_reference(arch):
    """Logits of a B2 S24 forward within 1e-4."""
    cj, ct, pj, pn = reference_params(arch)
    pt = from_reference_params(pn, ct, "cpu")
    toks = tokens(cj, 2, 24)
    want, _ = JModel(cj).forward(pj, batch(cj, toks, jax_arrays=True))
    got, _ = TModel(ct, "cpu").forward(pt, batch(ct, toks))
    assert got.shape == (2, 24, ct.vocab_size) and got.dtype == torch.float32
    close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_three_decode_steps_match_the_reference(arch):
    """A B2 S12 prefill into a ring of 14 and three decode steps (the third
    wraps the ring): logits and every cache leaf within 1e-4."""
    cj, ct, pj, pn = reference_params(arch)
    pt = from_reference_params(pn, ct, "cpu")
    B, S, T = 2, 12, 14
    toks = tokens(cj, B, S + 3)
    jm, tm = JModel(cj), TModel(ct, "cpu")
    lj, cache_j = jm.prefill(pj, batch(cj, toks[:, :S], jax_arrays=True), cache_len=T)
    lt, cache_t = tm.prefill(pt, batch(ct, toks[:, :S]), cache_len=T)
    close(lt, lj)
    cache_close(ct, cache_t, cache_j)
    for i in range(3):
        step = toks[:, S + i:S + i + 1]
        lj, cache_j = jm.decode_step(pj, cache_j, {"tokens": jnp.asarray(step)})
        lt, cache_t = tm.decode_step(pt, cache_t, {"tokens": step})
        close(lt, lj)
        cache_close(ct, cache_t, cache_j)
    assert int(cache_t["pos"][0]) == S + 3


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cache_len", [64, 8])      # 8: positions reach 9, so pos % T wraps
def test_engine_tokens_equal_the_reference_engine(arch, cache_len):
    """Three requests over two slots, five greedy tokens each: the same tokens
    and the same slots as the reference's engine."""
    cj, ct, pj, pn = reference_params(arch)
    pt = from_reference_params(pn, ct, "cpu")
    je = JEngine(cj, pj, slots=2, cache_len=cache_len)
    te = ServingEngine(ct, pt, slots=2, cache_len=cache_len, device="cpu")
    for i, p in enumerate(PROMPTS):
        je.submit(JRequest(rid=i, prompt=p, max_new_tokens=5))
        te.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    want = {r.rid: r.tokens for r in je.run_until_drained(max_steps=200)}
    got = {r.rid: r.tokens for r in te.run_until_drained(max_steps=200)}
    assert len(got) == 3 and all(len(t) == 5 for t in got.values())
    assert got == want
    assert [r.slot for r in sorted(te.finished, key=lambda r: r.rid)] == \
           [r.slot for r in sorted(je.finished, key=lambda r: r.rid)]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_the_reference(arch):
    """The train step's loss (and its cross-entropy) and every gradient leaf
    (qwen2.5-32b's QKV biases among them) of a B4 S16 batch within 2e-5."""
    cj, ct, pj, pn = reference_params(arch, every_leaf=True)
    data = token_batch(cj)
    (lj, mj), gj = jax.jit(jax.value_and_grad(j_loss(JModel(cj)), has_aux=True))(
        pj, jax.tree.map(jnp.asarray, data))
    pt = from_reference_params(pn, ct, "cpu")
    leaves = tree_leaves(pt)
    for p in leaves:
        p.requires_grad_()
    lt, mt = make_loss_fn(TModel(ct, "cpu"))(pt, data)
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(float(lt.detach()), float(lj), atol=TRAIN_TOL, rtol=TRAIN_TOL)
    np.testing.assert_allclose(float(mt["ce"].detach()), float(mj["ce"]), atol=TRAIN_TOL,
                               rtol=TRAIN_TOL)
    want = tree_leaves(from_reference_params(jax.tree.map(np.asarray, gj), ct, "cpu"))
    assert len(gt) == len(want)
    biases = {id(blk["attn"][n]["b"]) for blk in pt["blocks"] for n in "qkv" if ct.qkv_bias}
    assert sum(id(p) in biases for p in leaves) == 3 * ct.num_layers * ct.qkv_bias
    for a, b in zip(gt, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TRAIN_TOL, rtol=TRAIN_TOL)
