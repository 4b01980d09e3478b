"""``repro_torch.training`` and ``launch/train.py`` against the reference's
training stack, on the CPU.

Inputs come from numpy (or the reference's init, carried by
``repro_torch.convert``) and go to both packages.  Float32 configs, as the
model parity tests use.  Tolerances:

* loss 2e-5 and gradients 2e-5 (absolute and relative): two frameworks' sums
  of products in another order;
* grad norm 1e-4 relative: a sum of squares of every gradient element;
* parameters after AdamW/Adafactor steps at lr 1e-3: every element but one in
  10,000 within 2e-5, and every element within lr x steps.  AdamW divides by
  sqrt(v) + eps, so a gradient near eps (1e-8; the smallest here are 3e-9)
  turns its last-digit difference into an update difference of about 1e-5;
  under int8 compression a gradient on a rounding boundary of the int8 grid
  lands on the neighbouring level in one framework (2 to 8 of 148k elements
  after three steps), and that element then moves by up to lr a step.
"""
import dataclasses
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as j_tiny
from repro.configs import base as j_base
from repro.core.backend import profiling as r_prof
from repro.models import Model as JModel
from repro.training import optimizer as JO
from repro.training.checkpoint import CheckpointManager as JCkpt
from repro.training.data import SyntheticTokenPipeline as JPipe
from repro.training.train_step import make_loss_fn as j_loss, make_train_step as j_step
from repro_torch.configs import ARCH_IDS, get_tiny_config as t_tiny
from repro_torch.configs import base as t_base
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.convert import from_reference_params, reference_layout, to_reference_params
from repro_torch.core.backend import profiling as t_prof
from repro_torch.core.model_ingest import ingest_graphs
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.training import optimizer as TO
from repro_torch.training import (
    CheckpointManager, ElasticPlan, StepMonitor, SyntheticTokenPipeline, adafactor, adamw,
    cosine_schedule, init_state, int8_compress_decompress, make_loss_fn, make_optimizer,
    make_train_step, maybe_compress, run_with_restarts,
)
from repro_torch.training.optimizer import tree_leaves

TOL = 2e-5
LR, STEPS = 1e-3, 3


def f32(cfg):
    return cfg.replace(dtype="float32", param_dtype="float32")


def reference_params(arch, seed=0):
    """(reference cfg, port cfg, reference params, the same as numpy): the
    reference's init with numpy noise, so norm weights are not all 1."""
    cj, ct = f32(j_tiny(arch)), f32(t_tiny(arch))
    pj = JModel(cj).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    pj = jax.tree.map(lambda a: a + jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)
                                                * 0.05), pj)
    return cj, ct, pj, jax.tree.map(np.asarray, pj)


def token_batch(cfg, B=4, S=16, seed=1):
    """Tokens and next-token labels; for an encoder-decoder (whisper) also
    frame embeddings (B, encoder_seq, d_model) from the same seed, times 0.1."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    if cfg.encoder_layers:
        batch["frame_embeds"] = (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
                                 * 0.1).astype(np.float32)
    return batch


def port_leaves(np_tree, ct, dtype=None):
    """A reference-shaped numpy tree as the port's leaves (in ``dtype``, by
    default the config's parameter dtype)."""
    return tree_leaves(from_reference_params(np_tree, ct, "cpu", dtype))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=tol, rtol=tol)


# ---------------- optimizers: twins of test_training_infra.py ----------------

def test_adamw_matches_manual_first_step():
    lr = lambda step: torch.tensor(0.1)  # noqa: E731
    opt = adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
    p = {"w": torch.tensor([1.0, 2.0])}
    g = {"w": torch.tensor([0.5, -0.5])}
    st = opt.init(p)
    new_p, st = opt.update(g, st, p)
    # bias-corrected first step = -lr * g/|g| elementwise (adam property)
    np.testing.assert_allclose(new_p["w"].numpy(), [1.0 - 0.1, 2.0 + 0.1], rtol=1e-4)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_descends_quadratic(name):
    opt = make_optimizer(name, peak_lr=0.05)
    p = {"w": torch.ones((8, 8))}
    st = opt.init(p)
    loss = lambda p: torch.sum(torch.square(p["w"]))  # noqa: E731
    l0 = float(loss(p))
    for _ in range(60):
        w = p["w"].clone().requires_grad_()
        g = {"w": torch.autograd.grad(loss({"w": w}), w)[0]}
        p, st = opt.update(g, st, p)
    assert float(loss(p)) < l0 * 0.7


def test_adafactor_state_is_factored():
    opt = make_optimizer("adafactor")
    p = {"w": torch.ones((64, 32))}
    st = opt.init(p)
    sizes = sum(int(np.prod(x.shape)) for s in st["f"] for x in s.values())
    assert sizes == 64 + 32  # vr + vc, not 64*32


def test_int8_compression_bounded_error():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    gq = int8_compress_decompress(g)
    assert float((g - gq).abs().max()) <= float(g.abs().max()) / 127 + 1e-6


def test_cosine_schedule_shape():
    lr = cosine_schedule(1.0, warmup=10, total=100)
    assert float(lr(torch.tensor(0))) == 0.0
    assert float(lr(torch.tensor(10))) == pytest.approx(1.0)
    assert float(lr(torch.tensor(100))) == pytest.approx(0.1, rel=1e-2)


def test_cosine_schedule_equals_the_reference():
    for kw in (dict(peak_lr=3e-4), dict(peak_lr=1.0, warmup=10, total=100, final_frac=0.2)):
        jl, tl = JO.cosine_schedule(**kw), cosine_schedule(**kw)
        for step in (0, 1, 5, 10, 57, 100, 999, 20_000):
            assert float(tl(torch.tensor(step))) == pytest.approx(
                float(jl(jnp.asarray(step))), rel=1e-6, abs=1e-12)


def test_int8_compression_equals_the_reference_per_stacked_leaf():
    """One scale per reference leaf: a block parameter's scale comes from all
    its layers, as the reference's stacked array gives it."""
    cj, ct, pj, pn = reference_params("phi4-mini-3.8b")
    rng = np.random.default_rng(5)
    gn = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * rng.uniform(0.01, 3)).astype(
        np.float32), pn)
    want = JO.maybe_compress(jax.tree.map(jnp.asarray, gn), "int8")
    got = maybe_compress(from_reference_params(gn, ct, "cpu"), "int8")
    for a, b in zip(tree_leaves(got), port_leaves(jax.tree.map(np.asarray, want), ct)):
        assert torch.equal(a, b)
    assert maybe_compress(got, "none") is got


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m", "whisper-large-v3",
                                  "deepseek-v3-671b"])
def test_int8_compression_scales_by_the_block_cycle_as_the_reference(arch):
    """The hybrid's and the xLSTM's layers (and whisper's two stacks) take one
    scale per position of the block cycle, bit for bit the reference's."""
    cj, ct, pj, pn = reference_params(arch)
    rng = np.random.default_rng(6)
    gn = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * rng.uniform(0.01, 3)).astype(
        np.float32), pn)
    want = JO.maybe_compress(jax.tree.map(jnp.asarray, gn), "int8")
    got = maybe_compress(from_reference_params(gn, ct, "cpu"), "int8", ct)
    for a, b in zip(tree_leaves(got), port_leaves(jax.tree.map(np.asarray, want), ct)):
        assert torch.equal(a, b)


# ---------------- the loss step of each decoder against the reference ----------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_gradients_match_reference(arch):
    cj, ct, pj, pn = reference_params(arch)
    batch = token_batch(cj)
    (lj, mj), gj = jax.jit(jax.value_and_grad(j_loss(JModel(cj)), has_aux=True))(
        pj, jax.tree.map(jnp.asarray, batch))
    pt = from_reference_params(pn, ct, "cpu")
    for p in tree_leaves(pt):
        p.requires_grad_()
    lt, mt = make_loss_fn(Model(ct, "cpu"))(pt, batch)
    gt = torch.autograd.grad(lt, tree_leaves(pt))
    close(float(lt.detach()), float(lj))
    close(float(mt["tokens"]), float(mj["tokens"]))
    close(float(mt["ce"].detach()), float(mj["ce"]))
    close(float(mt["aux_loss"].detach()), float(mj["aux_loss"]))      # 0 for the dense decoders
    want = port_leaves(jax.tree.map(np.asarray, gj), ct)
    assert len(gt) == len(want)
    for a, b in zip(gt, want):
        close(a.numpy(), b.numpy())


# every (microbatches, compression) pair under each optimizer, spread over the four dense
# configs; then the MoE decoders (GQA and MLA), the RG-LRU hybrid and the xLSTM stack under
# both optimizers and int8 (the hybrid's and the xLSTM's layers are stacked by their block
# cycle's positions, which Adafactor factors and int8 scales by); whisper (its encoder tree
# stacked as the reference's) under both optimizers
STEP_CASES = [
    ("phi4-mini-3.8b", "adamw", 1, "none"), ("phi4-mini-3.8b", "adafactor", 2, "int8"),
    ("gemma-7b", "adamw", 2, "int8"), ("gemma-7b", "adafactor", 1, "none"),
    ("qwen2.5-32b", "adamw", 1, "int8"), ("qwen2.5-32b", "adafactor", 2, "none"),
    ("yi-34b", "adamw", 2, "none"), ("yi-34b", "adafactor", 1, "int8"),
    ("olmoe-1b-7b", "adamw", 1, "none"), ("deepseek-v3-671b", "adamw", 1, "none"),
    ("olmoe-1b-7b", "adafactor", 1, "int8"), ("deepseek-v3-671b", "adafactor", 1, "int8"),
    ("recurrentgemma-9b", "adamw", 1, "none"), ("xlstm-125m", "adamw", 1, "none"),
    ("recurrentgemma-9b", "adafactor", 1, "int8"), ("recurrentgemma-9b", "adafactor", 2, "none"),
    ("xlstm-125m", "adafactor", 1, "int8"),
    ("whisper-large-v3", "adamw", 1, "none"), ("whisper-large-v3", "adafactor", 2, "int8"),
]
# held for one step only: on the same parameters and batch the two frameworks'
# float32 gradients put 6 to 9 of the xLSTM's 236,108 elements on the other side
# of an int8 level (test_int8_levels_differ_only_at_rounding_boundaries), and
# AdamW's early update, near sign(g), turns each into a move of up to lr, which
# the recurrent cells spread: 5 elements off after two steps, 66 after three,
# against the 1e-4 share (23) that the comparison holds.  Adafactor's update,
# clipped over the whole leaf, keeps the same flips within it for three steps.
ONE_STEP_CASES = [("xlstm-125m", "adamw", 2, "int8")]


# whisper's key projections have biases (the reference's ``qkv_bias``), whose
# gradient is 0 in exact arithmetic: the softmax over keys is invariant to the
# score q.b that a key bias adds to every key alike.  What either framework
# computes there is rounding noise (about 1e-9), and AdamW's first steps
# divide it by its own square root, so each element moves by up to lr a step
# with the sign of its noise, and after one step most elements of those leaves
# differ by more than TOL between the packages.  Those leaves are held to the
# lr x steps bound only.
ZERO_GRADIENT_LEAVES = {"whisper-large-v3": ("k", "b")}


def exempt_leaves(arch, tree) -> list[bool]:
    """For each leaf of the port's tree (``tree_leaves`` order), whether it
    ends in the config's zero-gradient leaf name (``ZERO_GRADIENT_LEAVES``)."""
    tail = ZERO_GRADIENT_LEAVES.get(arch)
    out = []

    def walk(t, keys):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], keys + (k,))
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v, keys)
        else:
            out.append(tail is not None and keys[-len(tail):] == tail)
    walk(tree, ())
    return out


def params_close(got, want, *, step, exempt=None):
    exempt = exempt or [False] * len(got)
    err = torch.cat([(a.detach() - b).abs().reshape(-1) for a, b in zip(got, want)])
    held = torch.cat([torch.full((a.numel(),), not e) for a, e in zip(got, exempt)])
    off = (err > TOL) & held
    assert float(off.sum()) <= 1e-4 * err.numel(), f"step {step}: {int(off.sum())} off"
    assert float(err.max()) <= LR * STEPS, f"step {step}: {float(err.max())}"


@pytest.mark.parametrize("arch,opt,microbatches,compression", STEP_CASES,
                         ids=["-".join(map(str, c)) for c in STEP_CASES])
def test_train_steps_match_reference(arch, opt, microbatches, compression):
    steps_match_reference(arch, opt, microbatches, compression, STEPS)


@pytest.mark.parametrize("arch,opt,microbatches,compression", ONE_STEP_CASES,
                         ids=["-".join(map(str, c)) for c in ONE_STEP_CASES])
def test_one_train_step_matches_reference(arch, opt, microbatches, compression):
    # the moments of an element whose int8 level differs differ by (1 - b) of a
    # level: held as params_close holds the parameters, 1e-4 of the elements
    steps_match_reference(arch, opt, microbatches, compression, 1, moments_off_share=1e-4)


def test_int8_levels_differ_only_at_rounding_boundaries():
    """The xLSTM's gradients from the same parameters and batch, int8
    quant-dequantised by each package: a handful of elements (under 1e-4 of
    them) land one level apart, where the float32 gradients of the two
    frameworks straddle a rounding boundary; every other element is the same
    level."""
    cj, ct, pj, pn = reference_params("xlstm-125m")
    batch = token_batch(cj, seed=10)
    _, gj = jax.jit(jax.value_and_grad(j_loss(JModel(cj)), has_aux=True))(
        pj, jax.tree.map(jnp.asarray, batch))
    pt = from_reference_params(pn, ct, "cpu")
    for p in tree_leaves(pt):
        p.requires_grad_()
    loss, _ = make_loss_fn(Model(ct, "cpu"))(pt, batch)
    by_leaf = dict(zip(map(id, tree_leaves(pt)), torch.autograd.grad(loss, tree_leaves(pt))))
    got = tree_leaves(maybe_compress(TO.tree_map(lambda p: by_leaf[id(p)], pt), "int8", ct))
    want = port_leaves(jax.tree.map(np.asarray, JO.maybe_compress(gj, "int8")), ct)
    n = sum(a.numel() for a in got)
    apart = 0
    for a, b in zip(got, want):
        level = float(b.abs().max()) / 127          # the scale of the leaf's group, near enough
        d = (a - b).abs()
        assert float(d.max()) <= 1.01 * level       # at most one level apart
        apart += int((d > 0.25 * level).sum())
    assert 0 < apart <= 1e-4 * n


def steps_match_reference(arch, opt, microbatches, compression, steps, moments_off_share=0.0):
    """``steps`` steps of ``make_train_step`` against the reference's jitted
    step from the same parameters and batches: loss, tokens, grad norm, the
    step counter, every parameter (``params_close``), and AdamW's moments
    (all but ``moments_off_share`` of their elements within 1e-4) or
    Adafactor's state shapes."""
    cj, ct, pj, pn = reference_params(arch)
    jo = getattr(JO, opt)(JO.cosine_schedule(LR, warmup=1))
    to = getattr(TO, opt)(TO.cosine_schedule(LR, warmup=1),
                          **({"cfg": ct} if opt == "adafactor" else {}))
    kw = dict(optimizer=opt, microbatches=microbatches, grad_compression=compression,
              remat_policy="none")
    jstep = jax.jit(j_step(cj, j_base.RunConfig(model=cj, shape=j_base.ShapeConfig(
        "t", 16, 4, "train"), **kw), jo))
    tstep = make_train_step(ct, RunConfig(model=ct, shape=ShapeConfig("t", 16, 4, "train"), **kw),
                            to, "cpu")
    js = {"params": pj, "opt": jo.init(pj), "step": jnp.zeros((), jnp.int32)}
    ts = init_state(from_reference_params(pn, ct, "cpu"), to)
    for i in range(steps):
        batch = token_batch(cj, seed=10 + i)
        js, jm = jstep(js, jax.tree.map(jnp.asarray, batch))
        ts, tm = tstep(ts, batch)
        close(float(tm["loss"]), float(jm["loss"]))
        close(float(tm["tokens"]), float(jm["tokens"]))
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        params_close(tree_leaves(ts["params"]), port_leaves(jax.tree.map(np.asarray,
                                                                          js["params"]), ct),
                     step=i + 1, exempt=exempt_leaves(arch, ts["params"]))
    if opt == "adamw":       # the moments too, in the port's layout
        for name in ("m", "v"):
            want = port_leaves(jax.tree.map(np.asarray, js["opt"][name]), ct, torch.float32)
            if moments_off_share:
                got = tree_leaves(ts["opt"][name])
                off = sum(int(((a - b).abs() > 1e-4 * (1 + b.abs())).sum())
                          for a, b in zip(got, want))
                assert off <= moments_off_share * sum(a.numel() for a in got), (name, off)
                continue
            for a, b in zip(tree_leaves(ts["opt"][name]), want):
                close(a.numpy(), b.numpy(), 1e-4)
    else:                    # Adafactor's state is the reference's flat list
        assert len(ts["opt"]["f"]) == len(js["opt"]["f"])
        for a, b in zip(ts["opt"]["f"], js["opt"]["f"]):
            assert set(a) == set(b)
            for k in a:
                assert tuple(a[k].shape) == b[k].shape


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_adafactor_state_is_the_references_leaf_by_leaf(arch):
    """Adafactor's state for each tiny config: one entry a reference leaf, in
    its order, with the reference's keys, shapes and dtypes (the stacking by
    the config's block cycle: recurrentgemma's (rec, rec, attn) positions and
    tail, xlstm's (m, m, m, s) positions, whisper's decoder and encoder)."""
    cj, ct, pj, pn = reference_params(arch)
    js = JO.adafactor(JO.cosine_schedule(LR))
    ts = TO.adafactor(TO.cosine_schedule(LR), cfg=ct)
    want = js.init(pj)["f"]
    got = ts.init(from_reference_params(pn, ct, "cpu"))["f"]
    assert len(got) == len(want) == len(jax.tree.leaves(pj))
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            assert (tuple(a[k].shape), str(a[k].dtype).split(".")[-1]) == \
                (b[k].shape, str(b[k].dtype))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m"])
def test_groups_need_the_config_where_layers_differ_in_kind(arch):
    """Without the config every layer is one cycle position, which a stack of
    two kinds of layer cannot be: the optimizer raises rather than stack
    the wrong layers together."""
    ct = f32(t_tiny(arch))
    params = Model(ct, "cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="cannot be stacked"):
        TO.adafactor(TO.cosine_schedule(LR)).init(params)
    with pytest.raises(ValueError, match="cannot be stacked"):
        maybe_compress(params, "int8")
    stacked = reference_layout(params, ct, stack=lambda layers: layers[0])   # a leaf a group
    assert len(TO.adafactor(TO.cosine_schedule(LR), cfg=ct).init(params)["f"]) == \
        len(tree_leaves(stacked))
    assert len(tree_leaves(maybe_compress(params, "int8", ct))) == len(tree_leaves(params))


@pytest.mark.parametrize("policy", ["block", "dots"])
def test_remat_policies_give_the_same_loss_and_gradients(policy):
    ct = f32(t_tiny("phi4-mini-3.8b"))
    params = Model(ct, "cpu").init(torch.Generator().manual_seed(0))
    batch = token_batch(ct)
    out = {}
    for p in ("none", policy):
        tree = TO.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
        loss, _ = make_loss_fn(Model(ct, "cpu", remat_policy=p))(tree, batch)
        out[p] = (loss, torch.autograd.grad(loss, tree_leaves(tree)))
    assert torch.equal(out["none"][0], out[policy][0])
    for a, b in zip(out["none"][1], out[policy][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="remat_policy"):
        Model(ct, "cpu", remat_policy="everything")


def test_forward_is_differentiable_and_inference_records_nothing():
    ct = t_tiny("gemma-7b")
    model = Model(ct, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    logits, _ = model.forward(params, token_batch(ct))
    assert not logits.requires_grad                      # no parameter requires grad
    with torch.no_grad():
        cache_logits, _ = model.prefill(params, token_batch(ct), cache_len=32)
    for p in tree_leaves(params):
        p.requires_grad_()
    logits, _ = model.forward(params, token_batch(ct))
    assert logits.requires_grad
    prefill_logits, _ = model.prefill(params, token_batch(ct), cache_len=32)
    assert not prefill_logits.requires_grad               # prefill keeps no_grad
    torch.testing.assert_close(prefill_logits, cache_logits)


# ---------------- configs ----------------

def test_run_and_shape_configs_are_the_reference_fields():
    for cls in ("ShapeConfig", "RunConfig"):
        j = [(f.name, f.default) for f in dataclasses.fields(getattr(j_base, cls))]
        t = [(f.name, f.default) for f in dataclasses.fields(getattr(t_base, cls))]
        assert [n for n, _ in t] == [n for n, _ in j]
        assert [d for _, d in t if d is not dataclasses.MISSING] == \
            [d for _, d in j if d is not dataclasses.MISSING]
    assert {k: dataclasses.astuple(v) for k, v in t_base.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in j_base.SHAPES.items()}
    for arch in ARCH_IDS:
        for name, shape in t_base.SHAPES.items():
            assert t_base.supports_shape(t_tiny(arch), shape) == \
                j_base.supports_shape(j_tiny(arch), j_base.SHAPES[name])


# ---------------- data pipeline ----------------

@pytest.mark.parametrize("arch,seed,host", [("phi4-mini-3.8b", 0, 0), ("gemma-7b", 7, 1),
                                            ("yi-34b", 3, 0)])
def test_pipeline_is_bit_equal_to_the_reference(arch, seed, host):
    kw = dict(global_batch=4, seq_len=12, seed=seed, host_id=host, num_hosts=2, start_step=3)
    jp, tp = JPipe(j_tiny(arch), **kw), SyntheticTokenPipeline(t_tiny(arch), **kw)
    try:
        for _ in range(3):
            a, b = next(jp), next(tp)
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        assert jp.state() == tp.state()
    finally:
        jp.close()
        tp.close()


def test_checkpoint_restart_resumes_stream():
    cfg = t_tiny("qwen2.5-32b")
    pipe = SyntheticTokenPipeline(cfg, global_batch=2, seq_len=8, seed=3)
    b0, b1, b2 = next(pipe), next(pipe), next(pipe)
    pipe.close()
    pipe2 = SyntheticTokenPipeline(cfg, global_batch=2, seq_len=8, seed=3, start_step=2)
    b2b = next(pipe2)
    pipe2.close()
    np.testing.assert_array_equal(b2["tokens"], b2b["tokens"])


# ---------------- checkpoints and fault tolerance: twins of test_training_infra.py ----------------

def test_checkpoint_roundtrip_and_retention(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2)
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "nested": {"b": torch.ones((4,), dtype=torch.bfloat16)},
             "step": torch.tensor(7, dtype=torch.int32)}
    for s in (1, 2, 3):
        ckpt.save(s, state, extra={"data_step": s * 10})
    assert ckpt.all_steps() == [2, 3]  # retention
    target = TO.tree_map(torch.zeros_like, state)
    restored, extra = ckpt.restore(target)
    assert extra["data_step"] == 30
    assert torch.equal(restored["a"], state["a"])
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert int(restored["step"]) == 7


def test_run_with_restarts_recovers(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2)
    calls = []

    def loop(start):
        calls.append(start)
        if len(calls) == 1:
            ckpt.save(4, {"x": torch.ones(())})
            raise RuntimeError("simulated node failure")
        return 10

    assert run_with_restarts(loop, ckpt, max_restarts=2) == 10
    assert calls == [0, 5]  # restarted after the step-4 checkpoint


def test_elastic_plan_rescale():
    plan = ElasticPlan(tp=4, pp=2, dp=8, global_batch=64)
    new = plan.rescale(surviving_chips=48)  # lost 16 of 64
    assert new.tp == 4 and new.pp == 2
    assert new.dp == 6 and new.global_batch == 48


def test_elastic_plan_rescale_batch_accounting():
    plan = ElasticPlan(tp=2, pp=2, dp=4, global_batch=32)
    per_dp = plan.global_batch // plan.dp
    for chips in (16, 12, 8, 5, 3):
        new = plan.rescale(chips)
        assert new.dp == max(chips // 4, 1)
        assert new.global_batch == per_dp * new.dp
        assert new.global_batch % new.dp == 0
    assert plan.rescale(1).dp == 1


def test_step_monitor_stop_before_start_raises():
    mon = StepMonitor()
    with pytest.raises(RuntimeError, match="before start"):
        mon.stop()
    mon.start()
    mon.stop()
    with pytest.raises(RuntimeError, match="before start"):
        mon.stop()


def test_run_with_restarts_budget_resets_on_progress(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=10)
    calls = []

    def loop(start):
        calls.append(start)
        if len(calls) <= 4:
            ckpt.save(len(calls) * 10, {"x": torch.ones(())})
            raise RuntimeError("transient fault")
        return 99

    assert run_with_restarts(loop, ckpt, max_restarts=2) == 99
    assert calls == [0, 11, 21, 31, 41]


def test_run_with_restarts_crash_loop_still_raises(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    calls = []

    def loop(start):
        calls.append(start)
        raise RuntimeError("persistent fault")

    with pytest.raises(RuntimeError, match="persistent"):
        run_with_restarts(loop, ckpt, max_restarts=2)
    assert calls == [0, 0, 0]  # initial try + 2 retries


def test_checkpoint_restore_rejects_dtype_mismatch(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(1, {"w": torch.ones((2, 2), dtype=torch.float32)})
    with pytest.raises(ValueError, match="dtype mismatch"):
        ckpt.restore({"w": torch.zeros((2, 2), dtype=torch.int32)})
    # bf16 target vs float32 on disk is the save-widening round trip, OK
    ckpt.save(2, {"b": torch.ones((3,), dtype=torch.bfloat16)})
    restored, _ = ckpt.restore({"b": torch.zeros((3,), dtype=torch.bfloat16)}, step=2)
    assert restored["b"].dtype == torch.bfloat16


def test_checkpoint_ignores_leftover_tmp_dir(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(3, {"x": torch.ones(())})
    crashed = tmp_path / ".tmp_step_000000007"
    crashed.mkdir()
    (crashed / "arrays.npz").write_bytes(b"garbage")
    assert ckpt.all_steps() == [3]
    assert ckpt.latest_step() == 3
    ckpt.save(7, {"x": torch.full((), 2.0)})   # reuses + replaces the tmp dir
    assert ckpt.all_steps() == [3, 7]
    restored, _ = ckpt.restore({"x": torch.zeros(())}, step=7)
    assert float(restored["x"]) == 2.0


def test_checkpoint_async_wait_ordering(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=10, async_save=True)
    state = {"x": torch.arange(4, dtype=torch.float32)}
    for s in (1, 2, 3):
        ckpt.save(s, {"x": torch.full((4,), float(s))})
    ckpt.wait()
    assert ckpt.all_steps() == [1, 2, 3]
    restored, _ = ckpt.restore(state)
    np.testing.assert_array_equal(restored["x"].numpy(), np.full((4,), 3.0))


def test_checkpoint_restore_onto_a_device_roundtrip(tmp_path):
    """The twin of the reference's resharding restore: the port trains on one
    device, so a restore re-places the arrays on the device it is given."""
    ckpt = CheckpointManager(tmp_path)
    state = {"w": torch.arange(8, dtype=torch.float32).reshape(2, 4)}
    ckpt.save(1, state)
    restored, _ = ckpt.restore(TO.tree_map(torch.zeros_like, state), device="cpu")
    assert torch.equal(restored["w"], state["w"]) and restored["w"].device.type == "cpu"
    restored, _ = ckpt.restore({"w": torch.zeros((2, 4), device="meta")}, device="cpu")
    assert torch.equal(restored["w"], state["w"])


def test_step_monitor_detects_straggler():
    mon = StepMonitor(window=50, z_threshold=2.0)
    for _ in range(12):
        mon.start()
        time.sleep(0.001)
        mon.stop()
    mon.start()
    time.sleep(0.08)
    mon.stop()
    assert mon.stragglers


def _train_states(arch="phi4-mini-3.8b"):
    """The same AdamW state after one step in both packages (bf16 params)."""
    cj, ct = j_tiny(arch), t_tiny(arch)
    pj = JModel(cj).init(jax.random.PRNGKey(2))
    pn = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), pj)
    jo, to = JO.make_optimizer("adamw"), TO.make_optimizer("adamw")
    js = {"params": pj, "opt": jo.init(pj), "step": jnp.zeros((), jnp.int32)}
    js, _ = jax.jit(j_step(cj, j_base.RunConfig(model=cj, shape=j_base.ShapeConfig(
        "t", 8, 2, "train"), remat_policy="none"), jo))(js, jax.tree.map(
            jnp.asarray, token_batch(cj, B=2, S=8)))
    ts = init_state(from_reference_params(pn, ct, "cpu"), to)
    return cj, ct, js, ts


def test_checkpoints_restore_across_the_two_packages(tmp_path):
    """The port writes the reference's keys, layout and dtypes: each package
    restores the other's checkpoint of a train state (bf16 parameters, fp32
    AdamW moments, the step)."""
    cj, ct, js, ts = _train_states()
    JCkpt(tmp_path / "ref").save(5, js, extra={"data_step": 6})
    restored, extra = CheckpointManager(tmp_path / "ref", cfg=ct).restore(ts)
    assert extra == {"data_step": 6} and int(restored["step"]) == 1
    for name, tree in (("params", restored["params"]), ("m", restored["opt"]["m"]),
                       ("v", restored["opt"]["v"])):
        src = js["params"] if name == "params" else js["opt"][name]
        dtype = None if name == "params" else torch.float32
        want = port_leaves(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), src), ct,
                           dtype)
        for a, b in zip(tree_leaves(tree), want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert tree_leaves(restored["params"])[0].dtype == torch.bfloat16

    restored["step"] = restored["step"] + 4
    CheckpointManager(tmp_path / "port", cfg=ct).save(9, restored, extra={"data_step": 10})
    back, extra = JCkpt(tmp_path / "port").restore(jax.tree.map(jnp.zeros_like, js))
    assert extra == {"data_step": 10} and int(back["step"]) == 5
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        if a.ndim:
            assert a.dtype == b.dtype and np.array_equal(np.asarray(a.astype(jnp.float32)),
                                                         np.asarray(b.astype(jnp.float32)))
    ref_np = to_reference_params(restored["params"], ct)
    for a, b in zip(jax.tree.leaves(ref_np), jax.tree.leaves(back["params"])):
        assert np.array_equal(a, np.asarray(b.astype(jnp.float32)))


# ---------------- the trainer ----------------

def test_launch_train_on_the_cpu_takes_steps_and_restores(tmp_path, capsys):
    common = ["--device", "cpu", "--tiny", "--arch", "phi4-mini-3.8b", "--batch", "2",
              "--seq", "16", "--ckpt-every", "2"]
    whole = launch_train.main([*common, "--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    assert [h["step"] for h in whole.history] == [0, 1, 2, 3]
    assert all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in whole.history)
    assert int(whole.state["step"]) == 4
    launch_train.main([*common, "--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    resumed = launch_train.main([*common, "--steps", "4", "--ckpt-dir", str(tmp_path / "b")])
    assert "[restore] resumed at step 2" in capsys.readouterr().out
    assert [h["step"] for h in resumed.history] == [2, 3]
    # the restored run continues the same stream with the same state
    assert [h["loss"] for h in resumed.history] == [h["loss"] for h in whole.history[2:]]
    for a, b in zip(tree_leaves(resumed.state), tree_leaves(whole.state)):
        assert torch.equal(a.detach(), b.detach())
    assert CheckpointManager(tmp_path / "b").all_steps() == [1, 3]


def test_launch_train_checkpoints_nothing_at_ckpt_every_zero(tmp_path):
    t = launch_train.main(["--device", "cpu", "--tiny", "--arch", "gemma-7b", "--steps", "1",
                           "--batch", "2", "--seq", "8", "--ckpt-every", "0", "--remat", "block",
                           "--optimizer", "adafactor", "--microbatches", "2",
                           "--ckpt-dir", str(tmp_path)])
    assert len(t.history) == 1 and CheckpointManager(tmp_path).all_steps() == []


# ---------------- the profiling key of a backward attention node ----------------

def test_backward_attention_node_is_keyed_and_timed_apart_from_the_forward():
    """In the train joint graph every node has phase "bwd", the recomputed
    forward too; the backward operator carries ``attrs["backward"]``, and
    only its key gains ``|bwd`` (the forward's key is the reference's, with
    the group)."""
    ct = t_tiny("phi4-mini-3.8b")
    mg = ingest_graphs(ct, 2, 16, "train", cache_len=16)
    att = [n for n in mg.blocks[0].joint if n.kind == "attention"]
    fwd = [n for n in mg.blocks[0].fwd if n.kind == "attention"]
    assert [n.attrs.get("backward", False) for n in att] == [False, True]
    assert all(n.phase == "bwd" for n in att) and att[1].flops == 2.5 * att[0].flops
    keys = [t_prof.node_key(n, "h100_sxm") for n in att]
    assert keys[0] == t_prof.node_key(fwd[0], "h100_sxm") == \
        r_prof.node_key(fwd[0], "h100_sxm") + f"|G{ct.q_per_kv}"
    assert keys[1] == keys[0] + "|bwd"
    # on the CPU the backward node runs the plain forward and plain backward
    # (the tiny config's head dim of 16 has no kernel: take one of 64)
    from repro_torch import kernels as K
    from repro_torch.core.ir import OpNode
    K.reset_launch_counts()
    for backward in (False, True):
        node = OpNode("a", "attention", dtype="bf16", phase="bwd",
                      attrs={"attn_dims": (1, 6, 16, 16, 64), "G": 3, "causal": True,
                             "window": 0, "backward": backward})
        assert t_prof.synthesize_and_measure(node, device="cpu") > 0
    assert not any(K.launch_counts().values())
