"""The plain reference against the port at a small size on the CPU, in
float32: the same weights (the benchmark's), the same logits, and the same
loss and gradients.  Widths are cut to what a test run holds; every other
key is the configuration's own."""
from __future__ import annotations

import pytest
import torch

from chipbench import harness, weights
from chipbench.modes import train as train_mode
from chipbench.traffic import train_batch

SMALL = dict(hidden_size=64, intermediate_size=96, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, num_hidden_layers=2, vocab_size=300)
CONFIGS = ("qwen2.5-32b.l10", "yi-34b")


def small(name: str, **kw) -> dict:
    return dict(harness.config_file(name), **SMALL, **kw)


def reference(cfgj: dict):
    return harness.load_module(harness.HERE / "configs" / f"{cfgj['reference']}.py",
                               "chipbench_reference_test")


def port_model(cfgj: dict):
    from repro_torch.models import Model
    cfg = harness.port_config(cfgj).replace(dtype="float32", param_dtype="float32")
    return Model(cfg, "cpu", plain_kernels=True)


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_take_the_ports_layout(name):
    from repro_torch.models.params import abstract_params
    cfgj = small(name)
    ours = weights.make_params(cfgj, 5, "cpu", chunk=1 << 10)
    theirs = abstract_params(harness.port_config(cfgj))
    flat = lambda t, pre="": ({pre: tuple(t.shape)} if isinstance(t, torch.Tensor) else  # noqa: E731
                              {k: v for i, x in (enumerate(t) if isinstance(t, list) else t.items())
                               for k, v in flat(x, f"{pre}.{i}").items()})
    assert flat(ours) == flat(theirs)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_logits_equal_the_ports_forward(name):
    cfgj = small(name)
    params = weights.make_params(cfgj, 7, "cpu", dtype=torch.float32, chunk=1 << 10)
    toks = train_batch(7, 0, 1, 40, cfgj["vocab_size"])["tokens"]
    with torch.no_grad():
        want, _ = port_model(cfgj).forward(params, {"tokens": toks})
    ref = reference(cfgj).DenseDecoder(cfgj)
    got = ref.logits_at(params, [toks[0].tolist()], [list(range(40))])[0]
    torch.testing.assert_close(got, want[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_training_equals_the_ports_loss_and_gradients(name):
    from repro_torch.training.train_step import make_loss_fn
    from repro_torch.training.optimizer import tree_leaves
    cfgj = small(name)
    params = weights.make_params(cfgj, 9, "cpu", dtype=torch.float32, chunk=1 << 10)
    batch = train_batch(9, 0, 1, 32, cfgj["vocab_size"])
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = make_loss_fn(port_model(cfgj))(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    by_id = {id(g_leaf): g for g_leaf, g in zip(leaves, grads)}
    want = {weights.path_name(path): float(torch.linalg.vector_norm(
        by_id[id(weights.get_leaf(params, path))])) for path, *_ in weights.leaf_specs(cfgj)}
    ref_params = weights.make_params(cfgj, 9, "cpu", dtype=torch.float32, chunk=1 << 10)
    hyper = harness.traffic_file("train_b1_s2048")["adamw"]
    got = reference(cfgj).DenseDecoder(cfgj).train_steps(ref_params, [batch], hyper)
    assert got["losses"][0] == pytest.approx(float(loss.detach()), rel=1e-5)
    assert got["grad_norms"].keys() == want.keys()
    for k in want:
        assert got["grad_norms"][k] == pytest.approx(want[k], rel=1e-4, abs=1e-7), k


def test_reference_adamw_is_the_ports_update():
    """One leaf through the reference's update and the port's plain AdamW."""
    from repro_torch.kernels.adamw import adamw_update_plain
    hyper = harness.traffic_file("train_b1_s2048")["adamw"]
    ref = reference(small("yi-34b")).DenseDecoder
    g = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    p0 = torch.randn(1000, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    p_ref, p_port = p0.clone(), p0.clone()
    m, v = torch.zeros(1000), torch.zeros(1000)
    state: dict = {}
    for step in (1, 2, 3):
        ref._adamw(p_ref, g * step, state, "x", step, hyper)
        lr = torch.tensor(hyper["peak_lr"] * step / hyper["warmup"])
        c1 = torch.tensor(1 - hyper["b1"] ** step)
        c2 = torch.tensor(1 - hyper["b2"] ** step)
        adamw_update_plain(p_port, (g * step).to(torch.bfloat16).float(), m, v, lr=lr, c1=c1, c2=c2,
                           b1=hyper["b1"], b2=hyper["b2"], eps=hyper["eps"],
                           weight_decay=hyper["weight_decay"])
    assert (p_ref.float() - p0.float()).abs().max() > 0
    torch.testing.assert_close(p_ref.float(), p_port.float(), rtol=0, atol=2 ** -7)


def test_change_norms_see_the_first_weights_again(monkeypatch):
    monkeypatch.setattr(weights, "CHUNK", 1 << 10)
    cfgj = small("yi-34b")
    tree = weights.make_params(cfgj, 3, "cpu")
    assert set(train_mode.change_norms(torch, cfgj, 3, "cpu", tree).values()) == {0.0}
    tree["blocks"][1]["mlp"]["up"]["w"].add_(1.0)
    moved = train_mode.change_norms(torch, cfgj, 3, "cpu", tree)
    assert [k for k, v in moved.items() if v > 0] == ["blocks.1.mlp.up.w"]
