"""``repro_torch.launch.specs`` against ``repro.launch.specs`` for every
architecture and the three kinds of batch.

The stand-ins are meta tensors where the reference has
``jax.ShapeDtypeStruct``s: the keys, shapes and dtypes must be the
reference's.  ``concrete_batch``'s positions are the reference's broadcast
``arange`` bit for bit; the rest is drawn from a ``torch.Generator`` (the
values cannot be JAX's threefry draws), so it is held to its shape, dtype,
range and seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs.base import SHAPES as J_SHAPES
from repro.launch import specs as J
from repro_torch.configs import ARCH_IDS, get_config as t_config
from repro_torch.configs.base import SHAPES as T_SHAPES
from repro_torch.launch import specs as T

KINDS = ("train", "prefill", "decode")
B, S = 2, 300


def layout(specs):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in specs.items()}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_inputs_are_the_references(arch, kind):
    want = J.batch_inputs(j_config(arch), B, S, kind=kind)
    got = T.batch_inputs(t_config(arch), B, S, kind=kind)
    assert list(got) == list(want)
    assert layout(got) == {k: (tuple(v.shape), jnp.dtype(v.dtype).name) for k, v in want.items()}
    assert all(v.device.type == "meta" for v in got.values())


def test_input_specs_follow_the_shape_cells():
    assert T.N_PATCH_STUB == J.N_PATCH_STUB == 256
    for arch in ARCH_IDS:
        for name, shape in T_SHAPES.items():
            got = T.input_specs(t_config(arch), shape)
            want = J.input_specs(j_config(arch), J_SHAPES[name])
            assert layout(got) == {k: (tuple(v.shape), jnp.dtype(v.dtype).name)
                                   for k, v in want.items()}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_concrete_batch_positions_equal_the_references_and_the_rest_is_seeded(arch, kind):
    cfg = t_config(arch)
    want = J.concrete_batch(j_config(arch), B, S, kind=kind, seed=3)
    got = T.concrete_batch(cfg, B, S, kind=kind, seed=3, device="cpu")
    assert layout(got) == {k: (tuple(v.shape), jnp.dtype(v.dtype).name) for k, v in want.items()}
    assert all(v.device.type == "cpu" for v in got.values())
    if "positions" in got:
        assert np.array_equal(got["positions"].numpy(), np.asarray(want["positions"]))
    again = T.concrete_batch(cfg, B, S, kind=kind, seed=3, device="cpu")
    other = T.concrete_batch(cfg, B, S, kind=kind, seed=4, device="cpu")
    for k, v in got.items():
        assert torch.equal(v, again[k])
        if k == "positions":
            assert torch.equal(v, other[k])
            continue
        assert not torch.equal(v, other[k])
        if v.dtype == torch.int32:
            assert 0 <= int(v.min()) and int(v.max()) < cfg.vocab_size
        else:
            assert bool(torch.isfinite(v.float()).all())
            assert 0.01 < float(v.float().std()) < 0.03          # normal x 0.02


def test_concrete_batch_feeds_the_model():
    """A vlm batch of the reference's layout runs the tiny model's forward
    (patches over the first 256 rows, 3-D positions)."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import Model
    cfg = get_tiny_config("qwen2-vl-7b")
    batch = T.concrete_batch(cfg, 1, 260, kind="train", seed=0, device="cpu")
    assert batch["patch_embeds"].shape == (1, 256, cfg.d_model)
    m = Model(cfg, "cpu")
    with torch.no_grad():
        logits, _ = m.forward(m.init(torch.Generator().manual_seed(0)), batch)
    assert logits.shape == (1, 260, cfg.vocab_size) and bool(torch.isfinite(logits).all())


def test_concrete_batch_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert T.concrete_batch(t_config("phi4-mini-3.8b"), 1, 4, kind="decode")[
            "tokens"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.concrete_batch(t_config("phi4-mini-3.8b"), 1, 4, kind="decode")


def test_specs_allocate_nothing():
    specs = T.batch_inputs(t_config("qwen2-vl-7b"), 256, 32768, kind="prefill")
    assert specs["patch_embeds"].shape == (256, 256, 3584)
    assert specs["patch_embeds"].dtype == torch.bfloat16
    assert all(v.device.type == "meta" for v in specs.values())
