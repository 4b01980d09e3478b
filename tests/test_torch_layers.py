"""The port's dense layers against ``repro.models.layers`` on the same numpy
inputs, float32 at 1e-5 (two frameworks' transcendental functions and orders
of summation)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_tiny_config as j_tiny
from repro.models import layers as JL
from repro_torch.configs import get_tiny_config as t_tiny
from repro_torch.models import layers as TL

TOL = 1e-5


def both(a):
    return jnp.asarray(a), torch.from_numpy(np.asarray(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


def f32(cfg):
    return cfg.replace(dtype="float32", param_dtype="float32")


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma-7b", "qwen2.5-32b", "yi-34b",
                                  "qwen2-vl-7b"])
def test_configs_carry_over_field_for_field(arch):
    import dataclasses
    a, b = j_tiny(arch), t_tiny(arch)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    from repro.configs import get_config as j_full
    from repro_torch.configs import get_config as t_full
    assert dataclasses.asdict(j_full(arch)) == dataclasses.asdict(t_full(arch))


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma-7b", "qwen2.5-32b", "yi-34b",
                                  "olmoe-1b-7b", "deepseek-v3-671b", "recurrentgemma-9b",
                                  "qwen2-vl-7b"])
def test_rope_frequencies_are_the_references_bit_for_bit(arch):
    """``1 / theta^(2i/dim)`` at each rotary config's full width: the power
    in float64 rounded once gives XLA's float32 result (torch's float32
    power misses the last bit of one of qwen2-vl's 64 frequencies)."""
    from repro.configs import get_config as j_full
    from repro_torch.configs import get_config as t_full
    cfg = t_full(arch)
    rot = TL._rot_dim(cfg, TL.rope_head_dim(cfg))
    want = np.asarray(JL._rope_freqs(rot, j_full(arch).rope_theta))
    got = TL._rope_freqs(rot, cfg.rope_theta, "cpu")
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch,head_dim", [("yi-34b", 16), ("phi4-mini-3.8b", 16),
                                           ("phi4-mini-3.8b", 128), ("qwen2.5-32b", 64)])
def test_apply_rope_standard_and_partial(arch, head_dim):
    """yi/qwen: standard RoPE (theta 5e6 / 1e6); phi4: partial, 0.75 of the head dim."""
    rng = np.random.default_rng(0)
    xj, xt = both(rng.standard_normal((2, 9, 3, head_dim), dtype=np.float32))
    pos = rng.integers(0, 500, (2, 9)).astype(np.int32)
    want = JL.apply_rope(j_tiny(arch), xj, jnp.asarray(pos))
    got = TL.apply_rope(t_tiny(arch), xt, torch.from_numpy(pos))
    close(got, want, 2e-5 if head_dim > 16 else TOL)   # angles up to 500 rad: cos/sin differ in the last bit
    if arch == "phi4-mini-3.8b":                        # the unrotated quarter passes through untouched
        rot = int(head_dim * 0.75)
        assert torch.equal(got[..., rot:], xt[..., rot:])


@pytest.mark.parametrize("causal,window,valid", [
    (True, 0, None), (True, 5, None), (False, 0, [3, 11]), (False, 0, 7), (True, 4, [11, 6])])
def test_attend_dense(causal, window, valid):
    rng = np.random.default_rng(1)
    B, S, T, Hkv, G, D = 2, (11 if causal else 1), 11, 2, 3, 16
    (qj, qt), (kj, kt), (vj, vt) = (both(rng.standard_normal(s, dtype=np.float32))
                                    for s in ((B, S, Hkv, G, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    vj_len = None if valid is None else jnp.asarray(valid, jnp.int32)
    vt_len = None if valid is None else torch.as_tensor(valid, dtype=torch.int32)
    want = JL.attend_dense(qj, kj, vj, q_offset=0, causal=causal, window=window,
                           kv_valid_len=vj_len)
    got = TL.attend_dense(qt, kt, vt, q_offset=0, causal=causal, window=window,
                          kv_valid_len=vt_len)
    close(got, want)
    # the dispatcher takes the dense path for CPU tensors
    close(TL.attention(qt, kt, vt, causal=causal, window=window, kv_valid_len=vt_len), want)


@pytest.mark.parametrize("causal,valid", [(True, None), (False, [3, 11])])
def test_attention_kernel_strategy_matches_dense(causal, valid):
    """strategy='kernel' on CPU tensors runs the kernels' plain versions
    through the wrappers; same numbers as the dense path."""
    rng = np.random.default_rng(2)
    B, S, T, Hkv, G, D = 2, (11 if causal else 1), 11, 2, 3, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((B, S, Hkv, G, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    vl = None if valid is None else torch.as_tensor(valid, dtype=torch.int32)
    want = TL.attend_dense(q, k, v, q_offset=0, causal=causal, kv_valid_len=vl)
    for plain in (False, True):
        got = TL.attention(q, k, v, causal=causal, kv_valid_len=vl, strategy="kernel", plain=plain)
        close(got, want.numpy())
    with pytest.raises(ValueError):
        TL.attention(q, k, v, causal=causal, kv_valid_len=vl, strategy="kernel", soft_cap=30.0)
    # the blockwise strategy: the same numbers; an unknown strategy raises
    close(TL.attention(q, k, v, causal=causal, kv_valid_len=vl, strategy="blockwise"),
          want.numpy())
    with pytest.raises(ValueError):
        TL.attention(q, k, v, strategy="flash")


@pytest.mark.parametrize("arch,act", [("phi4-mini-3.8b", "swiglu"), ("gemma-7b", "geglu"),
                                      ("yi-34b", "gelu")])
def test_ffn(arch, act):
    rng = np.random.default_rng(3)
    cj, ct = j_tiny(arch).replace(act=act), t_tiny(arch).replace(act=act)
    D, F = cj.d_model, cj.d_ff
    names = ("gate", "up", "down") if act != "gelu" else ("up", "down")
    shapes = {"gate": (D, F), "up": (D, F), "down": (F, D)}
    pj, pt = {}, {}
    for n in names:
        w = rng.standard_normal(shapes[n], dtype=np.float32) / np.sqrt(shapes[n][0])
        pj[n], pt[n] = {"w": jnp.asarray(w)}, {"w": torch.from_numpy(w)}
    xj, xt = both(rng.standard_normal((2, 5, D), dtype=np.float32))
    close(TL.ffn(ct, pt, xt), JL.ffn(cj, pj, xj))


def test_linear_with_bias():
    rng = np.random.default_rng(4)
    (wj, wt), (bj, bt), (xj, xt) = (both(rng.standard_normal(s, dtype=np.float32))
                                    for s in ((8, 6), (6,), (3, 4, 8)))
    close(TL.linear({"w": wt, "b": bt}, xt), JL.linear({"w": wj, "b": bj}, xj))


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma-7b"])     # w and 1 + w
def test_apply_norm_rms_offset_both_ways(arch):
    rng = np.random.default_rng(5)
    cj, ct = j_tiny(arch), t_tiny(arch)
    (wj, wt), (xj, xt) = (both(rng.standard_normal(s, dtype=np.float32))
                          for s in ((cj.d_model,), (2, 7, cj.d_model)))
    assert ct.rms_offset == (arch == "gemma-7b")
    close(TL.apply_norm(ct, {"w": wt}, xt), JL.apply_norm(cj, {"w": wj}, xj))
    close(TL.apply_norm(ct, {"w": wt}, xt, plain=True), JL.apply_norm(cj, {"w": wj}, xj))


def test_apply_norm_layernorm():
    rng = np.random.default_rng(6)
    cj, ct = (c("yi-34b").replace(norm="layernorm", norm_eps=1e-5) for c in (j_tiny, t_tiny))
    (wj, wt), (bj, bt), (xj, xt) = (both(rng.standard_normal(s, dtype=np.float32))
                                    for s in ((64,), (64,), (2, 7, 64)))
    close(TL.apply_norm(ct, {"w": wt, "b": bt}, xt), JL.apply_norm(cj, {"w": wj, "b": bj}, xj))
