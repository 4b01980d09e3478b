"""The port's kernel wrappers on the CPU (where they take their plain
versions) against the reference's Pallas kernels in interpret mode and
against both packages' oracles.  Inputs come from numpy and go to both sides.

Tolerances: float32 at 1e-5 — two frameworks' ``exp`` and orders of summation
(the reference's own 2e-6 holds inside one framework); bfloat16 at 2e-2, as in
``tests/test_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro.models import layers as JL
from repro_torch import kernels as K
from repro_torch.kernels import _build, ops, ref

F32, BF16 = "float32", "bfloat16"
TOL = {F32: 1e-5, BF16: 2e-2}
# the plain decode at the split floor's plans against the reference's kernel: float32 at the
# reference's own 2e-6 (both split and combine in float32, over a few splits)
DEC_SPLIT_TOL = {F32: 2e-6, BF16: 2e-2}
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}
TDT = {F32: torch.float32, BF16: torch.bfloat16}


def both(a: np.ndarray, dtype: str):
    """One numpy array as (jax array, torch tensor) of ``dtype``."""
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def j2n(x) -> np.ndarray:
    return np.asarray(x.astype(jnp.float32))


def t2n(x) -> np.ndarray:
    return x.float().numpy()


def close(got, want, tol):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


FA_CASES = [
    # (B, H, Hkv, Sq, Sk, D, causal, window, dtype) — the cases of tests/test_kernels.py
    (1, 2, 2, 128, 128, 64, True, 0, F32),
    (2, 4, 2, 192, 192, 64, True, 0, F32),   # GQA + ragged blocks
    (1, 4, 1, 128, 256, 32, False, 0, F32),  # MQA cross
    (2, 2, 2, 160, 160, 64, True, 64, F32),  # sliding window
    (1, 2, 2, 128, 128, 128, True, 0, BF16),
    (1, 8, 4, 96, 96, 64, True, 0, BF16),
    (1, 6, 2, 80, 80, 128, True, 0, F32),    # G = 3, the group of phi4-mini
    (1, 16, 1, 160, 160, 256, True, 64, BF16),   # G = 16 at D 256 with a window (recurrentgemma)
]


def _fa_inputs(case, seed=0):
    B, H, Hkv, Sq, Sk, D, causal, window, dtype = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32)
    return [both(a, dtype) for a in (q, k, v)]


@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_vs_pallas(case):
    *_, causal, window, dtype = case
    (qj, qt), (kj, kt), (vj, vt) = _fa_inputs(case)
    want = jops.flash_attention(qj, kj, vj, causal=causal, window=window)
    before = K.flash_attention.launches
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert K.flash_attention.launches == before      # CPU tensor: plain version, no launch
    assert got.dtype == TDT[dtype] and got.shape == qt.shape
    close(t2n(got), j2n(want), TOL[dtype])


@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_vs_oracles(case):
    *_, causal, window, dtype = case
    (qj, qt), (kj, kt), (vj, vt) = _fa_inputs(case, seed=1)
    got = K.flash_attention_plain(qt, kt, vt, causal=causal, window=window)
    mine = ref.flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    theirs = jref.flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    close(t2n(got), t2n(mine), TOL[dtype])
    close(t2n(mine), j2n(theirs), TOL[dtype])


DEC_CASES = [
    # (B, H, Hkv, T, D, dtype) — the cases of tests/test_kernels.py
    (2, 4, 2, 256, 64, F32),
    (1, 8, 1, 300, 64, F32),   # MQA, ragged splits
    (2, 4, 4, 512, 128, BF16),
    (2, 6, 2, 300, 128, F32),  # G = 3
    (2, 10, 2, 384, 64, F32),  # G = 5, the group of qwen2.5-32b
    (2, 14, 2, 320, 128, BF16),  # G = 7, the group of yi-34b
]


def _dec_inputs(case, seed=1):
    B, H, Hkv, T, D, dtype = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, T, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, T, D), dtype=np.float32)
    vl = np.asarray([T // 2, T][:B], np.int32)
    return [both(a, dtype) for a in (q, k, v)], (jnp.asarray(vl), torch.from_numpy(vl))


@pytest.mark.parametrize("case", DEC_CASES)
def test_decode_attention_vs_pallas(case):
    dtype = case[-1]
    ((qj, qt), (kj, kt), (vj, vt)), (vlj, vlt) = _dec_inputs(case)
    want = jops.decode_attention(qj, kj, vj, vlj)
    before = K.decode_attention.launches
    got = ops.decode_attention(qt, kt, vt, vlt)
    assert K.decode_attention.launches == before     # CPU tensor: plain version, no launch
    assert got.dtype == TDT[dtype] and got.shape == qt.shape
    close(t2n(got), j2n(want), TOL[dtype])


@pytest.mark.parametrize("case", DEC_CASES)
def test_decode_attention_vs_oracles(case):
    dtype = case[-1]
    ((qj, qt), (kj, kt), (vj, vt)), (vlj, vlt) = _dec_inputs(case, seed=2)
    mine = ref.decode_attention_ref(qt, kt, vt, kv_valid_len=vlt)
    theirs = jref.decode_attention_ref(qj, kj, vj, kv_valid_len=vlj)
    close(t2n(mine), j2n(theirs), TOL[dtype])
    for n_splits in (None, 1, 3):       # the split-and-combine arithmetic at several cuts
        got = K.decode_attention_plain(qt, kt, vt, kv_valid_len=vlt, n_splits=n_splits)
        close(t2n(got), t2n(mine), TOL[dtype])


@pytest.mark.parametrize("case", DEC_CASES[:2])
def test_decode_attention_bthd_reads_the_model_layout(case):
    B, H, Hkv, T, D, dtype = case
    ((_, qt), (_, kt), (_, vt)), (_, vlt) = _dec_inputs(case, seed=3)
    want = ops.decode_attention(qt, kt, vt, vlt)
    got = ops.decode_attention_bthd(qt.reshape(B, 1, Hkv, H // Hkv, D),
                                    kt.permute(0, 2, 1, 3).contiguous(),
                                    vt.permute(0, 2, 1, 3).contiguous(), vlt)
    close(t2n(got.reshape(B, H, D)), t2n(want), 1e-6)    # another layout, another order of summation


def test_combine_splits_matches_reference_combine():
    rng = np.random.default_rng(4)
    o = rng.standard_normal((2, 3, 5, 4, 16), dtype=np.float32)
    m = rng.standard_normal((2, 3, 5, 4), dtype=np.float32) * 3
    l = np.abs(rng.standard_normal((2, 3, 5, 4), dtype=np.float32)) + 0.1
    got = K.combine_splits_plain(*(torch.from_numpy(a) for a in (o, m, l)), torch.float32)
    # the reference's combine, repro/kernels/decode_attention.py, in numpy
    w = l * np.exp(m - m.max(axis=2, keepdims=True))
    want = (o * w[..., None]).sum(axis=2) / np.maximum(w.sum(axis=2), 1e-30)[..., None]
    close(t2n(got), want.reshape(2, 12, 16), 1e-5)


RMS_GRID = [(rows, d, offset, F32) for rows in (1, 37, 300) for d in (128, 256, 512)
            for offset in (False, True)]
RMS_GRID += [(rows, 256, offset, BF16) for rows in (1, 37, 300) for offset in (False, True)]


@pytest.mark.parametrize("rows,d,offset,dtype", RMS_GRID)
def test_rmsnorm_vs_pallas_and_oracles(rows, d, offset, dtype):
    rng = np.random.default_rng(rows * 1000 + d)
    xj, xt = both(rng.standard_normal((rows, d), dtype=np.float32), dtype)
    # w stays float32 beside a bfloat16 x, as in the reference's test
    wj, wt = both(rng.standard_normal((d,), dtype=np.float32) * 0.1 + 1.0, F32)
    before = K.rmsnorm.launches
    got = ops.rmsnorm(xt, wt, offset=offset)
    assert K.rmsnorm.launches == before
    assert got.dtype == TDT[dtype]
    tol = 3e-2 if dtype == BF16 else TOL[F32]        # bf16 as in tests/test_kernels.py
    close(t2n(got), j2n(jops.rmsnorm(xj, wj, offset=offset)), tol)
    close(t2n(got), t2n(ref.rmsnorm_ref(xt, wt, offset=offset)), tol)
    close(t2n(ref.rmsnorm_ref(xt, wt, offset=offset)),
          j2n(jref.rmsnorm_ref(xj, wj, offset=offset)), tol)


@pytest.mark.parametrize("dtype,offset", [(F32, False), (F32, True), (BF16, False)])
def test_rmsnorm_residual_vs_pallas(dtype, offset):
    rng = np.random.default_rng(5)
    xj, xt = both(rng.standard_normal((4, 10, 256), dtype=np.float32), dtype)
    rj, rt = both(rng.standard_normal((4, 10, 256), dtype=np.float32), dtype)
    wj, wt = both(rng.standard_normal((256,), dtype=np.float32) * 0.1 + 1.0, F32)
    got = ops.rmsnorm_residual(xt, rt, wt, offset=offset)
    tol = 3e-2 if dtype == BF16 else TOL[F32]
    close(t2n(got), j2n(jops.rmsnorm_residual(xj, rj, wj, offset=offset)), tol)
    close(t2n(got), t2n(ref.rmsnorm_ref(xt, wt, offset=offset, residual=rt)), tol)


ADD_RMS_GRID = [(rows, d, x_dt, w_dt, offset)
                for rows in (1, 37, 300) for d in (100, 256)
                for x_dt, w_dt in ((F32, F32), (BF16, F32), (BF16, BF16))
                for offset in (False, True)]


@pytest.mark.parametrize("rows,d,x_dt,w_dt,offset", ADD_RMS_GRID)
def test_add_rmsnorm_vs_jax_sum_and_pallas(rows, d, x_dt, w_dt, offset):
    """The sum is the reference's ``x + r`` bit for bit (one rounding to x's
    type); the norm agrees with the Pallas kernel's residual form.  D = 100
    is no multiple of the kernel's 16-byte vector; w may be fp32 beside a
    bf16 x."""
    rng = np.random.default_rng(rows * 7 + d)
    xj, xt = both(rng.standard_normal((rows, d), dtype=np.float32), x_dt)
    rj, rt = both(rng.standard_normal((rows, d), dtype=np.float32), x_dt)
    wj, wt = both(rng.standard_normal((d,), dtype=np.float32) * 0.1 + (0.0 if offset else 1.0),
                  w_dt)
    before = K.rmsnorm.launches
    s, y = ops.add_rmsnorm(xt, rt, wt, offset=offset)
    assert K.rmsnorm.launches == before               # CPU tensor: plain version, no launch
    assert s.dtype == y.dtype == TDT[x_dt] and s.shape == y.shape == xt.shape
    np.testing.assert_array_equal(t2n(s), j2n(xj + rj))
    tol = 3e-2 if x_dt == BF16 else TOL[F32]         # as test_rmsnorm_residual_vs_pallas
    close(t2n(y), j2n(jops.rmsnorm_residual(xj, rj, wj, offset=offset)), tol)
    assert torch.equal(y, ops.rmsnorm_residual(xt, rt, wt, offset=offset))
    s2, y2 = K.add_rmsnorm_plain(xt, rt, wt, offset=offset)
    assert torch.equal(s, s2) and torch.equal(y, y2)


def test_add_rmsnorm_raises_where_it_has_no_kernel():
    x, w = torch.ones((4, 64), dtype=torch.float16), torch.ones((64,))
    with pytest.raises(TypeError):
        K.add_rmsnorm(x, x, w)
    m = torch.ones((4, 64), device="meta")
    with pytest.raises(RuntimeError):
        K.add_rmsnorm(m, m, torch.ones((64,), device="meta"))


def test_flash_bshd_matches_reference_model_layout():
    """The bshd wrapper agrees with the reference model's blockwise attention
    (twin of test_flash_matches_model_layout)."""
    B, S, Hkv, G, D = 2, 128, 2, 2, 64
    rng = np.random.default_rng(6)
    (qj, qt), (kj, kt), (vj, vt) = (both(rng.standard_normal(s, dtype=np.float32), F32)
                                    for s in ((B, S, Hkv, G, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    got = ops.flash_attention_bshd(qt, kt, vt, causal=True)
    want = JL.attend_blockwise(qj, kj, vj, q_offset=0, causal=True, q_block=64, kv_block=64)
    assert got.shape == (B, S, Hkv, G, D)
    close(t2n(got), j2n(want), 2e-5)
    close(t2n(got), j2n(jops.flash_attention_bshd(qj, kj, vj, causal=True)), 1e-5)


def test_fully_masked_row_follows_the_kernels_not_the_oracle():
    """kv_valid_len = 0: the kernels give 0, ``ref.py`` (in both packages) the
    mean of V.  The plain versions follow the kernels."""
    rng = np.random.default_rng(7)
    B, H, Hkv, T, D = 2, 4, 2, 128, 64
    (qj, qt), (kj, kt), (vj, vt) = (both(rng.standard_normal(s, dtype=np.float32), F32)
                                    for s in ((B, H, D), (B, Hkv, T, D), (B, Hkv, T, D)))
    vl = np.asarray([0, T], np.int32)
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(vl))
    pallas = jops.decode_attention(qj, kj, vj, jnp.asarray(vl))
    assert float(got[0].abs().max()) == 0.0
    assert float(jnp.abs(pallas[0]).max()) == 0.0
    close(t2n(got), j2n(pallas), 1e-5)
    oracle = ref.decode_attention_ref(qt, kt, vt, kv_valid_len=torch.from_numpy(vl))
    mean_v = vt.mean(dim=2).repeat_interleave(H // Hkv, dim=1)
    close(t2n(oracle[0]), t2n(mean_v[0]), 1e-5)
    close(t2n(oracle), j2n(jref.decode_attention_ref(qj, kj, vj, kv_valid_len=jnp.asarray(vl))), 1e-5)


def test_flash_rows_without_a_visible_key_give_zero():
    """A window with no causal mask leaves late q rows no key at all."""
    rng = np.random.default_rng(8)
    (qj, qt), (kj, kt), (vj, vt) = (both(rng.standard_normal(s, dtype=np.float32), F32)
                                    for s in ((1, 2, 40, 64), (1, 2, 8, 64), (1, 2, 8, 64)))
    got = ops.flash_attention(qt, kt, vt, causal=False, window=4)
    want = jops.flash_attention(qj, kj, vj, causal=False, window=4)
    close(t2n(got), j2n(want), 1e-5)
    assert float(got[:, :, 12:].abs().max()) == 0.0     # q_pos >= Sk + window - 1


@pytest.mark.parametrize("bad", [torch.float16, torch.float64, torch.int32])
def test_wrappers_raise_on_unsupported_dtype(bad):
    x = torch.ones((4, 64)).to(bad)
    w = torch.ones((64,))
    with pytest.raises(TypeError):
        K.rmsnorm(x, w)
    q = torch.ones((1, 2, 8, 64)).to(bad)
    with pytest.raises(TypeError):
        K.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        K.decode_attention(q[:, :, 0], q, q)
    with pytest.raises(TypeError):
        _build.dtype_code(x, "x")


def test_wrappers_raise_on_a_device_without_a_kernel():
    x = torch.ones((4, 64), device="meta")
    with pytest.raises(RuntimeError):
        K.rmsnorm(x, torch.ones((64,), device="meta"))
    q = torch.ones((1, 2, 8, 64), device="meta")
    with pytest.raises(RuntimeError):
        K.flash_attention(q, q, q)
    with pytest.raises(RuntimeError):
        K.decode_attention(q[:, :, 0], q, q)


def test_split_plan_covers_the_cache():
    from repro_torch.kernels.decode_attention import SPLIT_FLOOR, split_plan
    for B, Hkv, T in [(8, 8, 2048), (1, 1, 300), (1, 8, 64), (32, 8, 2048), (2, 2, 1),
                      (1, 1, 2048), (8, 1, 2048)]:
        ns, chunk = split_plan(B, Hkv, T)
        assert ns >= 1 and (ns - 1) * chunk < T <= ns * chunk
        assert ns == 1 or chunk >= SPLIT_FLOOR
    assert split_plan(8, 8, 2048)[0] == 8              # 8*8*8 = 512 blocks <= 4 * 132
    assert split_plan(1, 1, 300)[0] == 2               # no split under the floor of 128 rows
    assert split_plan(1, 1, 2048) == (16, 128)         # one sequence: the floor, not the card


DEC_SPLIT_CASES = [
    # (B, H, Hkv, T, D, valid, dtype): the groups of the tensor-core kernel (16: recurrentgemma's
    # MQA; 7: qwen2-vl's and yi-34b's) at one sequence, where the floor sets the splits, and with
    # ragged valid lengths, 0 included
    (1, 16, 1, 640, 64, [640], F32),
    (1, 16, 1, 640, 64, [640], BF16),
    (3, 16, 1, 640, 64, [640, 0, 333], F32),
    (3, 16, 1, 512, 128, [0, 512, 129], BF16),
    (1, 14, 2, 640, 128, [640], F32),
    (1, 14, 2, 640, 64, [640], BF16),
    (3, 14, 2, 512, 64, [0, 512, 257], F32),
    (3, 14, 2, 640, 64, [128, 0, 639], BF16),
]


@pytest.mark.parametrize("case", DEC_SPLIT_CASES)
def test_decode_attention_plain_at_the_floors_splits_vs_pallas(case):
    """The plain version at the new split plan (several splits of at least
    SPLIT_FLOOR rows, some of them past a row's valid length or empty)
    against the reference's decode_attention in interpret mode."""
    from repro_torch.kernels.decode_attention import SPLIT_FLOOR, head_blocks, plan_rows, split_plan
    B, H, Hkv, T, D, valid, dtype = case
    rng = np.random.default_rng(11)
    (qj, qt), (kj, kt), (vj, vt) = (both(rng.standard_normal(shape, dtype=np.float32), dtype)
                                    for shape in ((B, H, D), (B, Hkv, T, D), (B, Hkv, T, D)))
    vl = np.asarray(valid, np.int32)
    ns, chunk = split_plan(B, head_blocks(Hkv, H // Hkv, TDT[dtype]), T,
                           rows_per_iter=plan_rows(H // Hkv, D, TDT[dtype]))
    assert ns > 1 and chunk >= SPLIT_FLOOR
    got = K.decode_attention_plain(qt, kt, vt, kv_valid_len=torch.from_numpy(vl))
    want = jops.decode_attention(qj, kj, vj, jnp.asarray(vl))
    assert got.dtype == TDT[dtype] and got.shape == qt.shape
    close(t2n(got), j2n(want), DEC_SPLIT_TOL[dtype])
    dead = [i for i, n in enumerate(valid) if n == 0]
    if dead:
        assert float(got[dead].float().abs().max()) == 0.0


# ---------------- backward: K1 and K3 (the reference's kernels are forward only) ----------------
#
# The backward plain versions are held against autograd of the plain forwards
# (inside torch) and against ``jax.vjp`` of the reference's oracles in
# ``repro/kernels/ref.py`` (across frameworks), on the same numpy inputs and
# cotangents.  Each gradient's largest error is taken relative to the larger
# of 1 and its reference's largest magnitude, as ``chip_smoke.py`` does on the
# card: dK, dV and dw sum over many rows.  float32 at 2e-5 inside torch (another
# order of summation) and 1e-5 across frameworks as above; bfloat16 at 2e-2.

import jax  # noqa: E402

from repro_torch.models import layers as TL  # noqa: E402

BWD_TOL = {F32: 2e-5, BF16: 2e-2}


def grad_err(got, want) -> float:
    return max(float(np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).max())
               / max(1.0, float(np.abs(np.asarray(w, np.float64)).max()))
               for g, w in zip(got, want))


BWD_CASES = [
    # (B, H, Hkv, Sq, Sk, D, causal, window, dtype)
    (1, 2, 2, 40, 40, 64, True, 0, F32),      # G = 1
    (2, 6, 2, 33, 33, 64, True, 0, F32),      # G = 3 (phi4-mini), ragged
    (1, 10, 2, 24, 24, 32, True, 0, F32),     # G = 5 (qwen2.5-32b)
    (1, 8, 1, 20, 20, 32, True, 0, F32),      # G = 8 (MQA)
    (1, 4, 2, 48, 48, 32, True, 16, F32),     # causal window
    (1, 4, 2, 30, 30, 32, False, 8, F32),     # window alone
    (1, 4, 1, 16, 32, 32, False, 0, F32),     # Sq != Sk
    (1, 4, 4, 24, 40, 64, False, 0, F32),     # D 64, G 1, Sq != Sk unmasked (whisper's cross)
    (1, 6, 2, 32, 32, 64, True, 0, BF16),
]


def _bwd_inputs(case, seed=7):
    B, H, Hkv, Sq, Sk, D, causal, window, dtype = case
    rng = np.random.default_rng(seed)
    shapes = ((B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D), (B, H, Sq, D))
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]   # q, k, v, dO


def _plain_autograd(fn, ins, cot, **kw):
    leaves = [t.detach().clone().requires_grad_() for t in ins]
    out = fn(*leaves, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    return torch.autograd.grad(outs, leaves, cots)


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_flash_attention_bwd_plain_vs_autograd_of_the_plain_forward(case):
    *_, causal, window, dtype = case
    q, k, v, do = (torch.from_numpy(a).to(TDT[dtype]) for a in _bwd_inputs(case))
    o, lse = K.flash_attention_lse_plain(q, k, v, causal=causal, window=window)
    got = K.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, window=window)
    want = _plain_autograd(K.flash_attention_plain, (q, k, v), do, causal=causal, window=window)
    assert [g.dtype for g in got] == [TDT[dtype]] * 3
    assert grad_err([t2n(g) for g in got], [t2n(w) for w in want]) <= BWD_TOL[dtype]


@pytest.mark.parametrize("case", [c for c in BWD_CASES if c[-1] == F32], ids=str)
def test_flash_attention_bwd_plain_vs_jax_vjp_of_the_reference_oracle(case):
    """Every row sees a key in these cases, where the oracle and the kernels
    agree (they differ on a fully masked row)."""
    *_, causal, window, dtype = case
    arrays = _bwd_inputs(case)
    qj, kj, vj, doj = (jnp.asarray(a) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(q, k, v, causal=causal,
                                                              window=window), qj, kj, vj)
    want = [j2n(g) for g in vjp(doj)]
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    o, lse = K.flash_attention_lse_plain(q, k, v, causal=causal, window=window)
    got = K.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, window=window)
    assert grad_err([t2n(g) for g in got], want) <= TOL[F32]


def test_flash_attention_lse_is_the_log_sum_exp_of_the_scaled_scores():
    case = (1, 6, 2, 24, 24, 32, True, 8, F32)
    q, k, v, _ = (torch.from_numpy(a) for a in _bwd_inputs(case))
    o, lse = K.flash_attention_lse_plain(q, k, v, causal=True, window=8)
    s = torch.einsum("bhsd,bhtd->bhst", q, k.repeat_interleave(3, dim=1)) / 32 ** 0.5
    qp, tp = torch.arange(24)[:, None], torch.arange(24)[None, :]
    s = s.masked_fill(~((tp <= qp) & (tp > qp - 8)), float("-inf"))
    close(lse.numpy(), torch.logsumexp(s, dim=-1).numpy(), 1e-5)
    assert torch.equal(o, K.flash_attention_plain(q, k, v, causal=True, window=8))
    out = torch.empty_like(q)
    got = torch.empty_like(lse)
    K.flash_attention(q, k, v, causal=True, window=8, out=out, lse=got)   # the wrapper, CPU
    assert torch.equal(got, lse) and torch.equal(out, o)
    with pytest.raises(ValueError, match="lse"):
        K.flash_attention(q, k, v, lse=torch.empty(1, 6, 23))


def test_flash_attention_bwd_of_a_fully_masked_row_is_zero():
    """The forward gives such a row 0 (the kernels' convention); it sends no
    gradient: dQ is 0 there, and dK, dV get nothing from it."""
    case = (1, 4, 2, 40, 12, 32, False, 8, F32)     # rows 20.. see no key
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(case))
    o, lse = K.flash_attention_lse_plain(q, k, v, causal=False, window=8)
    dq, dk, dv = K.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False, window=8)
    assert torch.isfinite(lse).all() and (o[:, :, 20:] == 0).all()
    assert (dq[:, :, 20:] == 0).all()
    _, dk2, dv2 = K.flash_attention_bwd_plain(q[:, :, :20], k, v, o[:, :, :20], lse[:, :, :20],
                                              do[:, :, :20], causal=False, window=8)
    close(dk.numpy(), dk2.numpy(), 1e-6)
    close(dv.numpy(), dv2.numpy(), 1e-6)


@pytest.mark.parametrize("case", [BWD_CASES[1], BWD_CASES[4], BWD_CASES[-1]], ids=str)
def test_flash_bshd_is_differentiable_through_the_plain_backward_on_the_cpu(case):
    """``ops.flash_attention_bshd`` under autograd on CPU tensors: its
    autograd function takes the plain forward with lse and the plain
    backward, and equals autograd of the model's dense attention."""
    B, H, Hkv, Sq, Sk, D, causal, window, dtype = case
    assert Sq == Sk and causal        # the model's self-attention
    G = H // Hkv
    arrays = _bwd_inputs(case)
    q = torch.from_numpy(arrays[0]).to(TDT[dtype]).permute(0, 2, 1, 3).reshape(B, Sq, Hkv, G, D)
    k, v = (torch.from_numpy(a).to(TDT[dtype]).permute(0, 2, 1, 3) for a in arrays[1:3])
    do = torch.from_numpy(arrays[3]).to(TDT[dtype]).permute(0, 2, 1, 3).reshape(B, Sq, Hkv, G, D)
    got = _plain_autograd(lambda q, k, v: ops.flash_attention_bshd(q, k, v, window=window),
                          (q, k, v), do)
    want = _plain_autograd(lambda q, k, v: TL.attend_dense(q, k, v, q_offset=0, causal=True,
                                                           window=window), (q, k, v), do)
    assert grad_err([t2n(g) for g in got], [t2n(w) for w in want]) <= BWD_TOL[dtype]
    assert K.launch_counts()["flash_attention_bwd"] == 0


RMS_BWD_CASES = [
    # (rows, d, offset, residual, with_sum, x dtype, w dtype)
    (8, 64, False, False, False, F32, F32),
    (5, 48, True, False, False, F32, F32),
    (7, 64, False, True, False, F32, F32),
    (6, 32, True, True, True, F32, F32),
    (9, 64, False, True, True, BF16, BF16),
    (4, 96, True, False, False, BF16, F32),
]


def _rms_bwd_inputs(rows, d, seed=3):
    rng = np.random.default_rng(seed)
    x, r, dy, ds = (rng.standard_normal((rows, d), dtype=np.float32) for _ in range(4))
    w = rng.standard_normal(d, dtype=np.float32) * 0.3 + 1.0
    return x, r, w, dy, ds


@pytest.mark.parametrize("case", RMS_BWD_CASES, ids=str)
def test_rmsnorm_bwd_plain_vs_autograd_and_the_functions_on_the_cpu(case):
    rows, d, offset, residual, with_sum, xdt, wdt = case
    x, r, w, dy, ds = _rms_bwd_inputs(rows, d)
    xt, rt, dyt, dst = (torch.from_numpy(a).to(TDT[xdt]) for a in (x, r, dy, ds))
    wt = torch.from_numpy(w).to(TDT[wdt])
    if with_sum:
        want = _plain_autograd(lambda a, b, c: K.add_rmsnorm_plain(a, b, c, offset=offset),
                               (xt, rt, wt), (dst, dyt))
        fn = lambda a, b, c: ops.add_rmsnorm(a, b, c, offset=offset)  # noqa: E731
        got_fn = _plain_autograd(fn, (xt, rt, wt), (dst, dyt))
        s = xt + rt
        got = K.rmsnorm_bwd_plain(s, wt, dyt, offset=offset, ds=dst)
    elif residual:
        want = _plain_autograd(lambda a, b, c: K.rmsnorm_plain(a, c, offset=offset, residual=b),
                               (xt, rt, wt), dyt)
        fn = lambda a, b, c: ops.rmsnorm_residual(a, b, c, offset=offset)  # noqa: E731
        got_fn = _plain_autograd(fn, (xt, rt, wt), dyt)
        got = K.rmsnorm_bwd_plain(xt + rt, wt, dyt, offset=offset)
    else:
        want = _plain_autograd(lambda a, c: K.rmsnorm_plain(a, c, offset=offset), (xt, wt), dyt)
        got_fn = _plain_autograd(lambda a, c: ops.rmsnorm(a, c, offset=offset), (xt, wt), dyt)
        got = K.rmsnorm_bwd_plain(xt, wt, dyt, offset=offset)
    want_x, want_w = want[0], want[-1]
    tol = BWD_TOL[xdt]
    assert got[0].dtype == TDT[xdt] and got[1].dtype == TDT[wdt]
    assert grad_err([t2n(got[0]), t2n(got[1])], [t2n(want_x), t2n(want_w)]) <= tol
    # the autograd function (plain forward and backward on the CPU): x and the
    # residual get the same gradient
    assert grad_err([t2n(g) for g in got_fn], [t2n(w_) for w_ in want]) <= tol
    if residual or with_sum:
        assert torch.equal(got_fn[0], got_fn[1])
    assert K.launch_counts()["rmsnorm_bwd"] == 0


@pytest.mark.parametrize("case", [c for c in RMS_BWD_CASES if c[-2] == F32 and not c[4]],
                         ids=str)
def test_rmsnorm_bwd_plain_vs_jax_vjp_of_the_reference_oracle(case):
    rows, d, offset, residual, _, _, _ = case
    x, r, w, dy, _ = _rms_bwd_inputs(rows, d)
    if residual:
        f = lambda x, r, w: jref.rmsnorm_ref(x, w, offset=offset, residual=r)  # noqa: E731
        _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(r), jnp.asarray(w))
        want = [j2n(g) for g in vjp(jnp.asarray(dy))]
        want = [want[0], want[2]]
        s = torch.from_numpy(x) + torch.from_numpy(r)
    else:
        f = lambda x, w: jref.rmsnorm_ref(x, w, offset=offset)  # noqa: E731
        _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
        want = [j2n(g) for g in vjp(jnp.asarray(dy))]
        s = torch.from_numpy(x)
    got = K.rmsnorm_bwd_plain(s, torch.from_numpy(w), torch.from_numpy(dy), offset=offset)
    assert grad_err([t2n(g) for g in got], want) <= TOL[F32]


def test_backward_wrappers_raise_where_they_have_no_kernel():
    x = torch.randn(4, 64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        K.rmsnorm_bwd(x, torch.ones(64, device="meta"), x)
    q = torch.randn(1, 2, 8, 64, device="meta")
    lse = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        K.flash_attention_bwd(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="bad shapes"):
        K.flash_attention_bwd(q, q, q, q, lse[:, :, :4], q)


# ---------------- the fused AdamW update (a kernel of the port, no TPU kernel) ----------------

@pytest.mark.parametrize("p_dt,g_dt", [(F32, F32), (BF16, BF16), (BF16, F32)])
def test_adamw_update_takes_its_plain_version_on_the_cpu(p_dt, g_dt):
    """On the CPU the wrapper is the plain version: the reference's update,
    in place, in its order (held against the reference's numbers by
    ``test_torch_training.py``)."""
    from repro_torch.training.optimizer import adamw, cosine_schedule
    rng = np.random.default_rng(11)
    p0 = rng.standard_normal(1001).astype(np.float32)
    g0 = rng.standard_normal(1001).astype(np.float32) * 0.1
    p, g = torch.from_numpy(p0.copy()).to(TDT[p_dt]), torch.from_numpy(g0).to(TDT[g_dt])
    m, v = torch.zeros(1001), torch.zeros(1001)
    hp = dict(lr=torch.tensor(1e-3), c1=torch.tensor(0.1), c2=torch.tensor(0.05), b1=0.9, b2=0.95,
              eps=1e-8, weight_decay=0.1)
    K.adamw_update(p, g, m, v, **hp)
    want = [t.clone() for t in (torch.from_numpy(p0).to(TDT[p_dt]), torch.zeros(1001),
                                torch.zeros(1001))]
    K.adamw_update_plain(want[0], g, want[1], want[2], **hp)
    for a, b in zip((p, m, v), want):
        assert torch.equal(a, b)
    opt = adamw(cosine_schedule(1e-3, warmup=1))
    st = opt.init({"w": p})
    opt.update({"w": g}, st, {"w": p})
    assert K.launch_counts()["adamw"] == 0


def test_adamw_update_raises_where_it_has_no_kernel():
    t = torch.zeros(8, device="meta")
    s = torch.zeros((), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        K.adamw_update(t, t, t, t, lr=s, c1=s, c2=s, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0)
