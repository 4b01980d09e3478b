"""The tensor-core forward of K1 on the host: its kv walk as plain Python
(``fwd_kv_tiles`` in ``repro_torch.kernels.flash_attention``, the mirror of
each block's ``kv_lo`` and ``kv_hi`` in ``csrc/flash_attention.cu``) over
the tiles of its plan (``tile_plan``: 128 kv rows at D 64, 64 above).

The walk of each q tile must take every key that some row of the tile sees,
and stay inside K.  A float64 emulation of the online softmax over exactly
that walk, tile by tile as the kernel runs it (a row's running maximum in
log2 units floored at -1e30, the correction of O and of the sum, P = 2^(S
scale log2(e) - m)), must equal the plain forward (``flash_attention_lse_plain``,
its arithmetic carried out in float64) to 1e-10, the output and the
log-sum-exp of every row that sees a key: a walk that drops a tile shows
here, before any time on the card.  The shapes
are the ``kernels`` phase's forward shapes of ``chip_smoke.py`` and
whisper-large-v3's five, qwen2.5-32b's and yi-34b's; the emulation cuts the
head dim to 8, which no loop bound depends on, and runs whisper's shapes with
their batch and heads cut to B1 H2 and their lengths cut by 5 (1500 -> 300,
448 -> 90, 224 -> 45), and qwen2.5-32b's and yi-34b's with their groups of 5
and 7 on 2 kv heads and S2048 cut by 5 (410), which keeps the tiles ragged.
At D 128 where q and k both hold ``PAIR_MIN_KEYS`` rows or more a block is
128 q rows whose two consumer warpgroups both walk the block's kv tiles of
128 rows (a tile outside a warpgroup's own walk hides every key from its
rows): the emulation's rows do the same, at shapes that long (``LONG``)."""
import importlib
import math

import numpy as np
import pytest
import torch

fa = importlib.import_module("repro_torch.kernels.flash_attention")

LOG2E = 1.4426950408889634
MAX_FLOOR = -1e30     # the kernel's floor of a row's running maximum

# (B, H, Hkv, Sq, Sk, causal, window): the kernels phase's forward shapes
SHAPES = [
    (1, 24, 8, 2048, 2048, True, 0),     # phi4-mini's train shape, G = 3
    (1, 24, 8, 1000, 1000, True, 0),     # the serving path's prefill
    (1, 16, 1, 1000, 1000, True, 2048),  # recurrentgemma: a window that does not bite
    (2, 16, 1, 300, 300, True, 64),      # and one that does
    (2, 24, 8, 777, 777, True, 0),       # batch, ragged
    (2, 8, 1, 192, 192, True, 0),        # MQA, G = 8
    (2, 4, 2, 160, 160, True, 64),       # sliding window
    (1, 4, 2, 300, 300, False, 64),      # window alone
    (1, 4, 1, 128, 256, False, 0),       # Sq != Sk
    (1, 4, 2, 300, 100, False, 64),      # rows that see no key
    (1, 6, 2, 70, 33, True, 0),          # causal, Sq > Sk
    (1, 20, 20, 1500, 1500, False, 0),   # whisper-large-v3: the encoder at B1,
    (8, 20, 20, 1500, 1500, False, 0),   # and in the B8 train step,
    (1, 20, 20, 224, 1500, False, 0),    # the cross attention of the B1 context prefill,
    (8, 20, 20, 448, 1500, False, 0),    # and of the train step,
    (8, 20, 20, 448, 448, True, 0),      # and the decoder's causal self attention
    (1, 40, 8, 2048, 2048, True, 0),     # qwen2.5-32b's train shape, G = 5
    (1, 56, 8, 2048, 2048, True, 0),     # yi-34b's, G = 7
    (1, 40, 8, 1000, 1000, True, 0),     # and their serving prefills
    (1, 56, 8, 1000, 1000, True, 0),
]
# the emulation walks tiles in Python: the small shapes, whisper's five cut, and a causal
# Sq > Sk whose length is no multiple of a tile
SMALL = [s for s in SHAPES if s[3] <= 512 and s[4] <= 512 and s[0] * s[1] <= 80] + [
    (1, 2, 2, 300, 300, False, 0), (1, 2, 2, 45, 300, False, 0), (1, 2, 2, 90, 300, False, 0),
    (1, 2, 2, 90, 90, True, 0), (1, 4, 2, 200, 70, True, 0),
    # qwen2.5-32b's and yi-34b's train shapes with their groups (5, 7) on 2 kv heads and S
    # 2048 cut by 5, which leaves a ragged last tile of 26 rows
    (1, 10, 2, 410, 410, True, 0), (1, 14, 2, 410, 410, True, 0)]
# ... and at D 128 the two-consumer plan's (q and k of PAIR_MIN_KEYS rows or more): yi-34b's
# group of 7 on 2 kv heads at 1540 rows, causal, ragged; a window that bites; Sq != Sk
LONG = [(1, 14, 2, 1540, 1540, True, 0), (1, 2, 1, 1600, 1600, True, 200),
        (1, 2, 2, 1536, 1700, False, 0)]
# head dims whose plans walk tiles of 128 kv rows (64) and of 64 (128)
DIMS = [64, 128]


def visible(Sq, Sk, causal, window) -> np.ndarray:
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    m = np.ones((Sq, Sk), bool)
    if causal:
        m &= k <= q
    if window > 0:
        m &= k > q - window
    return m


def test_the_plan_at_d64_walks_tiles_of_128_rows():
    assert fa.tile_plan(64)["kv_rows"] == 128 and fa.tile_plan(256)["kv_rows"] == 64
    assert fa.fwd_kv_tiles(0, 1500, 1500, False, 0, 64) == range(0, 12)     # 11.7 tiles
    assert fa.fwd_kv_tiles(0, 1500, 1500, False, 0, 256) == range(0, 24)
    # causal: q tile 3 (rows 192-255) sees keys 0-255, two tiles of 128 or four of 64
    assert fa.fwd_kv_tiles(3, 448, 448, True, 0, 64) == range(0, 2)
    assert fa.fwd_kv_tiles(3, 448, 448, True, 0, 256) == range(0, 4)
    # D 128: 64-row tiles below PAIR_MIN_KEYS rows, so at 448 as D 256's; from it blocks
    # of 128 q rows over tiles of 128 kv rows: q tile 12 (rows 1536-1599, the last, ragged)
    # sees every key, 13 tiles, the last one cut at 1600
    assert fa.fwd_kv_tiles(3, 448, 448, True, 0, 128) == range(0, 4)
    assert (fa.tile_plan(128, S=1535)["q_rows"], fa.tile_plan(128, S=1535)["kv_rows"]) == (64, 64)
    assert (fa.tile_plan(128, S=1536)["q_rows"], fa.tile_plan(128, S=1536)["kv_rows"]) == \
        (128, 128)
    assert fa.fwd_kv_tiles(12, 1600, 1600, True, 0, 128) == range(0, 13)
    assert fa.fwd_kv_tiles(12, 1600, 1600, True, 0, 256) == range(0, 13)   # 64-row tiles


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("shape", SHAPES)
def test_kv_walk_takes_every_visible_key(shape, D):
    _, _, _, Sq, Sk, causal, window = shape
    plan = fa.tile_plan(D, None, min(Sq, Sk))
    bq, bk = plan["q_rows"], plan["kv_rows"]
    seen = visible(Sq, Sk, causal, window)
    for qt in range(-(-Sq // bq)):
        walk = fa.fwd_kv_tiles(qt, Sq, Sk, causal, window, D)
        covered = np.zeros(Sk, bool)
        for kt in walk:
            assert 0 <= kt * bk < Sk, (qt, kt)
            covered[kt * bk:kt * bk + bk] = True
        rows = seen[qt * bq:qt * bq + bq]
        assert not (rows.any(axis=0) & ~covered).any(), qt
        assert list(walk) == sorted(walk) and len(set(walk)) == len(walk)


def emulate_fwd(q, k, v, *, causal, window, scale, D):
    """The tensor-core kernel's forward in float64, block by block over its
    kv walk (``fwd_kv_tiles`` at head dim ``D``'s plan): masks by absolute
    position inside a tile, the running maximum in log2 units floored at
    -1e30, the correction of O and of the row sum, then O / max(l, 1e-30)
    and lse = (m + log2 max(l, 1e-30)) ln 2."""
    B, H, Sq, _ = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    plan = fa.tile_plan(D, None, min(Sq, Sk))
    bq, bk = plan["q_rows"], plan["kv_rows"]
    seen = torch.from_numpy(visible(Sq, Sk, causal, window))
    out = torch.zeros((B, H, Sq, Dv), dtype=torch.float64)
    lse = torch.zeros((B, H, Sq), dtype=torch.float64)
    scale_log2 = scale * LOG2E
    for b in range(B):
        for h in range(H):
            for qt in range(-(-Sq // bq)):
                qs = slice(qt * bq, min(qt * bq + bq, Sq))
                n = qs.stop - qs.start
                m = torch.full((n,), MAX_FLOOR, dtype=torch.float64)
                l = torch.zeros(n, dtype=torch.float64)
                o = torch.zeros((n, Dv), dtype=torch.float64)
                for kt in fa.fwd_kv_tiles(qt, Sq, Sk, causal, window, D):
                    ks = slice(kt * bk, min(kt * bk + bk, Sk))
                    s = q[b, h, qs] @ k[b, h // G, ks].T
                    s = torch.where(seen[qs, ks], s, torch.full_like(s, -math.inf))
                    m_new = torch.maximum(m, s.amax(dim=1) * scale_log2)
                    c = torch.exp2(m - m_new)
                    p = torch.exp2(s * scale_log2 - m_new[:, None])
                    l = l * c + p.sum(dim=1)
                    o = o * c[:, None] + p @ v[b, h // G, ks]
                    m = m_new
                out[b, h, qs] = o / l.clamp_min(1e-30)[:, None]
                lse[b, h, qs] = (m + torch.log2(l.clamp_min(1e-30))) * math.log(2.0)
    return out, lse


def plain_f64(q, k, v, causal, window, monkeypatch):
    """The plain forward with its arithmetic in float64 (its ``.float()``
    widens instead)."""
    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "float", lambda self: self.double())
        o, lse = fa.flash_attention_lse_plain(q, k, v, causal=causal, window=window)
    assert o.dtype == lse.dtype == torch.float64
    return o, lse


def inputs(shape, seed):
    B, H, Hkv, Sq, Sk, _, _ = shape
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, Sq, 8)))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, Sk, 8))) for _ in range(2))
    return q, k, v


def rel_err(got, want) -> float:
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("shape", SMALL)
def test_tile_emulation_over_the_walk_equals_the_plain_forward(shape, D, monkeypatch):
    check_emulation(shape, D, monkeypatch)


@pytest.mark.parametrize("shape", LONG)
def test_two_consumer_emulation_over_the_walk_equals_the_plain_forward(shape, monkeypatch):
    """D 128's block of 128 q rows on 128-row kv tiles, where q and k are long
    enough to take it."""
    assert fa.tile_plan(128, None, min(shape[3], shape[4]))["q_rows"] == 128
    check_emulation(shape, 128, monkeypatch)


def check_emulation(shape, D, monkeypatch):
    *_, causal, window = shape
    q, k, v = inputs(shape, sum(shape[:5]))
    want_o, want_lse = plain_f64(q, k, v, causal, window, monkeypatch)
    got_o, got_lse = emulate_fwd(q, k, v, causal=causal, window=window,
                                 scale=1.0 / math.sqrt(8), D=D)
    assert rel_err(got_o, want_o) <= 1e-10
    # a row that sees no key: O is 0, and either log-sum-exp is some -1e30 (the kernel's
    # floor is in log2 units, the plain version's in natural ones)
    live = torch.from_numpy(visible(*shape[3:]).any(axis=1))
    assert rel_err(got_lse[..., live], want_lse[..., live]) <= 1e-10
    assert bool((got_lse[..., ~live] < -1e29).all() and (want_lse[..., ~live] < -1e29).all())


def test_emulation_sees_a_dropped_tile(monkeypatch):
    """The check above is not blind: the first kv tile left out of one q
    tile's walk at D 64 moves that tile's rows far past 1e-10, and no other
    row."""
    shape = (1, 2, 2, 300, 300, False, 0)
    q, k, v = inputs(shape, 7)
    full = emulate_fwd(q, k, v, causal=False, window=0, scale=1 / math.sqrt(8), D=64)
    walk = fa.fwd_kv_tiles
    monkeypatch.setattr(fa, "fwd_kv_tiles",
                        lambda qt, *a: walk(qt, *a)[1:] if qt == 2 else walk(qt, *a))
    short = emulate_fwd(q, k, v, causal=False, window=0, scale=1 / math.sqrt(8), D=64)
    assert float((short[0][:, :, 128:192] - full[0][:, :, 128:192]).abs().max()) > 1e-3
    rest = torch.cat([torch.arange(0, 128), torch.arange(192, 300)])
    assert torch.equal(short[0][:, :, rest], full[0][:, :, rest])
