"""The tensor-core backward of K1 on the host: its tile walks and block order
as plain Python (``bwd_q_tiles``, ``bwd_kv_tiles``, ``bwd_block_order`` in
``repro_torch.kernels.flash_attention``, mirrors of ``dkdv_q_tiles``,
``dq_kv_tiles`` and the grids of ``csrc/flash_attention_bwd.cu``).

The walks must cover every visible (q row, key) pair of each head exactly
once, and take no tile without one.  A float64 emulation that computes the
backward tile by tile over exactly those walks, with each q head's partial
dK/dV summed over the group in head order as the sum kernel does, must equal
the plain backward (``flash_attention_bwd_plain``, its arithmetic carried out
in float64) to 1e-10: a loop bound that drops or repeats a tile shows here,
before any time on the card.  At D 128 the group's dK/dV blocks add into one
running sum a kv head themselves, each after the block of the head before
it (a turn a (batch, kv head, kv tile)), in grid order: a second emulation
walks the grid so, checks that each block's turn has come when the grid
reaches it (no block waits on one after it), and must equal the plain
backward too.  The shapes are the ``kernels`` phase's edge shapes of
``chip_smoke.py``, whisper-large-v3's three train shapes and qwen2.5-32b's
and yi-34b's; the emulation cuts the head dim to 8, which no loop bound
depends on, and runs whisper's shapes with their batch and heads cut to B1 H2
and their lengths cut by 5 (1500 -> 300, 448 -> 90), and qwen2.5-32b's and
yi-34b's with their groups of 5 and 7 on 2 kv heads and S2048 cut by 5
(410), which keeps the tiles ragged."""
import importlib
import math
from pathlib import Path

import numpy as np
import pytest
import torch

fa = importlib.import_module("repro_torch.kernels.flash_attention")

T = fa.BWD_TILE

# (B, H, Hkv, Sq, Sk, causal, window): the kernels phase's backward shapes
SHAPES = [
    (1, 24, 8, 2048, 2048, True, 0),     # phi4-mini's train shape, G = 3
    (1, 24, 8, 1000, 1000, True, 0),     # the serving path's prefill
    (2, 40, 8, 333, 333, True, 0),       # G = 5, ragged
    (1, 16, 16, 300, 300, True, 0),      # G = 1
    (2, 8, 1, 192, 192, True, 0),        # G = 8
    (1, 14, 2, 130, 130, True, 0),       # G = 7
    (2, 4, 2, 160, 160, True, 64),       # sliding window
    (1, 4, 2, 300, 300, False, 64),      # window alone
    (1, 4, 1, 128, 256, False, 0),       # Sq != Sk
    (1, 4, 2, 300, 100, False, 64),      # rows that see no key
    (1, 8, 8, 200, 200, True, 0),        # G = 1, ragged
    (1, 6, 2, 70, 33, True, 0),          # causal, Sq > Sk
    (1, 6, 2, 100, 100, True, 0),
    (8, 20, 20, 1500, 1500, False, 0),   # whisper-large-v3: the encoder's self attention,
    (8, 20, 20, 448, 1500, False, 0),    # the decoder's cross attention
    (8, 20, 20, 448, 448, True, 0),      # and its causal self attention
    (1, 40, 8, 2048, 2048, True, 0),     # qwen2.5-32b's train shape, G = 5
    (1, 56, 8, 2048, 2048, True, 0),     # yi-34b's, G = 7
]
# the emulation walks tiles in Python: the small shapes, and whisper's three cut
SMALL = [s for s in SHAPES if s[3] <= 512 and s[0] * s[1] <= 80] + [
    (1, 2, 2, 300, 300, False, 0), (1, 2, 2, 90, 300, False, 0), (1, 2, 2, 90, 90, True, 0),
    # qwen2.5-32b's and yi-34b's train shapes with their groups (5, 7) on 2 kv heads and S
    # 2048 cut by 5, which leaves a ragged last tile of 26 rows
    (1, 10, 2, 410, 410, True, 0), (1, 14, 2, 410, 410, True, 0)]
# the shapes whose groups sum more than one head
GROUPED = [s for s in SMALL if s[1] > s[2]]


def visible(Sq, Sk, causal, window) -> np.ndarray:
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    m = np.ones((Sq, Sk), bool)
    if causal:
        m &= k <= q
    if window > 0:
        m &= k > q - window
    return m


def ntiles(S):
    return -(-S // T)


@pytest.mark.parametrize("shape", SHAPES)
def test_dkdv_walks_cover_every_visible_pair_once(shape):
    _, _, _, Sq, Sk, causal, window = shape
    seen = visible(Sq, Sk, causal, window)
    count = np.zeros((Sq, Sk), int)
    for kt in range(ntiles(Sk)):
        ks = slice(kt * T, min(kt * T + T, Sk))
        for qt in fa.bwd_q_tiles(kt, Sq, Sk, causal, window):
            qs = slice(qt * T, min(qt * T + T, Sq))
            assert qs.start < Sq
            tile = seen[qs, ks]
            assert tile.any(), (kt, qt)              # no tile walked in vain
            count[qs, ks] += tile
    assert np.array_equal(count, seen.astype(int))


@pytest.mark.parametrize("shape", SHAPES)
def test_dq_walks_cover_every_visible_pair_once(shape):
    _, _, _, Sq, Sk, causal, window = shape
    seen = visible(Sq, Sk, causal, window)
    count = np.zeros((Sq, Sk), int)
    for qt in range(ntiles(Sq)):
        qs = slice(qt * T, min(qt * T + T, Sq))
        for kt in fa.bwd_kv_tiles(qt, Sq, Sk, causal, window):
            ks = slice(kt * T, min(kt * T + T, Sk))
            assert ks.start < Sk
            tile = seen[qs, ks]
            assert tile.any(), (qt, kt)
            count[qs, ks] += tile
    assert np.array_equal(count, seen.astype(int))


@pytest.mark.parametrize("kind", ["dkdv", "dq"])
@pytest.mark.parametrize("shape", SHAPES)
def test_block_order_takes_each_block_once_heaviest_first(shape, kind):
    B, H, _, Sq, Sk, causal, window = shape
    S = Sk if kind == "dkdv" else Sq
    order = fa.bwd_block_order(kind, B, H, S)
    assert sorted(order) == [(t, h, b) for t in range(ntiles(S)) for h in range(H)
                             for b in range(B)]
    walk = fa.bwd_q_tiles if kind == "dkdv" else fa.bwd_kv_tiles
    work = [len(walk(t, Sq, Sk, causal, window)) for t, _, _ in order]
    if causal and window == 0 and Sq == Sk:
        assert work == sorted(work, reverse=True)    # the longest walks start first


def emulate_bwd(q, k, v, o, lse, do, *, causal, window, scale, chain=False):
    """The tensor-core kernels' backward in float64, block by block in grid
    order over their walks: masks by absolute position inside a tile, each q
    head's partial dK/dV kept apart, then summed over the group in head
    order; or (``chain``, D 128's) each block adding its dK/dV into its kv
    head's running sums when the grid reaches it, once the block of the head
    before it in the group has (its turn)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    seen = torch.from_numpy(visible(Sq, Sk, causal, window))
    delta = (do * o).sum(-1)
    part_dk = torch.zeros((B, H, Sk, D), dtype=torch.float64)
    part_dv = torch.zeros_like(part_dk)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    turns = {}
    for kt, h, b in fa.bwd_block_order("dkdv", B, H, Sk, chain_g=G if chain else 0):
        ks = slice(kt * T, min(kt * T + T, Sk))
        kk, vv = k[b, h // G, ks], v[b, h // G, ks]
        for qt in fa.bwd_q_tiles(kt, Sq, Sk, causal, window):
            qs = slice(qt * T, min(qt * T + T, Sq))
            pt = torch.exp(kk @ q[b, h, qs].T * scale - lse[b, h, qs][None, :])
            pt = torch.where(seen[qs, ks].T, pt, torch.zeros_like(pt))
            dst = pt * (vv @ do[b, h, qs].T - delta[b, h, qs][None, :])
            part_dv[b, h, ks] += pt @ do[b, h, qs]
            part_dk[b, h, ks] += dst @ q[b, h, qs]
        if chain:              # q head h adds in its turn: heads h - g .. h - 1 have added
            assert turns.get((b, h // G, kt), 0) == h % G, (kt, h, b)
            turns[b, h // G, kt] = h % G + 1
            dk[b, h // G, ks] += part_dk[b, h, ks] * scale
            dv[b, h // G, ks] += part_dv[b, h, ks]
    if not chain:
        for g in range(G):     # head order, as the sum kernel: kv head i takes q head i G + g
            dk += part_dk[:, g::G] * scale
            dv += part_dv[:, g::G]
    dq = torch.zeros_like(q)
    for qt, h, b in fa.bwd_block_order("dq", B, H, Sq):
        qs = slice(qt * T, min(qt * T + T, Sq))
        for kt in fa.bwd_kv_tiles(qt, Sq, Sk, causal, window):
            ks = slice(kt * T, min(kt * T + T, Sk))
            kk, vv = k[b, h // G, ks], v[b, h // G, ks]
            p = torch.exp(q[b, h, qs] @ kk.T * scale - lse[b, h, qs][:, None])
            p = torch.where(seen[qs, ks], p, torch.zeros_like(p))
            ds = p * (do[b, h, qs] @ vv.T - delta[b, h, qs][:, None])
            dq[b, h, qs] += ds @ kk * scale
    return dq, dk, dv


@pytest.mark.parametrize("shape", SMALL)
def test_tile_emulation_over_the_walks_equals_the_plain_backward(shape, monkeypatch):
    B, H, Hkv, Sq, Sk, causal, window = shape
    D = 8
    rng = np.random.default_rng(sum(shape[:5]))
    q, do = (torch.from_numpy(rng.standard_normal((B, H, Sq, D))) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, Sk, D))) for _ in range(2))
    scale = 1.0 / math.sqrt(D)
    # the plain versions' arithmetic in float64: their `.float()` widens instead
    monkeypatch.setattr(torch.Tensor, "float", lambda self: self.double())
    o, lse = fa.flash_attention_lse_plain(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, window=window)
    assert all(w.dtype == torch.float64 for w in want)
    got = emulate_bwd(q, k, v, o, lse, do, causal=causal, window=window, scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
        assert err <= 1e-10, (name, err)


@pytest.mark.parametrize("shape", GROUPED)
def test_chain_emulation_over_the_grid_equals_the_plain_backward(shape, monkeypatch):
    """D 128's group sum: each dK/dV block adds in its turn as the grid
    reaches it (``emulate_bwd(chain=True)`` asserts the turn has come)."""
    B, H, Hkv, Sq, Sk, causal, window = shape
    rng = np.random.default_rng(sum(shape[:5]) + 1)
    q, do = (torch.from_numpy(rng.standard_normal((B, H, Sq, 8))) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, Sk, 8))) for _ in range(2))
    monkeypatch.setattr(torch.Tensor, "float", lambda self: self.double())
    o, lse = fa.flash_attention_lse_plain(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, window=window)
    got = emulate_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                      scale=1.0 / math.sqrt(8), chain=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
        assert err <= 1e-10, (name, err)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[1] > s[2]])
def test_chained_dkdv_grid_puts_each_head_a_slab_after_the_one_before_it(shape):
    """The chain's waits: in the chained dK/dV grid every block comes once;
    the kv tiles go in chunks, heaviest under a causal mask (the first)
    first; and the block of q head h comes a head's slab (``CHAIN_SLAB``
    blocks, or all of a narrower chunk's) after head h - 1's of the same
    (batch, kv tile), so a block waits only on one that started well before
    it."""
    B, H, Hkv, Sq, Sk, causal, window = shape
    G, n = H // Hkv, ntiles(Sk)
    order = fa.bwd_block_order("dkdv", B, H, Sk, chain_g=G)
    assert sorted(order) == sorted(fa.bwd_block_order("dkdv", B, H, Sk))
    ch = min(n, -(-fa.CHAIN_SLAB // (Hkv * B)))
    assert [kt // ch for kt, _, _ in order] == sorted(kt // ch for kt, _, _ in order)
    index = {blk: i for i, blk in enumerate(order)}
    for (kt, h, b), i in index.items():
        if h % G:
            width = min(ch, n - kt // ch * ch)
            assert i - index[kt, h - 1, b] == width * Hkv * B
            if width == ch:
                assert width * Hkv * B >= min(fa.CHAIN_SLAB, n * Hkv * B)


def test_emulation_sees_a_dropped_tile(monkeypatch):
    """The check above is not blind: one kv tile left out of one dQ walk
    moves dQ far past 1e-10."""
    B, H, Hkv, Sq, Sk, causal, window = 1, 2, 1, 200, 200, True, 0
    rng = np.random.default_rng(7)
    q, do = (torch.from_numpy(rng.standard_normal((B, H, Sq, 8))) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, Sk, 8))) for _ in range(2))
    o, lse = fa.flash_attention_lse_plain(q, k, v, causal=causal)
    full = emulate_bwd(q, k, v, o.double(), lse.double(), do, causal=causal, window=window,
                       scale=1 / math.sqrt(8))
    walk = fa.bwd_kv_tiles
    monkeypatch.setattr(fa, "bwd_kv_tiles",
                        lambda qt, *a: walk(qt, *a)[1:] if qt == 3 else walk(qt, *a))
    short = emulate_bwd(q, k, v, o.double(), lse.double(), do, causal=causal, window=window,
                        scale=1 / math.sqrt(8))
    assert float((short[0] - full[0]).abs().max()) > 1e-3
    assert torch.equal(short[1], full[1]) and torch.equal(short[2], full[2])


def test_backward_source_has_no_mma_sync_kernel():
    """The bf16 path is the wgmma + TMA design; the mma.sync kernels are gone."""
    src = (Path(fa.__file__).parent / "csrc" / "flash_attention_bwd.cu").read_text()
    assert "mma.sync" not in src and "mma_bf16" not in src
    for name in ("flash_bwd_dkdv_wg_kernel", "flash_bwd_dq_wg_kernel", "flash_bwd_delta_wg_kernel",
                 "flash_bwd_sum_kernel", "issue_qk", "issue_pv", "tma_load_4d", "bulk_load"):
        assert name in src, name
