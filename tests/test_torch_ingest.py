"""Ingest: the port's torch model traced into operator graphs, held against
``repro.core.model_ingest`` on the same configs at full width.

Attention and every product must be the reference's exactly: the multiset of
``matmul`` and ``attention`` nodes (kind, ``mm_dims``, ``attn_dims``, flops,
``repeat``, ``phase``; the port's extra ``G`` set aside), and with it the
flops of the products.  The rest of a graph (elementwise, copy, reduce,
transpose, gather, scatter) comes from another decomposition (ATen against
lax) and is held to the tolerances below, measured on these configs and
explained in ``PERF.md``:

* ``REST_BYTES``: the remainder's bytes over the reference's, 0.60-1.10 in a
  decoder block (measured 0.654 for gemma-7b, whose GeGLU lax expands into
  three passes where ATen has one ``gelu``, to 1.054) and 0.60-2.20 in the
  head (measured 0.667-2.091: the reference reads the whole embedding table
  for a lookup, as ``jnp.take`` is a ``jit`` call its tracer does not
  inline, and fuses the train loss's log-softmax into one node where the
  port writes the float32 log-probabilities, as eager torch does).
* ``REST_BYTES["moe_joint"]``: olmoe's MoE block in the train joint graph,
  0.45-1.10 (measured 0.507).  The reference's autodiff of the dispatch's and
  the combine's gathers and scatters writes float32 buffers of the (E, cap, D)
  and (T*K, D) shapes: 45.9 of the 93.6 GB of its remainder, where the port's
  autograd keeps them in bf16 (0.4 GB of float32 in 47.5 GB).  The forward
  graphs of that block are held to the ``block`` bounds (measured 0.928-0.939).
  deepseek's MLA MoE block reads 0.569 there for the same reason, and
  0.927 in its train and prefill forward graphs.
  deepseek's absorbed MLA decode block reads 0.654, inside the ``block``
  bounds: its batched products read permuted views that the tracer folds, as it
  folds reshapes (``tracer._bmm_transposes``), and it prices the
  reference's five transposes of the products' outputs; the gap is the
  reference's two float32 converts of the latent cache where the port has
  one (100.7 against 50.3 MB).
* ``REST_NODES``: the remainder's node counts over the reference's,
  0.50-1.25 (measured 0.57-1.18; olmoe 0.66-0.72; deepseek 0.75-0.82;
  recurrentgemma 0.59-0.88).
* ``TOTAL_FLOPS``: all flops within 0.1 % (measured at most 0.049 %:
  elementwise flops differ).

In the train joint graph, torch's ``mm`` backward forms a weight gradient
as ``x^T @ dy``; for three products of a block (two of them the k/v weights)
JAX forms the transposed product, so their ``mm_dims`` have M and N swapped:
those are compared as unordered (M, N) pairs with K and flops exact.  In the
MoE block JAX also transposes the three expert weights' batched gradients;
their M folds in the E experts, so the pair compared is the per-expert
(M / E, N), with E, K and flops exact.  ``SWAPPED`` bounds how many a
block's joint graph has: in deepseek's MLA block, the weight gradients of
its seven projections (dq, uq, dkv, uk, uv, kr, o), of the router and of
the shared expert's down projection, and one of the expert weights'; in
recurrentgemma's RG-LRU block one (a GeGLU weight's), in its local
attention block three (the k/v weights' and a GeGLU weight's).

recurrentgemma-9b's two blocks are held to the ``block`` bounds: measured
rest bytes 0.71-0.99 and nodes 0.59-0.88.

xlstm-125m's two blocks are held to the ``block`` bounds too, with every
product of the reference's, repeats included: the mLSTM's chunk body at
the chunk count (2 in prefill, 8 in train), the sLSTM's step at the
sequence length (512, 2048), both traced once through ``layers.scan``
(``core/stubs.py``).  The cells write each ``jnp.einsum`` out as the
products JAX lowers it to and take their gradients as JAX transposes them
(``layers._Dot``), but for the all-batch ``(N, 1, 1)`` products JAX emits
for elementwise work, which the port runs as multiplies (about 125 times
faster on the card; ``ALL_BATCH`` counts them: 2 in the mLSTM's forward graph, 8 in
its joint graph, each at the chunk count, their flops within
``TOTAL_FLOPS``); the ``SWAPPED``
products are weight gradients of the blocks' projections (three in the
mLSTM block, two in the sLSTM block: measured).  Measured rest nodes
0.81-1.10, bytes 0.81-1.07.  The train head's loss is log-softmax and
``nll_loss``, which the port prices as the reference prices its jitted
``log_softmax`` (one node of one flop an element; ``core/tracer.py``):
measured rest bytes 0.88-1.00 there for every config.  Its RG-LRU block's scan is the
reference's log-depth ``associative_scan`` written out in torch (122 of
the reference's 170 prefill nodes are that scan's slices, concatenations
and pads), so its node count follows the reference's.

whisper-large-v3's two blocks (``xattn``, ``enc``) and its encoder graph
(``enc``, repeated 32 times; none in decode) have every product and
attention of the reference's: the decoder block's cross attention at Sq the
prompt and Sk 1500, not causal, and its encoder at 1500 x 1500, not causal.
Their FFN is a plain GELU with biases, which lax writes out
(``jax.nn.gelu(approximate=True)``) as four elementwise passes over (B, S,
d_ff) beside the up projection's bias add, five nodes in a forward graph
and 17 in a joint graph, where ATen has one ``gelu`` kernel (the bias add
and it, one node; six in the joint graph), which the port runs.
``PLAIN_GELU`` sets those elementwise nodes of the FFN's width aside from
both graphs, as ``ALL_BATCH`` sets aside products: the port's must be fewer,
with fewer bytes and flops, and the rest is held to the bounds above
(measured rest bytes 0.88-1.07, nodes 0.64-0.77, flops within 1.2e-4, no
weight gradient's product swapped;
with the passes left in, the encoder block's forward graph reads rest
bytes 0.571 and flops -1.09e-3).
"""
import functools
import collections

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as r_config
from repro.core import model_ingest as r_ingest, tracer as r_tracer
from repro.core.ir import Graph as RGraph
from repro_torch.configs import ARCH_IDS, get_config as t_config
from repro_torch.core import model_ingest as t_ingest, stubs, tracer as t_tracer
from repro_torch.core.ir import Graph as TGraph

REST_BYTES = {"block": (0.60, 1.10), "head": (0.60, 2.20), "moe_joint": (0.45, 1.10)}
REST_NODES = (0.50, 1.25)
SWAPPED = {"attn_ffn": 3, "moe_attn_ffn": 6, "mla_moe": 10, "griffin_rec": 1, "griffin_attn": 3,
           "mlstm": 3, "slstm": 2, "xattn": 0, "enc": 0, "head": 3}
# The reference's all-batch products (N, 1, 1), elementwise work JAX emits as
# ``dot_general``, which the port runs as multiplies (``layers.py``'s xLSTM
# section): set aside from the reference's graph, counted per graph.
ALL_BATCH = {("mlstm", "prefill", "fwd"): 2, ("mlstm", "train", "fwd"): 2,
             ("mlstm", "train", "joint"): 8}
TOTAL_FLOPS = 1e-3
# Blocks whose FFN is a plain GELU: the elementwise passes of the FFN's width
# set aside from the remainder (the docstring)
PLAIN_GELU = ("xattn", "enc")
SHAPES = {"train": (8, 2048, 0), "prefill": (1, 512, 0), "decode": (8, 1, 2048)}
CORE = ("matmul", "attention")


def _core_key(n, *, unordered_mn=False):
    mm = n.attrs.get("mm_dims")
    if mm is not None and unordered_mn:
        if n.attrs.get("moe_expert") and len(n.out_shape) == 3:
            # a batched expert product: M holds the E batch, so the swap is
            # of the per-expert (M, N)
            e = n.out_shape[0]
            mm = (e, tuple(sorted((mm[0] // e, mm[1]))), mm[2])
        else:
            mm = (tuple(sorted(mm[:2])), mm[2])
    return (n.kind, mm, n.attrs.get("attn_dims"), n.flops, n.repeat, n.phase)


def _all_batch(n):
    return n.kind == "matmul" and tuple(n.attrs["mm_dims"][1:]) == (1, 1)


def _core(g, *, all_batch=True, **kw):
    return collections.Counter(_core_key(n, **kw) for n in g
                               if n.kind in CORE and (all_batch or not _all_batch(n)))


def _gelu_pass(n, d_ff):
    """An elementwise pass over (B, S, d_ff): the plain GELU and its bias add."""
    return n.kind == "elementwise" and len(n.out_shape) == 3 and n.out_shape[-1] == d_ff


def _rest(g, skip=lambda n: False):
    rest = [n for n in g if n.kind not in CORE and not skip(n)]
    return len(rest), sum(n.total_bytes for n in rest)


_CACHE = {}


def graphs(arch, mode):
    key = (arch, mode)
    if key not in _CACHE:
        B, S, cl = SHAPES[mode]
        _CACHE[key] = (r_ingest.block_graphs(r_config(arch), B, S, mode, cache_len=cl),
                       t_ingest.block_graphs(t_config(arch), B, S, mode, cache_len=cl))
    return _CACHE[key]


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_block_graphs_match_the_reference(arch, mode):
    r, t = graphs(arch, mode)
    assert [(b.kind, b.repeat) for b in r.all_blocks()] == \
        [(b.kind, b.repeat) for b in t.all_blocks()]
    for rb, tb in zip(r.all_blocks(), t.all_blocks()):
        part = "head" if rb.kind == "head" else "block"
        for which in ("fwd", "joint"):
            rg, tg = getattr(rb, which), getattr(tb, which)
            assert (rg is None) == (tg is None)
            if rg is None:
                continue
            where = f"{arch} {mode} {rb.kind}.{which}"
            assert sum(map(_all_batch, rg)) == ALL_BATCH.get((rb.kind, mode, which), 0), where
            assert not any(map(_all_batch, tg)), where
            if which == "fwd":
                assert _core(rg, all_batch=False) == _core(tg), where
            else:
                assert _core(rg, all_batch=False, unordered_mn=True) == \
                    _core(tg, unordered_mn=True), where
                swapped = sum((_core(tg) - _core(rg)).values())
                assert swapped <= SWAPPED[rb.kind], where
            for n in tg:
                if n.kind == "attention":
                    assert n.attrs["G"] == t_config(arch).q_per_kv
            core_flops = [g.total("flops", pred=lambda n: n.kind in CORE and not _all_batch(n))
                          for g in (rg, tg)]
            assert core_flops[0] == core_flops[1], where
            gelu = functools.partial(_gelu_pass, d_ff=t_config(arch).d_ff) \
                if rb.kind in PLAIN_GELU else (lambda n: False)
            if rb.kind in PLAIN_GELU:
                # ATen's one gelu against lax's passes: fewer nodes, bytes and flops
                (rgn, rgb), (tgn, tgb) = (_rest(g, lambda n: not gelu(n)) for g in (rg, tg))
                assert 0 < tgn < rgn and tgb < rgb, where
                assert tg.total("flops", pred=gelu) < rg.total("flops", pred=gelu), where
            assert tg.total("flops", pred=lambda n: not gelu(n)) == pytest.approx(
                rg.total("flops", pred=lambda n: not gelu(n)), rel=TOTAL_FLOPS), where
            (rn, rbytes), (tn, tbytes) = _rest(rg, gelu), _rest(tg, gelu)
            moe = rb.kind in ("moe_attn_ffn", "mla_moe")
            lo, hi = REST_BYTES["moe_joint" if moe and which == "joint" else part]
            assert lo <= tbytes / rbytes <= hi, where
            lo, hi = REST_NODES
            assert lo <= tn / rn <= hi, where


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_moe_expert_tags_match_the_reference(mode):
    """``_tag_moe`` tags the same batched expert products in both packages
    (three forward, six more in the joint graph).  The one difference: JAX
    forms the router's weight gradient transposed, (E, D), which the
    reference's rule (``out_shape[0] == E``) also tags; torch forms it (D, E)."""
    r, t = graphs("olmoe-1b-7b", mode)
    cfg = t_config("olmoe-1b-7b")
    for rb, tb in zip(r.blocks, t.blocks):
        for which in ("fwd", "joint"):
            rg, tg = getattr(rb, which), getattr(tb, which)
            if rg is None:
                continue

            def tagged(g, ndim):
                return collections.Counter((tuple(sorted(n.out_shape[1:])), n.flops) for n in g
                                           if n.attrs.get("moe_expert") and len(n.out_shape) == ndim)

            assert tagged(rg, 3) == tagged(tg, 3)
            assert sum(tagged(tg, 3).values()) == (9 if which == "joint" else 3)
            assert not tagged(tg, 2)
            assert sum(tagged(rg, 2).values()) == (1 if which == "joint" else 0)
            if which == "joint":
                (shape, _), = tagged(rg, 2)
                assert shape == (cfg.d_model,)


def test_decode_block_writes_its_cache_rows_as_the_reference_does():
    r, t = graphs("phi4-mini-3.8b", "decode")
    rs = [n for n in r.blocks[0].fwd if n.kind == "scatter"]
    ts = [n for n in t.blocks[0].fwd if n.kind == "scatter"]
    assert len(rs) == len(ts) == 2
    for a, b in zip(rs, ts):
        assert a.attrs["operand_bytes"] == b.attrs["operand_bytes"] == 8 * 2048 * 8 * 128 * 2
        assert b.bytes_in == b.bytes_out == pytest.approx(a.bytes_in, rel=0.01)
    att = next(n for n in t.blocks[0].fwd if n.kind == "attention")
    assert {d for d in att.deps if d.startswith("scatter")} == {n.name for n in ts}


def _node_multiset(mg):
    return collections.Counter(
        (b.kind, which, n.kind, n.dtype, n.flops, n.bytes_in, n.bytes_out, tuple(n.out_shape),
         tuple(sorted((k, str(v)) for k, v in n.attrs.items())))
        for b in mg.all_blocks() for which in ("fwd", "joint")
        for n in (getattr(b, which) or ()))


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "olmoe-1b-7b", "deepseek-v3-671b"])
def test_folding_bmm_transposes_leaves_the_dense_and_moe_graphs_as_they_were(
        arch, mode, monkeypatch):
    """The fold of a ``permute``/``transpose`` that only feeds batched
    products (``tracer._bmm_transposes``) changes no node of the dense and
    MoE graphs; it changes deepseek's absorbed decode only, whose five
    remaining transposes are the reference's."""
    B, S, cl = SHAPES[mode]
    cfg = t_config(arch)
    if arch == "deepseek-v3-671b":
        # one layer is enough: the graphs are one a block kind
        cfg = cfg.replace(num_layers=1)
    folded = t_ingest.block_graphs(cfg, B, S, mode, cache_len=cl)
    monkeypatch.setattr(t_tracer, "_bmm_transposes", lambda gm, phase: set())
    unfolded = t_ingest.block_graphs(cfg, B, S, mode, cache_len=cl)
    if arch == "deepseek-v3-671b" and mode == "decode":
        fold, unfold = folded.blocks[0].fwd, unfolded.blocks[0].fwd
        assert len(unfold) - len(fold) == 8       # the operand views of the five products
        tr = sorted(n.total_bytes for n in fold if n.kind == "transpose")
        r, _ = graphs(arch, mode)
        assert tr == sorted(n.total_bytes for n in r.blocks[0].fwd if n.kind == "transpose")
        assert sum(tr) / 2 == 20_185_088          # 40.4 MB read and written
    else:
        assert _node_multiset(folded) == _node_multiset(unfolded)


def test_head_keeps_the_reference_transpose_of_the_embedding():
    for mode in ("prefill", "decode"):
        r, t = graphs("phi4-mini-3.8b", mode)
        rt = [n for n in r.head.fwd if n.kind == "transpose"]
        tt = [n for n in t.head.fwd if n.kind == "transpose"]
        assert [(n.out_shape, n.bytes_in, n.bytes_out) for n in rt] == \
            [(n.out_shape, n.bytes_in, n.bytes_out) for n in tt]


# ---------------- tracer twins ----------------

def _mlp():
    F = 512

    def rf(x, w1, w2):
        return jax.nn.silu(x @ w1) @ w2

    def tf(x, w1, w2):
        return torch.nn.functional.silu(x @ w1) @ w2

    rg = r_tracer.trace(rf, jax.ShapeDtypeStruct((64, 256), jnp.float32),
                        jax.ShapeDtypeStruct((256, F), jnp.float32),
                        jax.ShapeDtypeStruct((F, 256), jnp.float32))
    tg = t_tracer.trace(tf, torch.empty(64, 256), torch.empty(256, F), torch.empty(F, 256))
    return rg, tg


def test_trace_flops_exact():
    rg, tg = _mlp()
    assert tg.by_kind()["matmul"] == rg.by_kind()["matmul"] == 2 * 64 * 256 * 512 * 2
    assert _core(rg) == _core(tg)


def test_trace_grad_matches_reference_products():
    def rf(x, w1, w2):
        return jax.nn.silu(x @ w1) @ w2

    def tf(x, w1, w2):
        return torch.nn.functional.silu(x @ w1) @ w2

    rj = r_tracer.trace_grad(rf, jax.ShapeDtypeStruct((64, 256), jnp.float32),
                             jax.ShapeDtypeStruct((256, 512), jnp.float32),
                             jax.ShapeDtypeStruct((512, 256), jnp.float32))
    tj = t_tracer.trace_grad(tf, torch.empty(64, 256), torch.empty(256, 512),
                             torch.empty(512, 256))
    assert _core(rj, unordered_mn=True) == _core(tj, unordered_mn=True)
    assert {n.phase for n in tj} == {"bwd"}


def test_scan_repeat_multiplier():
    """The reference multiplies a ``lax.scan`` body by its length.  A loop
    through the port's ``layers.scan`` is traced once under the ingest
    (``stubs.ingest_scan``): one product node with repeat 9, forward and
    joint, as the reference's.  A plain Python loop unrolls into as many
    nodes and the total is the same; a model's depth becomes a block's
    ``repeat`` in both packages."""
    from repro_torch.models import layers as TL

    def rf(x, w):
        def body(c, _):
            return c @ w, None
        return jax.lax.scan(body, x, None, length=9)[0]

    def tf(x, w):
        for _ in range(9):
            x = x @ w
        return x

    def tf_scan(x, w):
        return TL.scan(lambda c, _: (c @ w, None), x, None, length=9)[0]

    args = (jax.ShapeDtypeStruct((32, 32), jnp.float32),) * 2
    rg, rj = r_tracer.trace(rf, *args), r_tracer.trace_grad(rf, *args)
    tg = t_tracer.trace(tf, torch.empty(32, 32), torch.empty(32, 32))
    assert tg.total("flops") == rg.total("flops") == 9 * 2 * 32 * 32 * 32
    assert sum(1 for n in tg if n.kind == "matmul") == 9
    with stubs.ingest_scan():
        sg = t_tracer.trace(tf_scan, torch.empty(32, 32), torch.empty(32, 32))
        sj = t_tracer.trace_grad(tf_scan, torch.empty(32, 32), torch.empty(32, 32))
    assert _core(sg) == _core(rg) == collections.Counter({
        ("matmul", (32, 32, 32), None, 2.0 * 32 ** 3, 9, "fwd"): 1})
    assert _core(sj, unordered_mn=True) == _core(rj, unordered_mn=True)
    assert sum(_core(sj).values()) == 3
    for a, b in ((sg, rg), (sj, rj)):
        assert a.total("flops", pred=lambda n: n.kind == "matmul") == \
            b.total("flops", pred=lambda n: n.kind == "matmul")
    # eager, the helper is the loop
    x, w = torch.randn(4, 4, dtype=torch.float64), torch.randn(4, 4, dtype=torch.float64)
    assert torch.equal(tf_scan(x, w), tf(x, w))
    cfg_r, cfg_t = (c("phi4-mini-3.8b").replace(num_layers=9) for c in (r_config, t_config))
    r = r_ingest.block_graphs(cfg_r, 1, 16, "prefill")
    t = t_ingest.block_graphs(cfg_t, 1, 16, "prefill")
    assert [b.repeat for b in r.all_blocks()] == [b.repeat for b in t.all_blocks()] == [9, 1]


def test_traced_loop_backward_stays_between_its_marks():
    """In a joint graph the step's backward lies between the mirrored marks
    (``scan_exit``'s backward opens them, ``scan_enter``'s closes them), and
    no node from outside the loop is scheduled there, though the loop reads
    a tensor made before it that is read after it too: autograd runs the
    ready node of the highest sequence number first (``core/stubs.py``).
    Inside: the step's forward and backward ops only; outside: the tanh
    before the loop, the exp after it and their backward ops."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from repro_torch.models import layers as TL

    def f(x, w, xs):
        a = torch.tanh(x)

        def body(c, x_t):
            c = torch.sigmoid(c @ w + x_t)
            return c, c * 2.0

        c, ys = TL.scan(body, a, xs)
        return (c * a).sum() + torch.exp(ys).sum()

    def joint(x, w, xs):
        return torch.autograd.grad(f(x, w, xs), (x, w, xs))

    with stubs.ingest_scan():
        gm = make_fx(joint, tracing_mode="fake")(
            *(torch.empty(s).requires_grad_() for s in ((4, 8), (8, 8), (5, 4, 8))))
    ops = [t._schema.name.split("::")[-1] for t in (n.target for n in gm.graph.nodes)
           if isinstance(t, torch._ops.OpOverload)]
    marks = [i for i, op in enumerate(ops) if op in stubs.SCAN_MARKS]
    assert [ops[i] for i in marks] == ["scan_enter", "scan_exit"] * 2
    inside = set(ops[marks[0] + 1:marks[1]]) | set(ops[marks[2] + 1:marks[3]])
    outside = set(ops[:marks[0]] + ops[marks[1] + 1:marks[2]] + ops[marks[3] + 1:])
    assert {"mm", "sigmoid", "sigmoid_backward"} <= inside
    assert not inside & {"tanh", "tanh_backward", "exp"}
    assert {"tanh", "tanh_backward", "exp"} <= outside
    assert not outside & {"mm", "sigmoid", "sigmoid_backward"}


def test_byte_rules_slice_reads_what_it_extracts_scatter_updates_in_place():
    def f(table, idx, buf, rows):
        x = table[idx]                                  # gather
        y = table[:4]                                   # slice
        buf[rows] = x                                   # index_put_ (in place)
        return y * 2, buf

    g = t_tracer.trace(f, torch.empty(1000, 64), torch.zeros(8, dtype=torch.long),
                       torch.empty(100, 64), torch.zeros(8, dtype=torch.long), coalesce=False)
    by = {n.kind: n for n in g}
    assert by["gather"].bytes_in == by["gather"].bytes_out == 8 * 64 * 4
    sl = next(n for n in g if n.kind == "copy" and n.out_shape == (4, 64))
    assert sl.bytes_in == sl.bytes_out == 4 * 64 * 4
    sc = by["scatter"]
    assert sc.attrs["operand_bytes"] == 100 * 64 * 4
    assert sc.bytes_in == sc.bytes_out == 8 * 64 * 4 + 8 * 8
    assert by["gather"].name in sc.deps


def test_coalesce_elementwise_matches_reference():
    def build(G):
        g = G("c")
        a = g.op("elementwise", out_shape=(4, 4), flops=16, bytes_in=64, bytes_out=64)
        b = g.op("copy", deps=[a.name], out_shape=(16,), bytes_in=64, bytes_out=64)
        c = g.op("elementwise", deps=[b.name], out_shape=(16,), flops=16, bytes_in=64, bytes_out=32)
        m = g.op("matmul", deps=[c.name], flops=1e3, attrs={"mm_dims": (4, 4, 4)})
        d = g.op("elementwise", deps=[m.name, a.name], flops=8, bytes_out=16)
        g.op("elementwise", deps=[d.name], flops=8, bytes_out=8)
        return g

    def tup(g):
        return [(n.name, n.kind, tuple(n.deps), n.flops, n.bytes_in, n.bytes_out, n.out_shape)
                for n in g.nodes.values()]

    assert tup(r_tracer.coalesce_elementwise(build(RGraph))) == \
        tup(t_tracer.coalesce_elementwise(build(TGraph)))


# ---------------- attention stub ----------------

def test_attention_is_one_node_forward_and_one_backward():
    q, k = torch.empty(2, 16, 2, 3, 64), torch.empty(2, 16, 2, 64)

    def f(q, k, v):
        return stubs.attention_stub(q, k, v, causal=True)

    fwd = t_tracer.trace(f, q, k, k)
    joint = t_tracer.trace_grad(f, q, k, k)
    fa = [n for n in fwd if n.kind == "attention"]
    ja = [n for n in joint if n.kind == "attention"]
    assert len(fa) == 1 and len(ja) == 2
    want = stubs.attention_flops(q.shape, k.shape, causal=True, window=0)
    assert fa[0].flops == want and sorted(n.flops for n in ja) == [want, 2.5 * want]
    assert fa[0].attrs == {"attn_dims": (2, 6, 16, 16, 64), "causal": True, "window": 0, "G": 3}
    with pytest.raises(NotImplementedError):
        stubs.charon_attention(q, k, k, True, 0)        # never executed


def test_ingest_attention_swaps_the_layer_and_restores_it():
    from repro_torch.models import layers as L
    orig = L.attention
    with stubs.ingest_attention():
        assert L.attention is stubs.attention_stub
    assert L.attention is orig


def test_attention_flops_match_reference():
    from repro.core.stubs import attention_flops as r_flops
    for shape, vshape, causal, window in (((1, 512, 8, 3, 128), (1, 512, 8, 128), True, 0),
                                          ((8, 1, 8, 3, 128), (8, 2048, 8, 128), False, 0),
                                          ((2, 64, 4, 2, 64), (2, 64, 4, 64), True, 16)):
        assert stubs.attention_flops(shape, vshape, causal=causal, window=window) == \
            r_flops(shape, vshape, causal=causal, window=window)


# ---------------- batch extrapolation ----------------

def _sig(mg):
    return [(bg.kind, bg.repeat,
             [(n.name, n.kind, n.dtype, n.flops, n.bytes_in, n.bytes_out, tuple(n.out_shape),
               tuple(sorted(n.attrs.items())), tuple(n.deps), n.repeat)
              for g in (bg.fwd, bg.joint) if g is not None for n in g.toposort()])
            for bg in mg.all_blocks()]


def test_ingest_extrapolation_verifies_and_extrapolates_as_the_reference():
    stats = {}
    for name, mod, cfg in (("ref", r_ingest, r_config("phi4-mini-3.8b")),
                           ("port", t_ingest, t_config("phi4-mini-3.8b"))):
        mod.ingest_extrapolation_clear()
        try:
            for B in (1, 2, 4, 8, 16, 32, 64):
                a = mod.ingest_graphs(cfg, B, 1, "decode", cache_len=512)
                if name == "port":
                    b = mod.block_graphs(cfg, B, 1, "decode", cache_len=512)
                    assert _sig(a) == _sig(b), f"extrapolation diverged at B={B}"
            stats[name] = mod.ingest_extrapolation_stats()
        finally:
            mod.ingest_extrapolation_clear()
    assert stats["port"] == stats["ref"]
    assert stats["port"]["extrapolated"] >= 2 and stats["port"]["traced"] <= 5


@pytest.mark.parametrize("seq", [(1, 2, 4, 8, 16, 32, 64), (1, 2, 4, 32, 64, 8)],
                         ids=["verified-before-cap-grows", "cap-grows-while-verifying"])
def test_moe_ingest_extrapolation_reads_as_the_reference(seq):
    """olmoe's decode capacity ``max(ceil(B*K/E*1.25), 4)`` is 4 up to B 25 and
    grows after, so it is not affine in B.  Where a cap change meets the
    verification (B 32 after anchors 2 and 4) both packages disable the
    family.  Where it does not, both verify at B 8 and 16 and then extrapolate
    B 32 and 64 with the anchors' cap of 4 (it is 5 and 10): a fault of the
    reference kept for parity (ROADMAP queue C).  Either way the stats and
    the graphs given are the reference's."""
    got = {}
    for name, mod, cfg in (("ref", r_ingest, r_config("olmoe-1b-7b")),
                           ("port", t_ingest, t_config("olmoe-1b-7b"))):
        mod.ingest_extrapolation_clear()
        try:
            caps = []
            for B in seq:
                g = mod.ingest_graphs(cfg, B, 1, "decode", cache_len=512)
                caps.append(next(n.out_shape[1] for n in g.blocks[0].fwd
                                 if n.kind == "elementwise" and len(n.out_shape) == 3
                                 and n.out_shape[::2] == (cfg.num_experts, cfg.moe_d_ff)))
            got[name] = (mod.ingest_extrapolation_stats(), caps)
        finally:
            mod.ingest_extrapolation_clear()
    assert got["port"] == got["ref"]
    stats, caps = got["port"]
    if seq[4] == 16:
        assert stats == {"extrapolated": 2, "traced": 5} and caps == [4] * 7
    else:
        assert stats == {"extrapolated": 0, "traced": 6} and caps == [4, 4, 4, 5, 10, 4]


def test_ingest_key_is_the_reference_key():
    cfg = t_config("gemma-7b")
    assert t_ingest.ingest_key(cfg, 4, 128, "train", 0) == (cfg, 4, 128, "train", 0)


if __name__ == "__main__":
    # The ratios PERF.md records: PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_ingest.py
    for mode in SHAPES:
        for arch in ARCH_IDS:
            r, t = graphs(arch, mode)
            for rb, tb in zip(r.all_blocks(), t.all_blocks()):
                for which in ("fwd", "joint"):
                    rg, tg = getattr(rb, which), getattr(tb, which)
                    if rg is None:
                        continue
                    (rn, rbytes), (tn, tbytes) = _rest(rg), _rest(tg)
                    line = (f"{arch:15s} {mode:7s} {rb.kind}.{which:5s} rest nodes {rn} -> {tn} "
                            f"({tn / rn:.2f}x), bytes x{tbytes / rbytes:.3f}, flops "
                            f"{tg.total('flops') / rg.total('flops') - 1:+.2e}, swapped "
                            f"{sum((_core(tg) - _core(rg)).values())}")
                    if rb.kind in PLAIN_GELU:      # and with the GELU's passes set aside
                        gelu = functools.partial(_gelu_pass, d_ff=t_config(arch).d_ff)
                        (rn, rbytes), (tn, tbytes) = _rest(rg, gelu), _rest(tg, gelu)
                        fl = [g.total("flops", pred=lambda n: not gelu(n)) for g in (rg, tg)]
                        line += (f"; without the GELU passes nodes {tn / rn:.2f}x, bytes "
                                 f"x{tbytes / rbytes:.3f}, flops {fl[1] / fl[0] - 1:+.2e}")
                    print(line)
