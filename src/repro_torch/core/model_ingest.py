"""Model ingestion: ModelConfig -> per-block operator graphs (paper §3.2a).

Charon extracts and simulates a single transformer block per distinct block
kind and extrapolates over depth.  Attention is traced as a single abstract
operator via core/stubs.py.  Each block is the port's own torch code
(``repro_torch.models.model``), traced by ``make_fx`` over FakeTensors with
the kernels' plain versions, one layer's parameters built by ``build_params``
with a FakeTensor creator.  A block's ``repeat`` comes from ``block_cycle``;
a loop inside a block (the xLSTM cells' ``layers.scan``) is traced once and
its nodes carry the loop's length as their ``repeat`` (``core/stubs.py``), as
the reference traces a ``lax.scan``.

All graphs are traced at the *per-data-shard* batch (B_local); the
parallelism passes then rewrite for TP/SP/EP/CP.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.core import tracer
from repro_torch.core.ir import Graph
from repro_torch.core.stubs import ingest_attention, ingest_scan
from repro_torch.models import layers as L
from repro_torch.models.kvcache import _kind_cache
from repro_torch.models.model import apply_block_decode, apply_block_full
from repro_torch.models.params import BLOCK_PARAMS, block_cycle


@dataclass
class BlockGraphs:
    kind: str
    repeat: int                      # how many times this block occurs
    fwd: Graph
    joint: Graph | None = None       # fwd+bwd (train)


@dataclass
class ModelGraphs:
    cfg: ModelConfig
    mode: str
    blocks: list[BlockGraphs]
    head: BlockGraphs | None = None  # embed + final norm + logits (+ loss bwd)
    encoder: BlockGraphs | None = None

    def all_blocks(self):
        out = list(self.blocks)
        if self.encoder:
            out.append(self.encoder)
        if self.head:
            out.append(self.head)
        return out


def ingest_key(cfg: ModelConfig, B_local: int, S: int, mode: str,
               cache_len: int = 0) -> tuple:
    """Memoization key for :func:`block_graphs`.

    ``ModelConfig`` is a frozen dataclass of hashable fields, so the config
    itself is the model fingerprint.  Two calls with equal keys trace
    identical graphs; callers must clone before mutating (the simulator's
    pass pipeline already does)."""
    return (cfg, B_local, S, mode, cache_len)


# --------------------------------------------------------------------------
# Batch extrapolation: Charon's single-block trick applied to the batch axis.
#
# Within one ingest *family* (cfg, S, mode, cache_len) every traced quantity
# is affine in B_local: tensor shapes carry at most one batch factor, so
# every dim, byte count and FLOP count is a + c*B with non-negative dyadic
# coefficients.  Two anchor traces at batch b1, b2 (|b2-b1| a power of two,
# so the coefficient division is exact in binary floating point) determine
# the whole family; the first ``_VERIFY_POINTS`` non-anchor requests are
# still traced directly and compared field-by-field against the
# interpolation — only after those prove bit-exact does the family skip
# tracing.  Any structural or numeric mismatch permanently disables
# extrapolation for the family (silent, correct fallback).
# --------------------------------------------------------------------------

_NODE_NUM_FIELDS = ("flops", "bytes_in", "bytes_out", "comm_bytes")
_NODE_CONST_FIELDS = ("name", "kind", "dtype", "comm_group", "comm_size",
                      "overlappable", "stream", "repeat", "phase")
_VERIFY_POINTS = 2
_FAMILY_MAX = 64                 # runaway backstop, not a tuning knob


@dataclass
class _Family:
    traced: dict = field(default_factory=dict)   # B -> ModelGraphs (direct)
    pair: tuple | None = None                    # anchor (b1, b2)
    verified: int = 0
    disabled: bool = False


_FAMILIES: dict = {}
_EXTRAP_STATS = {"extrapolated": 0, "traced": 0}


def ingest_extrapolation_stats() -> dict:
    return dict(_EXTRAP_STATS)


def ingest_extrapolation_clear() -> None:
    _FAMILIES.clear()
    _EXTRAP_STATS.update(extrapolated=0, traced=0)


def _affine(v1, v2, b1: int, b2: int, B: int):
    """Exact affine reconstruction v(B) from (b1, v1), (b2, v2); None if the
    fit is not an exact non-negative affine function."""
    if isinstance(v1, bool) or isinstance(v2, bool):
        return v1 if v1 == v2 else None
    if isinstance(v1, int) and isinstance(v2, int):
        d = b2 - b1
        if (v2 - v1) % d:
            return None
        c = (v2 - v1) // d
        a = v1 - c * b1
        if c < 0 or a < 0:
            return None
        return a + c * B
    if isinstance(v1, float) and isinstance(v2, float):
        # b2-b1 is a power of two and traced values are dyadic rationals
        # well inside the 53-bit mantissa: every step below is exact
        c = (v2 - v1) / (b2 - b1)
        a = v1 - c * b1
        if c < 0.0 or a < 0.0:
            return None
        return a + c * B
    return v1 if v1 == v2 else None


def _affine_seq(s1, s2, b1, b2, B):
    if len(s1) != len(s2):
        return None
    out = []
    for v1, v2 in zip(s1, s2):
        v = _affine(v1, v2, b1, b2, B)
        if v is None:
            return None
        out.append(v)
    return tuple(out)


def _interp_graph(g1: Graph, g2: Graph, b1: int, b2: int, B: int) -> Graph | None:
    if len(g1) != len(g2):
        return None
    out = Graph(g1.name)
    out._ctr = g1._ctr
    for n1, n2 in zip(g1.nodes.values(), g2.nodes.values()):
        for f in _NODE_CONST_FIELDS:
            if getattr(n1, f) != getattr(n2, f):
                return None
        if n1.deps != n2.deps:
            return None
        n = n1.clone()
        for f in _NODE_NUM_FIELDS:
            v = _affine(getattr(n1, f), getattr(n2, f), b1, b2, B)
            if v is None:
                return None
            setattr(n, f, v)
        shape = _affine_seq(n1.out_shape, n2.out_shape, b1, b2, B)
        if shape is None:
            return None
        n.out_shape = shape
        if set(n1.attrs) != set(n2.attrs):
            return None
        for k, v1 in n1.attrs.items():
            v2 = n2.attrs[k]
            if isinstance(v1, tuple) and isinstance(v2, tuple):
                v = _affine_seq(v1, v2, b1, b2, B)
            elif isinstance(v1, (int, float)) and isinstance(v2, (int, float)):
                v = _affine(v1, v2, b1, b2, B)
            else:
                v = v1 if v1 == v2 else None
            if v is None:
                return None
            n.attrs[k] = v
        out.nodes[n.name] = n
    return out


def _interp_block(bg1: BlockGraphs, bg2: BlockGraphs, b1, b2, B):
    if bg1.kind != bg2.kind or bg1.repeat != bg2.repeat \
            or (bg1.joint is None) != (bg2.joint is None):
        return None
    fwd = _interp_graph(bg1.fwd, bg2.fwd, b1, b2, B)
    if fwd is None:
        return None
    joint = None
    if bg1.joint is not None:
        joint = _interp_graph(bg1.joint, bg2.joint, b1, b2, B)
        if joint is None:
            return None
    return BlockGraphs(bg1.kind, bg1.repeat, fwd, joint)


def _interp_model(mg1: ModelGraphs, mg2: ModelGraphs, b1, b2, B):
    if len(mg1.blocks) != len(mg2.blocks) \
            or (mg1.head is None) != (mg2.head is None) \
            or (mg1.encoder is None) != (mg2.encoder is None):
        return None
    blocks = []
    for bg1, bg2 in zip(mg1.blocks, mg2.blocks):
        bg = _interp_block(bg1, bg2, b1, b2, B)
        if bg is None:
            return None
        blocks.append(bg)
    head = encoder = None
    if mg1.head is not None:
        head = _interp_block(mg1.head, mg2.head, b1, b2, B)
        if head is None:
            return None
    if mg1.encoder is not None:
        encoder = _interp_block(mg1.encoder, mg2.encoder, b1, b2, B)
        if encoder is None:
            return None
    return ModelGraphs(mg1.cfg, mg1.mode, blocks, head, encoder)


def _graphs_match(a: ModelGraphs, b: ModelGraphs) -> bool:
    def sig(mg):
        out = []
        for bg in mg.all_blocks():
            for g in (bg.fwd, bg.joint):
                if g is None:
                    continue
                out.append((bg.kind, bg.repeat,
                            [(n.name, n.kind, n.dtype, n.flops, n.bytes_in,
                              n.bytes_out, n.comm_bytes, n.comm_group,
                              n.comm_size, n.overlappable, n.stream,
                              n.repeat, n.phase, tuple(n.out_shape),
                              tuple(sorted(n.attrs.items())), tuple(n.deps))
                             for n in g.nodes.values()]))
        return out
    return sig(a) == sig(b)


def ingest_graphs(cfg: ModelConfig, B_local: int, S: int, mode: str,
                  *, cache_len: int = 0) -> ModelGraphs:
    """:func:`block_graphs` with verified batch extrapolation (the
    simulator's ingest builder).  Callers must treat results as immutable —
    the same contract the per-simulator ingest cache already imposes."""
    key = (cfg, S, mode, cache_len)
    fam = _FAMILIES.get(key)
    if fam is None:
        if len(_FAMILIES) >= _FAMILY_MAX:
            _FAMILIES.clear()
        fam = _FAMILIES[key] = _Family()
    mg = fam.traced.get(B_local)
    if mg is not None:
        return mg
    interp = None
    # B_local == 1 is never anchored or interpolated: degenerate batch dims
    # genuinely change trace structure (e.g. the train head's loss backward
    # collapses its batch reduction), so batch 1 always traces directly
    if B_local > 1 and not fam.disabled and fam.pair is not None:
        b1, b2 = fam.pair
        interp = _interp_model(fam.traced[b1], fam.traced[b2], b1, b2, B_local)
        if interp is None:
            fam.disabled = True
        elif fam.verified >= _VERIFY_POINTS:
            _EXTRAP_STATS["extrapolated"] += 1
            return interp
    _EXTRAP_STATS["traced"] += 1
    mg = block_graphs(cfg, B_local, S, mode, cache_len=cache_len)
    if not fam.disabled:
        if interp is not None:
            if _graphs_match(interp, mg):
                fam.verified += 1
            else:
                fam.disabled = True
        elif fam.pair is None and B_local > 1:
            for b in sorted(fam.traced):
                d = B_local - b
                if b > 1 and d > 0 and (d & (d - 1)) == 0:  # 2^k spacing
                    fam.pair = (b, B_local)
                    break
        fam.traced[B_local] = mg
    return mg


def _tag_moe(g: Graph, cfg: ModelConfig) -> Graph:
    if cfg.num_experts:
        for n in g:
            if n.kind == "matmul" and n.out_shape and n.out_shape[0] == cfg.num_experts:
                n.attrs["moe_expert"] = True
    return g


def _fake_layer_params(cfg: ModelConfig, kind: str):
    """One layer's parameters of block ``kind`` as FakeTensors (call inside
    a FakeTensorMode)."""
    dt = torch_dtype(cfg.param_dtype)
    return BLOCK_PARAMS[kind](cfg, lambda path, shape, logical, fan_in:
                              torch.empty(shape, dtype=dt), ("blocks", "0", kind))


def _full_fn(cfg: ModelConfig, kind: str, with_enc: bool = False):
    """The block as a traced function of (params, h, pending, positions[,
    the encoder's output, which Whisper's decoder block reads])."""
    def fwd_fn(p, x, pend, positions, *enc):
        aux = {"positions": positions, "cache_len": 0, "plain": True}
        if with_enc:
            aux["enc_out"] = enc[0]
        h, f, _, _ = apply_block_full(cfg, kind, p, x, pend, aux, False)
        return h, f
    return fwd_fn


def _decode_fn(cfg: ModelConfig, kind: str):
    def dec_fn(p, x, pend, cache, pos):
        aux = {"pos": pos, "decode_positions": pos[:, None], "plain": True}
        h, f, _ = apply_block_decode(cfg, kind, p, x, pend, cache, aux)
        return h, f
    return dec_fn


def block_graphs(cfg: ModelConfig, B_local: int, S: int, mode: str,
                 *, cache_len: int = 0) -> ModelGraphs:
    """Trace one graph per distinct block kind (+ embed/head, + Whisper's
    encoder).  The dense decoders, the MoE decoders (GQA and MLA), the
    RG-LRU hybrid, the xLSTM stack, the Whisper encoder-decoder and the VLM
    backbone are ported; a full-sequence block of M-RoPE takes positions
    (B_local, S, 3), as the reference's does, and gathers each frequency's
    section in one node; a decode block takes ``pos[:, None]``, broadcast to
    the three sections as the reference broadcasts it.  An encoder-decoder's
    decoder block is traced with the encoder's output ``(B, encoder_seq,
    D)`` as an argument (differentiated in the joint graph, as the
    reference's ``vjp`` is), and its encoder is one ``enc`` block repeated
    ``encoder_layers`` times: a forward graph in prefill and train, a joint
    graph in train, none in decode (the cache holds the encoder's keys and
    values).  A decode graph reads the cache of its own kind, as the
    reference builds it: a ring of ``cache_len`` rows, ``min(cache_len,
    window)`` for ``griffin_attn``, ``griffin_rec``'s state, the mLSTM's conv
    state and float32 matrix memory, the sLSTM's four float32 states,
    Whisper's ring beside its ``ck``/``cv`` of ``encoder_seq`` rows (read,
    never written).  The xLSTM cells' loops are traced once, their nodes at
    the loop's length (the mLSTM's chunks, the sLSTM's steps).  The MoE
    block's expert products are tagged ``moe_expert`` by ``_tag_moe``, as in
    the reference."""
    cycle, n_cycles, tail = block_cycle(cfg)
    counts: dict[int, int] = {}
    kinds: dict[int, str] = {}
    for j, k in enumerate(cycle):
        counts[j] = n_cycles + (1 if j < len(tail) else 0)
        kinds[j] = k
    dt = torch_dtype(cfg.dtype)
    pdt = torch_dtype(cfg.param_dtype)
    D = cfg.d_model
    fake = FakeTensorMode()

    blocks: list[BlockGraphs] = []
    with ingest_attention(), ingest_scan():
        seen_kinds: dict[str, BlockGraphs] = {}
        for j, kind in kinds.items():
            if kind in seen_kinds:
                seen_kinds[kind].repeat += counts[j]
                continue
            # Each block takes the residual stream ``h`` and the add its
            # predecessor left pending and returns ``(h, f)`` unsummed (the
            # port carries the add into the next norm), so one traced block
            # holds its two residual adds, as the reference's block does.
            # RoPE tables are left to the block, as the reference computes them.
            if mode == "decode":
                with fake:
                    p = _fake_layer_params(cfg, kind)
                    cache = _kind_cache(cfg, kind, lambda s, logical, d: torch.empty(s, dtype=d),
                                        B_local, cache_len or S)
                    x1 = torch.empty((B_local, 1, D), dtype=dt)
                    pend = torch.empty((B_local, 1, D), dtype=dt)
                    posv = torch.empty((B_local,), dtype=torch.int32)

                fwd = _tag_moe(tracer.trace(_decode_fn(cfg, kind), p, x1, pend, cache, posv,
                                            name=f"{kind}.decode"), cfg)
                bg = BlockGraphs(kind, counts[j], fwd)
            else:
                with fake:
                    p = _fake_layer_params(cfg, kind)
                    x = torch.empty((B_local, S, D), dtype=dt)
                    pend = torch.empty((B_local, S, D), dtype=dt)
                    # M-RoPE takes a (t, h, w) triple a token, as the reference's
                    # traced block does
                    positions = torch.empty((B_local, S, 3) if cfg.rope_style == "mrope"
                                            else (B_local, S), dtype=torch.long)
                    enc = (torch.empty((B_local, cfg.encoder_seq, D), dtype=dt),) \
                        if cfg.cross_attention else ()

                fwd_fn = _full_fn(cfg, kind, with_enc=bool(enc))
                args = (p, x, pend, positions, *enc)
                fwd = _tag_moe(tracer.trace(fwd_fn, *args, name=f"{kind}.fwd"), cfg)
                joint = _tag_moe(tracer.trace_grad(fwd_fn, *args, name=f"{kind}.joint"),
                                 cfg) if mode == "train" else None
                bg = BlockGraphs(kind, counts[j], fwd, joint)
            seen_kinds[kind] = bg
            blocks.append(bg)

        # encoder (whisper): one layer traced, repeated encoder_layers times
        encoder = None
        if cfg.encoder_layers > 0 and mode != "decode":
            E = cfg.encoder_seq
            with fake:
                p = _fake_layer_params(cfg, "enc")
                xe = torch.empty((B_local, E, D), dtype=dt)
                pend = torch.empty((B_local, E, D), dtype=dt)
                pe = torch.empty((B_local, E), dtype=torch.long)
            enc_fn = _full_fn(cfg, "enc")
            efwd = tracer.trace(enc_fn, p, xe, pend, pe, name="enc.fwd")
            ejoint = tracer.trace_grad(enc_fn, p, xe, pend, pe, name="enc.joint") \
                if mode == "train" else None
            encoder = BlockGraphs("enc", cfg.encoder_layers, efwd, ejoint)

        # embed + head (+ CE loss for train), the reference's operations
        S_head = 1 if mode == "decode" else S
        with fake:
            tok = torch.empty((B_local, S_head), dtype=torch.long)
            emb = torch.empty((cfg.vocab_size, D), dtype=pdt)
            nrm = {"w": torch.empty((D,), dtype=pdt)}
            if cfg.norm == "layernorm":
                nrm["b"] = torch.empty((D,), dtype=pdt)
            h = torch.empty((B_local, S_head, D), dtype=dt)

        def head_fn(emb_w, nrm, h, tokens):
            x = emb_w[tokens].to(dt)
            hh = h + x * 0  # keep both paths alive
            hh = L.apply_norm(cfg, nrm, hh, plain=True)
            logits = (hh @ emb_w.t().to(dt)).float()
            if mode == "train":
                # the port's loss (``training.cross_entropy``): log-softmax
                # and the labels' negative log-likelihood
                logp = torch.log_softmax(logits, dim=-1)
                return F.nll_loss(logp.flatten(0, 1), tokens.clamp_min(0).flatten())
            return logits

        hf = tracer.trace(head_fn, emb, nrm, h, tok, name="head.fwd")
        hj = tracer.trace_grad(head_fn, emb, nrm, h, tok,
                               name="head.joint") if mode == "train" else None
        head = BlockGraphs("head", 1, hf, hj)

    return ModelGraphs(cfg, mode, blocks, head, encoder)
