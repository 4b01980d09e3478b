"""Model assembly for the dense decoders, the MoE decoders, with GQA or with
MLA attention, the RG-LRU hybrid, the xLSTM stack, the Whisper
encoder-decoder and the VLM backbone (M-RoPE, patch embeddings overlaid on
the first rows) (counterpart of ``repro/models/model.py``).

``Model`` exposes:
  * ``init(generator)``                    — concrete params on the model's device
  * ``forward(params, batch)``             — full-sequence logits, differentiable
  * ``prefill(params, batch, cache_len)``  — logits + populated KV cache
  * ``decode_step(params, cache, batch)``  — one token against the cache
  * ``encode(params, frame_embeds)``       — Whisper's encoder over its frames

The reference scans over depth-stacked parameters under ``jit``; here the
stack is a Python loop over per-layer dicts and everything runs eagerly.
Where the reference rebuilds an array (``cache.at[...].set``), the port
writes in place and says so.  The reference's logical sharding constraints
sit at its places (``shard``): the identity on plain tensors, a
redistribution of a DTensor under an active env (the dry run).  ``forward``
records for autograd (the loss of ``training.train_step`` differentiates it,
as the reference's ``forward`` is what ``make_loss_fn`` differentiates);
``prefill`` and ``decode_step`` never do.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.distributed.sharding import (
    axis_size, is_dtensor, logical_constraint as shard, redistribute,
)
from repro_torch.models import layers as L
from repro_torch.models.kvcache import SLSTM_STATE, cache_len_of, ring_rows
from repro_torch.models.params import init_params, layer_kinds

Tree = Any


def resolve_device(device) -> torch.device:
    """``None`` means the card: entry points run on CUDA unless the caller
    asks for the CPU, and raise where there is no card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is available; "
                "pass device='cpu' to run on the CPU on purpose")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for but CUDA is not available")
    return device


def _heads_shardable(cfg: ModelConfig) -> bool:
    return cfg.num_kv_heads % axis_size("model") == 0


# ==========================================================================
# Attention blocks
# ==========================================================================

def _proj(p, name, x, dtype):
    """(B, S, H, Dh): ``x`` through the head projection ``p[name]`` (its
    bias added where it has one), in ``dtype``."""
    B, S, D = x.shape
    w = L.flat_ready(p[name]["w"].to(dtype), 1, 3)        # (D, H, Dh)
    y = L.matmul(x, w.reshape(D, -1)).reshape(B, S, w.shape[1], w.shape[2])
    if "b" in p[name]:
        y = y + p[name]["b"].to(dtype)
    return y


def _qkv(cfg, p, x, positions, *, rope=True, rope_tables=None):
    q, k, v = (_proj(p, name, x, x.dtype) for name in ("q", "k", "v"))
    if rope and is_dtensor(q):
        # each on its own, as the reference: a concatenation along the
        # sharded heads would gather them
        return (L.apply_rope(cfg, q, positions, tables=rope_tables),
                L.apply_rope(cfg, k, positions, tables=rope_tables), v)
    if rope:
        # one pass over q and k together; the two results are views of it
        qk = L.apply_rope(cfg, torch.cat([q, k], dim=2), positions, tables=rope_tables)
        q, k = qk[:, :, :q.shape[2]], qk[:, :, q.shape[2]:]
    return q, k, v


def _attn_out(p, o, x_dtype):
    B, S, H, Dh = o.shape
    w = L.rows(p["o"]["w"].to(x_dtype))                   # (H, Dh, D)
    return L.matmul(o.reshape(B, S, H * Dh), w.reshape(H * Dh, -1))


def _attn_shardings(cfg):
    """Megatron head-TP when kv heads divide the model axis; otherwise
    Ulysses-style context parallelism (q-sequence sharded, kv replicated)."""
    if _heads_shardable(cfg):
        q_ax = ("batch", "seq", "kv_heads", "q_per_kv", "head_dim")
        kv_ax = ("batch", "seq", "kv_heads", "head_dim")
    else:
        q_ax = ("batch", "seq_cp", "kv_heads", "q_per_kv", "head_dim")
        kv_ax = ("batch", None, "kv_heads", "head_dim")
    return q_ax, kv_ax


def gqa_full(cfg, p, x, positions, *, causal=True, window=0, rope=True, rope_tables=None,
             plain=False):
    """Full-sequence GQA/MQA/MHA attention.  On the card this is the
    flash-attention kernel, reading q, k and v where the projections left
    them; elsewhere the reference's strategies, with its q and kv blocks."""
    B, S, _ = x.shape
    Hkv, G, Dh = cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim
    q, k, v = _qkv(cfg, p, x, positions, rope=rope, rope_tables=rope_tables)
    q = q.reshape(B, S, Hkv, G, Dh)
    q_ax, kv_ax = _attn_shardings(cfg)
    q = shard(q, q_ax)
    k = shard(k, kv_ax)
    v = shard(v, kv_ax)
    # context-parallel runs keep q sequence-sharded -> single q block; TP
    # runs use q blocks with static causal truncation
    q_block = S if not _heads_shardable(cfg) else 2048
    o = L.attention(q, k, v, q_offset=0, causal=causal, window=window, q_block=q_block,
                    kv_block=cfg.attn_kv_block, score_dtype=torch_dtype(cfg.attn_score_dtype),
                    plain=plain)
    o = o.reshape(B, S, cfg.num_heads, Dh)
    return _attn_out(p, o, x.dtype), (k, v)


def decode_indices(pos: torch.Tensor, T: int):
    """(batch index, ring slot, valid length) of one decode step; the same for
    every layer, so a model call computes them once."""
    b_idx = torch.arange(pos.shape[0], device=pos.device)
    slot = (pos % T).long()
    valid = torch.clamp(pos + 1, max=T).to(torch.int32)
    return b_idx, slot, valid


def write_rows(t: torch.Tensor, b_idx: torch.Tensor, slot: torch.Tensor, rows: torch.Tensor):
    """``t[b_idx, slot] = rows`` in place (row ``slot[b]`` of sequence ``b``
    of a ring cache); returns ``t``.  On a DTensor (the dry run) the write
    is local to each rank's shard: a batch shard writes its own sequences,
    and where the ring's rows are sharded only the rank holding the slot
    writes (the others write back what they hold)."""
    if not is_dtensor(t):
        t[b_idx, slot] = rows
        return t
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = t.device_mesh
    row_pl = tuple(Replicate() if p.is_shard(1) else Shard(p.dim - 1) if p.is_shard() and p.dim > 1
                   else p for p in t.placements)
    slot_pl = tuple(p if p.is_shard(0) else Replicate() for p in t.placements)
    t_dims = [i for i, p in enumerate(t.placements) if p.is_shard(1)]
    off = 0
    if t_dims:
        coord = mesh.get_coordinate()
        for i in t_dims:
            off = off * mesh.size(i) + coord[i]

    def body(tl, sl, rl):
        bl = torch.arange(tl.shape[0], device=tl.device)
        if t_dims:
            Tl = tl.shape[1]
            local = sl - off * Tl
            own = (local >= 0) & (local < Tl)
            local = local.clamp(0, Tl - 1)
            rl = torch.where(own.view(-1, *([1] * (rl.ndim - 1))), rl, tl[bl, local])
            sl = local
        tl[bl, sl] = rl
        return tl

    return local_map(body, out_placements=list(t.placements),
                     in_placements=(t.placements, slot_pl, row_pl), device_mesh=mesh)(
        t, redistribute(slot, mesh, slot_pl), redistribute(rows, mesh, row_pl))


def _decode_strategy(x: torch.Tensor) -> str:
    """The reference's decode attention is ``dense``; on the card the kernel."""
    return "auto" if x.device.type == "cuda" else "dense"


def gqa_decode(cfg, p, x, pos, cache, *, rope=True, positions=None, rope_tables=None,
               indices=None, plain=False):
    """Single-token attention against a per-slot ring cache {'k','v'}.

    ``pos``: (B,) int32 — per-sequence absolute position (continuous batching
    serves requests at different depths in one batch).  The new K/V row is
    written into the cache **in place** (the reference builds new arrays with
    ``.at[].set``); the returned dict holds the same tensors.  On the card
    the attention is the split-KV decode kernel, reading the ``(B,T,Hkv,D)``
    cache through strides."""
    B = x.shape[0]
    Hkv, G, Dh = cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim
    T = cache["k"].shape[1]
    if positions is None:
        positions = pos[:, None]
    q, k_new, v_new = _qkv(cfg, p, x, positions, rope=rope, rope_tables=rope_tables)
    q = q.reshape(B, 1, Hkv, G, Dh)
    b_idx, slot, valid = indices if indices is not None else decode_indices(pos, T)
    k = write_rows(cache["k"], b_idx, slot, k_new[:, 0])      # in place
    v = write_rows(cache["v"], b_idx, slot, v_new[:, 0])
    if _heads_shardable(cfg):
        kv_ax = ("batch", None, "kv_heads", "head_dim")
    else:
        kv_ax = ("batch", "kv_seq", None, "head_dim")
    k, v = shard(k, kv_ax), shard(v, kv_ax)
    o = L.attention(q, k, v, q_offset=0, causal=False, kv_valid_len=valid,
                    strategy=_decode_strategy(x), plain=plain)
    o = o.reshape(B, 1, cfg.num_heads, Dh)
    return _attn_out(p, o, x.dtype), {"k": k, "v": v}


def cross_full(cfg, p, x, enc_out, *, plain=False):
    """Cross attention (Whisper's decoder): q from ``x``, k and v from the
    encoder's output, every query seeing every encoder row.  On the card this
    is K1 with Sq the prompt's length and Sk the encoder's rows, not causal.
    Returns the output and ``(k, v)``, which the decode cache keeps as
    ``ck``/``cv``."""
    B, S, _ = x.shape
    Hkv, G, Dh = cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim
    q = _proj(p, "q", x, x.dtype).reshape(B, S, Hkv, G, Dh)
    k, v = _proj(p, "k", enc_out, x.dtype), _proj(p, "v", enc_out, x.dtype)
    o = L.attention(q, k, v, q_offset=0, causal=False, plain=plain)
    return _attn_out(p, o.reshape(B, S, cfg.num_heads, Dh), x.dtype), (k, v)


def cross_decode(cfg, p, x, cache, *, plain=False):
    """One token's cross attention against the cache's ``ck``/``cv`` (the
    encoder's rows, every one valid), read where they lie and never written.
    On the card this is K2 with the full valid length a row."""
    B = x.shape[0]
    Hkv, G, Dh = cfg.num_kv_heads, cfg.q_per_kv, cfg.head_dim
    q = _proj(p, "q", x, x.dtype).reshape(B, 1, Hkv, G, Dh)
    o = L.attention(q, cache["ck"], cache["cv"], q_offset=0, causal=False,
                    strategy=_decode_strategy(x), plain=plain)
    return _attn_out(p, o.reshape(B, 1, cfg.num_heads, Dh), x.dtype)


# --- MLA (deepseek) -------------------------------------------------------

def _mla_q(cfg, p, x, plain):
    """(B,S,H,dn+dr): the query's down projection, its K3 norm (``q_norm``,
    no residual) and its up projection, RoPE not applied yet."""
    B, S, _ = x.shape
    cq = L.rmsnorm(p["q_norm"]["w"], L.matmul(x, p["dq"]["w"].to(x.dtype)), eps=cfg.norm_eps,
                   plain=plain)
    w = L.flat_ready(p["uq"]["w"].to(x.dtype), 1, 3)      # (qr, H, dn+dr)
    return L.matmul(cq, w.reshape(w.shape[0], -1)).reshape(B, S, w.shape[1], w.shape[2])


def _mla_latent(cfg, p, x, positions, rope_tables, plain):
    """(ckv (B,S,kv_lora_rank), k_rope (B,S,1,dr)): the compressed latent
    (down projection and its K3 norm ``kv_norm``) and the rotary key that
    every head shares, which is what the cache keeps."""
    ckv = L.rmsnorm(p["kv_norm"]["w"], L.matmul(x, p["dkv"]["w"].to(x.dtype)), eps=cfg.norm_eps,
                    plain=plain)
    kr = L.apply_rope(cfg, L.matmul(x, p["kr"]["w"].to(x.dtype))[:, :, None, :], positions,
                      tables=rope_tables)
    return ckv, kr


def mla_full(cfg, p, x, positions, *, rope_tables=None, plain=False):
    """Expanded-form MLA for train and prefill; returns the compressed cache
    parts ``(ckv, k_rope)``.  The heads' keys are their up-projected latent
    beside the shared rotary key, so q and k have a head dim of dn + dr and
    v one of dv: on the card this is K1 at (dn + dr, dv), scale 1/sqrt(dn +
    dr), G = 1."""
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = _mla_q(cfg, p, x, plain)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = L.apply_rope(cfg, q_rope, positions, tables=rope_tables)
    ckv, k_rope = _mla_latent(cfg, p, x, positions, rope_tables, plain)
    r = ckv.shape[-1]
    uk, uv = (L.flat_ready(p[n]["w"].to(x.dtype), 1, 3) for n in ("uk", "uv"))
    k_nope = L.matmul(ckv, uk.reshape(r, H * dn)).reshape(B, S, H, dn)
    v = L.matmul(ckv, uv.reshape(r, H * dv)).reshape(B, S, H, dv)
    q_all = torch.cat([q_nope, q_rope], -1).reshape(B, S, H, 1, dn + dr)
    k_all = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], -1)
    q_all = shard(q_all, ("batch", "seq", "heads", None, "head_dim"))
    k_all = shard(k_all, ("batch", "seq", "heads", "head_dim"))
    v = shard(v, ("batch", "seq", "heads", "head_dim"))
    o = L.attention(q_all, k_all, v, q_offset=0, causal=True, scale=1.0 / math.sqrt(dn + dr),
                    score_dtype=torch_dtype(cfg.attn_score_dtype), plain=plain)
    o = o.reshape(B, S, H, dv)
    return _attn_out(p, o, x.dtype), (ckv, k_rope[:, :, 0, :])


def mla_decode(cfg, p, x, pos, cache, *, positions=None, rope_tables=None, indices=None,
               plain=False):
    """Absorbed-form MLA decode on the compressed ``{"ckv", "kr"}`` ring
    cache, whose new rows are written **in place**.  ``W_uk`` is absorbed
    into the query and ``W_uv`` applied after the weighted sum, so the
    scores run over the latent, in float32, outside any kernel (the
    reference's einsums, none of which is a Pallas kernel either).

    Each product is the batched product the reference's einsum contracts,
    with its operands in the same order (the larger first), so both tracers
    see one (M, N, K): torch's ``einsum`` would order them its own way.  Every
    operand is a view that cuBLAS reads where it lies (one of its matrix dims
    of stride 1), so no product copies an operand, and the tracer prices none
    of those views.  Where the reference transposes a product's output into
    its einsum's order (the absorbed query, the two score products, the
    weighted latent, the output: five transposes), the port does too: the
    query's and the latent's as part of the cast that follows, in one pass."""
    B = x.shape[0]
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    T = cache["ckv"].shape[1]
    if positions is None:
        positions = pos[:, None]
    q = _mla_q(cfg, p, x, plain)                          # (B, 1, H, dn+dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = L.apply_rope(cfg, q_rope, positions, tables=rope_tables)
    # absorb W_uk: q_lat[h] = W_uk[h] q_nope[h], (H, r, dn) @ (H, dn, B) -> (H, r, B)
    uk = p["uk"]["w"].to(x.dtype)                         # (r, H, dn)
    q_lat = torch.bmm(uk.permute(1, 0, 2), q_nope.reshape(B, H, dn).permute(1, 2, 0))
    # (B, H, r) in float32, transposed and widened in one pass
    q_lat = q_lat.permute(2, 0, 1).to(torch.float32, memory_format=torch.contiguous_format)
    ckv_new, kr_new = _mla_latent(cfg, p, x, positions, rope_tables, plain)
    b_idx, slot, valid = indices if indices is not None else decode_indices(pos, T)
    ckv = write_rows(cache["ckv"], b_idx, slot, ckv_new[:, 0])      # in place
    kr = write_rows(cache["kr"], b_idx, slot, kr_new[:, 0, 0])
    ckv = shard(ckv, ("batch", "kv_seq", None))
    kr = shard(kr, ("batch", "kv_seq", None))
    scale = 1.0 / math.sqrt(dn + dr)
    ckv_f = ckv.float()                                   # (B, T, r)
    s_lat = torch.bmm(ckv_f, q_lat.transpose(1, 2))                             # (B, T, H)
    s_rope = torch.bmm(kr.float(), q_rope.reshape(B, H, dr).float().transpose(1, 2))
    # (B, H, T): a softmax over the last dim (over dim 1 of (B, T, H) it took
    # 1.3 ms a layer on an H100 at B8 T2048, a tenth of the step)
    s = (s_lat.transpose(1, 2) + s_rope.transpose(1, 2)) * scale
    s = torch.where(torch.arange(T, device=x.device) < valid[:, None, None], s, L.NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o_lat = torch.bmm(ckv_f.transpose(1, 2), pr.transpose(1, 2))                # (B, r, H)
    # (B, H, r) in the activation dtype, transposed and narrowed in one pass
    o_lat = o_lat.transpose(1, 2).to(x.dtype, memory_format=torch.contiguous_format)
    uv = p["uv"]["w"].to(x.dtype)                         # (r, H, dv)
    o = torch.bmm(uv.permute(1, 2, 0), o_lat.permute(1, 2, 0))                  # (H, dv, B)
    # (B, 1, H, dv) laid out densely: the output product then reads it as one
    # matrix, where a strided view would make torch.matmul copy the weight
    # once a row
    o = o.permute(2, 0, 1).contiguous().reshape(B, 1, H, dv)
    return _attn_out(p, o, x.dtype), {"ckv": ckv, "kr": kr}


# ==========================================================================
# Block dispatch
# ==========================================================================

# Each block takes the residual stream as ``h`` and the add its predecessor
# left pending (``pending``; None for the first block), so the input is
# ``h + pending``, and returns ``(h, f)`` with ``h + f`` its output.  The
# add is done by the norm that reads the sum (``L.add_norm``: one K3 launch
# that writes both), never as a pass of its own; the final norm takes the last
# block's ``f`` as its residual.


def apply_block_full(cfg, kind, p, h, pending, aux, collect_cache):
    """Returns (h, f, cache_out_or_None, aux_loss): ``aux_loss`` is the MoE
    router's load-balancing loss, None for the dense block (the reference's
    zero, left out so that the dense path launches nothing for it)."""
    # Megatron-SP residual stream (the reference shards the block's input,
    # which is h + pending here: add_norm shards both terms)
    h = shard(h, L.STREAM)
    positions = aux["positions"]
    plain = aux.get("plain", False)
    cache_len = aux.get("cache_len", 0)

    def ring(rows: dict, window: int = 0):
        """A ring cache of ``cache_len`` rows holding the prompt's rows first.
        A windowed layer's ring has ``min(cache_len, window)`` rows, and a
        longer prompt keeps its last T rows, written from row 0, as the
        reference's ``kv_cache`` does (so its first decode step writes slot
        ``S % T``: the reference's slot, kept for parity; ROADMAP queue C)."""
        if not collect_cache:
            return None
        T = ring_rows(cache_len, window)
        out = {}
        for name, t in rows.items():
            if window and t.shape[1] > T:
                t = t[:, -T:]
            S = t.shape[1]
            if S > T:
                raise ValueError(f"prompt of {S} tokens does not fit a cache of {T}")
            # the rows padded with zeros to T (a new tensor, sharded as the rows)
            out[name] = F.pad(t, (0, 0) * (t.ndim - 2) + (0, T - S))
        return out

    if kind in ("attn_ffn", "moe_attn_ffn", "mla_moe"):
        h, x = L.add_norm(cfg, p["ln1"], h, pending, plain=plain)
        attend = mla_full if kind == "mla_moe" else gqa_full
        a, rows = attend(cfg, p["attn"], x, positions, rope_tables=aux.get("rope_tables"),
                         plain=plain)
        names = ("ckv", "kr") if kind == "mla_moe" else ("k", "v")
        h, x = L.add_norm(cfg, p["ln2"], h, a, plain=plain)
        if kind == "attn_ffn":
            return h, L.ffn(cfg, p["mlp"], x), ring(dict(zip(names, rows))), None
        f, aux_loss = L.moe_ffn(cfg, p["moe"], x)
        return h, f, ring(dict(zip(names, rows))), aux_loss

    if kind == "griffin_attn":
        h, x = L.add_norm(cfg, p["ln"], h, pending, plain=plain)
        a, (k, v) = gqa_full(cfg, p["attn"], x, positions, window=cfg.window,
                             rope_tables=aux.get("rope_tables"), plain=plain)
        h, x = L.add_norm(cfg, p["ln2"], h, a, plain=plain)
        return h, L.ffn(cfg, p["mlp"], x), ring({"k": k, "v": v}, cfg.window), None

    if kind == "griffin_rec":
        h, y = L.add_norm(cfg, p["ln"], h, pending, plain=plain)
        g = F.gelu(L.linear(p["in_gate"], y), approximate="tanh")
        r = shard(L.linear(p["in_rec"], y), ("batch", "seq", "lru_width"))
        r, conv_state = L.causal_conv1d(p["conv"], r, None)
        r, h_last = L.rglru_scan(p["rglru"], r, None)
        h, x = L.add_norm(cfg, p["ln2"], h, L.linear(p["out"], g * r), plain=plain)
        cache = {"h": h_last.to(h.dtype), "conv": conv_state} if collect_cache else None
        return h, L.ffn(cfg, p["mlp"], x), cache, None

    if kind == "xattn":
        # LayerNorm: add_norm's add is a plain add, the reference's h = h + a
        h, x = L.add_norm(cfg, p["ln1"], h, pending, plain=plain)
        a, (k, v) = gqa_full(cfg, p["self_attn"], x, positions, rope=False, plain=plain)
        h, x = L.add_norm(cfg, p["ln2"], h, a, plain=plain)
        ca, (ck, cv) = cross_full(cfg, p["cross_attn"], x, aux["enc_out"], plain=plain)
        h, x = L.add_norm(cfg, p["ln3"], h, ca, plain=plain)
        cache = None
        if collect_cache:
            cache = ring({"k": k, "v": v})
            cache["ck"], cache["cv"] = ck, cv
        return h, L.ffn(cfg, p["mlp"], x), cache, None

    if kind == "enc":
        h, x = L.add_norm(cfg, p["ln1"], h, pending, plain=plain)
        a, _ = gqa_full(cfg, p["attn"], x, positions, causal=False, rope=False, plain=plain)
        h, x = L.add_norm(cfg, p["ln2"], h, a, plain=plain)
        return h, L.ffn(cfg, p["mlp"], x), None, None

    if kind == "mlstm":
        h, y = L.add_norm(cfg, p["ln"], h, pending, plain=plain)
        q, k, v, i_g, f_g, conv_state = _mlstm_in(cfg, p, y, None)
        yc, (C, n, m) = L.mlstm_chunkwise(q, k, v, i_g, f_g, chunk=cfg.chunk_size)
        cache = {"conv": conv_state, "C": C, "n": n, "m": m} if collect_cache else None
        return h, _mlstm_out(cfg, p, y, yc, plain), cache, None

    if kind == "slstm":
        h, y = L.add_norm(cfg, p["ln"], h, pending, plain=plain)
        hs, state = L.slstm_scan(p, L.linear(p["gates_in"], y), None)
        cache = dict(zip(SLSTM_STATE, state)) if collect_cache else None
        return h, _slstm_out(cfg, p, hs, plain), cache, None

    raise ValueError(kind)


# --- xLSTM ----------------------------------------------------------------


def _mlstm_in(cfg, p, y, conv_state):
    """The mLSTM block's up projection, causal conv and q/k/v/gate
    projections: (q, k, v, i_gate, f_gate, the conv's new state); q, k, v
    (B, S, H, Dh)."""
    B, S, _ = y.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    u = L.linear(p["up"], y)
    cv, conv_state = L.causal_conv1d(p["conv"], u, conv_state)
    c = F.silu(cv)
    q = L.linear(p["q"], c).reshape(B, S, H, Dh)
    k = L.linear(p["k"], c).reshape(B, S, H, Dh)
    v = L.linear(p["v"], u).reshape(B, S, H, Dh)
    gates = L.linear(p["gates"], c)
    return q, k, v, gates[..., :H], gates[..., H:], conv_state


def _mlstm_out(cfg, p, y, yc, plain):
    """The cell's output (B, S, H, Dh): its norm over H*Dh (K3 on the card),
    gated by ``silu(z(y))``, projected back to the model width."""
    B, S, H, Dh = yc.shape
    yn = L.rmsnorm(p["out_norm"]["w"], yc.reshape(B, S, H * Dh), eps=cfg.norm_eps, plain=plain)
    return L.linear(p["o"], yn * F.silu(L.linear(p["z"], y)))


def _slstm_out(cfg, p, hs, plain):
    """The sLSTM's hidden states' norm (K3 on the card) and its GELU FFN."""
    hn = L.rmsnorm(p["out_norm"]["w"], hs, eps=cfg.norm_eps, plain=plain)
    return L.linear(p["ffn_down"], F.gelu(L.linear(p["ffn_up"], hn), approximate="tanh"))


def apply_block_decode(cfg, kind, p, h, pending, cache, aux):
    """Returns (h, f, cache) — the cache is the one passed in, updated in place."""
    pos = aux["pos"]
    positions = aux.get("decode_positions")
    plain = aux.get("plain", False)

    if kind == "griffin_rec":
        h, y = L.add_norm(cfg, p["ln"], h, pending, plain=plain)
        g = F.gelu(L.linear(p["in_gate"], y), approximate="tanh")
        r, conv_state = L.causal_conv1d(p["conv"], L.linear(p["in_rec"], y), cache["conv"])
        r_t, h_state = L.rglru_step(p["rglru"], r[:, 0], cache["h"])
        h, x = L.add_norm(cfg, p["ln2"], h, L.linear(p["out"], g * r_t[:, None, :]),
                          plain=plain)
        cache["h"].copy_(h_state)            # in place, rounded to the cache's dtype
        cache["conv"].copy_(conv_state)
        return h, L.ffn(cfg, p["mlp"], x), cache

    if kind == "mlstm":
        h, y = L.add_norm(cfg, p["ln"], h, pending, plain=plain)
        q, k, v, i_g, f_g, conv_state = _mlstm_in(cfg, p, y, cache["conv"])
        # C, n and m are updated in place
        yc, _ = L.mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_g[:, 0], f_g[:, 0],
                             (cache["C"], cache["n"], cache["m"]))
        cache["conv"].copy_(conv_state)
        return h, _mlstm_out(cfg, p, y, yc[:, None], plain), cache

    if kind == "slstm":
        h, y = L.add_norm(cfg, p["ln"], h, pending, plain=plain)
        hs, state = L.slstm_scan(p, L.linear(p["gates_in"], y),
                                 tuple(cache[name] for name in SLSTM_STATE))
        for name, t in zip(SLSTM_STATE, state):
            cache[name].copy_(t)             # in place
        return h, _slstm_out(cfg, p, hs, plain), cache

    if kind == "xattn":
        h, x = L.add_norm(cfg, p["ln1"], h, pending, plain=plain)
        a, _ = gqa_decode(cfg, p["self_attn"], x, pos, cache, rope=False, positions=positions,
                          indices=aux.get("indices"), plain=plain)
        h, x = L.add_norm(cfg, p["ln2"], h, a, plain=plain)
        h, x = L.add_norm(cfg, p["ln3"], h, cross_decode(cfg, p["cross_attn"], x, cache,
                                                         plain=plain), plain=plain)
        # k and v written in place, ck and cv as they were
        return h, L.ffn(cfg, p["mlp"], x), cache

    if kind in ("attn_ffn", "moe_attn_ffn", "mla_moe", "griffin_attn"):
        # griffin_attn's window needs no mask here: its ring holds the window
        # (the reference's gqa_decode takes no window either)
        h, x = L.add_norm(cfg, p["ln" if kind == "griffin_attn" else "ln1"], h, pending,
                          plain=plain)
        attend = mla_decode if kind == "mla_moe" else gqa_decode
        a, c = attend(cfg, p["attn"], x, pos, cache, positions=positions,
                      rope_tables=aux.get("rope_tables"), indices=aux.get("indices"),
                      plain=plain)
        h, x = L.add_norm(cfg, p["ln2"], h, a, plain=plain)
        if kind in ("attn_ffn", "griffin_attn"):
            return h, L.ffn(cfg, p["mlp"], x), c
        return h, L.moe_ffn(cfg, p["moe"], x)[0], c

    raise ValueError(kind)


# ==========================================================================
# Model facade
# ==========================================================================

# Matrix products whose outputs the ``dots`` policy keeps: what torch.matmul,
# einsum and linear lower to.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = ("none", "block", "dots")


class Model:
    """``device=None`` is the card (raises where there is none); tests pass
    ``device="cpu"``.  ``plain_kernels=True`` is for tests and the on-card
    parity check only: norms and attention then take the kernels' plain
    versions whatever the device.

    ``remat_policy`` (what the reference's ``_maybe_remat`` wraps around its
    scan body) applies to ``forward`` under autograd:

    * ``none``: every activation is kept for the backward;
    * ``block``: ``torch.utils.checkpoint(use_reentrant=False)`` around each
      block, which keeps the block's inputs and recomputes the rest in the
      backward (``jax.checkpoint`` of the body);
    * ``dots``: the same checkpoint with a selective policy that keeps the
      outputs of the matrix products (aten ``mm``, ``bmm``, ``addmm``,
      ``baddbmm``) and recomputes everything else.  This is
      ``jax.checkpoint_policies.checkpoint_dots``, which keeps the outputs of
      every ``dot_general``, with one difference: on the card attention is
      K1, an autograd function rather than a product, so its forward is
      recomputed (the reference's attention is einsums, which it keeps);
      on the CPU the attention einsums are ``bmm`` and are kept as there.
    """

    def __init__(self, cfg: ModelConfig, device=None, *, remat_policy: str = "none",
                 plain_kernels: bool = False):
        layer_kinds(cfg)        # raises for a family that is not ported yet
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r}: one of {REMAT_POLICIES}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.remat_policy = remat_policy
        self.plain_kernels = plain_kernels
        self.kinds = layer_kinds(cfg)

    # ---- params ----
    def init(self, generator: torch.Generator) -> Tree:
        return init_params(self.cfg, generator, self.device)

    # ---- embedding / head ----
    def _embed(self, params, tokens, positions, patch_embeds=None):
        """Token embeddings (B, S, D) in the activation type; with the vision
        frontend, ``patch_embeds`` (B, N, D; given by ``forward`` and
        ``prefill``, never by ``decode_step``) takes rows 0..N-1, as the
        reference's ``dynamic_update_slice`` at (0, 0, 0): written as a
        concatenation, so the overwritten rows' token embeddings get a zero
        gradient.  N > S raises (the reference fails at trace time)."""
        cfg = self.cfg
        w = L.grad_placed(params["embed"]["w"])
        # a DTensor table (the dry run) takes DTensor's embedding rule (a
        # vocabulary shard masks what it does not hold)
        h = F.embedding(tokens, w)
        h = h.to(torch_dtype(cfg.dtype))
        if cfg.scale_embedding:
            # the factor is rounded to the activation type before the product,
            # as the reference's weakly typed scalar is; filled on the device
            # (a tensor made from a host scalar would copy, and wait, a call)
            h = h * torch.full((), math.sqrt(cfg.d_model), dtype=h.dtype, device=h.device)
        if cfg.rope_style == "none":
            # Whisper: sinusoidal positions, rounded to the activation type and then added
            h = h + L.sinusoidal_positions(positions, cfg.d_model).to(h.dtype)
        if patch_embeds is not None and cfg.frontend == "vision_patches":
            pe = torch.as_tensor(patch_embeds).to(self.device, h.dtype)
            if pe.shape[1] > h.shape[1]:
                raise ValueError(f"{pe.shape[1]} patch embeddings do not fit a sequence of "
                                 f"{h.shape[1]} tokens")
            h = torch.cat([pe, h[:, pe.shape[1]:]], dim=1)
        return shard(h, L.STREAM)

    def _logits(self, params, h):
        cfg = self.cfg
        w = L.grad_placed(params["embed"]["w"]).t() if cfg.tie_embeddings \
            else params["lm_head"]["w"]
        logits = L.matmul(h, w.to(h.dtype)).float()
        # seq-sharded logits (full local vocab) -> local per-token CE; decode
        # (S=1) falls through to vocab sharding via divisibility resolution
        return shard(logits, ("batch", "seq_sp", "vocab"))

    def _tokens(self, batch) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"])
        return tokens.to(self.device, torch.long)

    def _positions(self, batch, default: torch.Tensor) -> torch.Tensor:
        positions = batch.get("positions")
        return default if positions is None else torch.as_tensor(positions).to(self.device)

    def _aux(self, positions, **kw) -> dict:
        """What every layer of one call shares: positions, the RoPE tables
        computed once from them for the dim the blocks rotate, and the
        plain-versions switch."""
        return {"positions": positions, "plain": self.plain_kernels,
                "rope_tables": L.rope_tables(self.cfg, positions, L.rope_head_dim(self.cfg)),
                **kw}

    # ---- encoder (whisper) ----
    def encode(self, params, frame_embeds):
        """Whisper's encoder: the frame embeddings (B, encoder_seq, d_model)
        in the activation type plus sinusoidal positions, the encoder's
        layers (under remat as the decoder's), its final norm."""
        cfg = self.cfg
        h = torch.as_tensor(frame_embeds).to(self.device, torch_dtype(cfg.dtype))
        B, S, _ = h.shape
        positions = torch.arange(S, device=self.device).expand(B, S)
        h = h + L.sinusoidal_positions(positions, cfg.d_model).to(h.dtype)
        aux = {"positions": positions, "plain": self.plain_kernels}
        enc = params["encoder"]
        h, f, _, _ = self._run_stack(("enc",) * len(enc["blocks"]), enc["blocks"], h, aux,
                                     collect_cache=False)
        return L.apply_norm(cfg, enc["final_norm"], h, residual=f, plain=self.plain_kernels)

    # ---- full-sequence stack ----
    def _block(self, kind, p, aux, h, pending):
        h, f, _, aux_loss = apply_block_full(self.cfg, kind, p, h, pending, aux, False)
        return h, f, aux_loss

    def _run_stack(self, kinds, blocks, h, aux, collect_cache):
        """The layers ``blocks`` of kinds ``kinds`` (the decoder's, or the
        encoder's) over ``h``.  Returns (h, f, aux_loss, caches): the stack's
        output is ``h + f``; ``aux_loss`` is the sum of the blocks' router
        losses, in layer order, as the reference's scan carries it (None where
        no block has one)."""
        caches, f, aux_loss = [], None, None
        remat = (self.remat_policy != "none" and not collect_cache and torch.is_grad_enabled())
        for kind, p in zip(kinds, blocks):
            if remat:
                kw = {}
                if self.remat_policy == "dots":
                    kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                         _save_dots)
                h, f, al = checkpoint(functools.partial(self._block, kind, p, aux), h, f,
                                      use_reentrant=False, **kw)
                caches.append(None)
            else:
                h, f, c_out, al = apply_block_full(self.cfg, kind, p, h, f, aux, collect_cache)
                caches.append(c_out)
            if al is not None:
                aux_loss = al if aux_loss is None else aux_loss + al
        return h, f, aux_loss, caches

    def _final_norm(self, params, h, f):
        return L.apply_norm(self.cfg, params["final_norm"], h, residual=f,
                            plain=self.plain_kernels)

    def _encoder_aux(self, params, batch, aux: dict) -> dict:
        """``aux`` with the encoder's output under ``enc_out`` for an
        encoder-decoder (``batch["frame_embeds"]``), as it is otherwise."""
        if self.cfg.encoder_layers > 0:
            aux["enc_out"] = self.encode(params, batch["frame_embeds"])
        return aux

    # ---- public entry points ----
    def forward(self, params, batch):
        """Full-sequence forward.  batch: tokens (B,S)[, positions (B,S), or
        (B,S,3) (t, h, w) for M-RoPE; frame_embeds (B, encoder_seq, d_model)
        for Whisper; patch_embeds (B, N, d_model) for the vision frontend,
        overlaid on rows 0..N-1].  Returns
        (logits, aux_loss): the MoE router's load-balancing loss summed over
        the layers, 0 for the dense families.
        Recorded by autograd where grad mode is on and a parameter requires
        grad (call it under ``torch.no_grad()`` for inference)."""
        tokens = self._tokens(batch)
        B, S = tokens.shape
        positions = self._positions(batch, torch.arange(S, device=self.device).expand(B, S))
        aux = self._encoder_aux(params, batch, self._aux(positions))
        h = self._embed(params, tokens, positions, batch.get("patch_embeds"))
        h, f, aux_loss, _ = self._run_stack(self.kinds, params["blocks"], h, aux,
                                            collect_cache=False)
        h = self._final_norm(params, h, f)
        if aux_loss is None:
            aux_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        return self._logits(params, h), aux_loss

    @torch.no_grad()
    def prefill(self, params, batch, cache_len: int):
        """Full-sequence forward that also populates a decode cache (batch as
        :meth:`forward`'s)."""
        tokens = self._tokens(batch)
        B, S = tokens.shape
        positions = self._positions(batch, torch.arange(S, device=self.device).expand(B, S))
        aux = self._encoder_aux(params, batch, self._aux(positions, cache_len=cache_len))
        h = self._embed(params, tokens, positions, batch.get("patch_embeds"))
        h, f, _, caches = self._run_stack(self.kinds, params["blocks"], h, aux,
                                          collect_cache=True)
        h = self._final_norm(params, h, f)
        logits = self._logits(params, h[:, -1:])
        cache = {"blocks": caches,
                 "pos": torch.full((B,), S, dtype=torch.int32, device=self.device)}
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params, cache, batch):
        """One-token decode.  batch: tokens (B,1)[, positions (B,1), or
        (B,1,3) for M-RoPE; the ring row comes from ``cache["pos"]``].  Returns
        (logits, cache).  The tensors of ``cache`` (K/V rings, recurrent
        state) are updated **in place** and returned in a new dict beside a
        new ``pos``; the reference returns fresh arrays and leaves its
        argument as it was."""
        tokens = self._tokens(batch)
        pos = cache["pos"]                    # (B,) per-slot positions
        positions = self._positions(batch, pos[:, None])
        T = cache_len_of(cache)               # the attention rings' rows (one T for all)
        aux = self._aux(positions, pos=pos, decode_positions=positions,
                        indices=decode_indices(pos, T) if T is not None else None)
        h = self._embed(params, tokens, positions)
        new_blocks, f = [], None
        for kind, p, c in zip(self.kinds, params["blocks"], cache["blocks"]):
            h, f, cj = apply_block_decode(self.cfg, kind, p, h, f, c, aux)
            new_blocks.append(cj)
        h = self._final_norm(params, h, f)
        logits = self._logits(params, h)
        return logits, {"blocks": new_blocks, "pos": pos + 1}
