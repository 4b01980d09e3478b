"""Core neural layers: the dense, MoE, RG-LRU and xLSTM subset (counterpart
of ``repro/models/layers.py``).

Everything is functional: ``apply(params, x, ...) -> y``.  Layers insert
the reference's logical sharding constraints (``distributed.sharding``):
each is the identity on a plain tensor, so the model on one card pays
nothing for them, and redistributes a DTensor (the dry run,
``launch/dryrun.py``) to the placements its logical axes resolve to.

RMSNorm and attention go through the kernel wrappers of
``repro_torch.kernels``: on a CUDA tensor those launch the Hopper kernels, on
a CPU tensor they compute the same function in plain torch.  ``plain=True``
(used only to hold the kernels against their plain versions on the card)
calls the plain versions whatever the device.

Attention strategies:
  * ``dense``     — plain einsum softmax attention (small sequences, tests)
  * ``blockwise`` — online-softmax attention over kv blocks in a
                    ``layers.scan`` (the reference's ``lax.scan``), in plain torch
  * ``kernel``    — flash-attention kernel for a full sequence, split-KV decode
                    kernel for one token against a ring cache
  * ``auto``      — ``kernel`` for CUDA tensors; elsewhere the reference's
                    rule: ``blockwise`` when ``Sq*T > 2048^2`` or ``T > 1024``,
                    else ``dense``
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.distributed.sharding import (
    active_env, axis_size, contiguous_stride, is_dtensor, logical_constraint as shard,
    placements, redistribute, resolve_spec,
)
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rmsnorm import add_rmsnorm_plain, rmsnorm_plain

# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

STREAM = ("batch", "seq_sp", "embed")   # the residual stream's logical axes (Megatron-SP)



def rmsnorm(w: torch.Tensor, x: torch.Tensor, *, eps: float = 1e-6, offset: bool = False,
            residual: torch.Tensor | None = None, plain: bool = False) -> torch.Tensor:
    if plain:
        return rmsnorm_plain(x, w, eps=eps, offset=offset, residual=residual)
    if residual is None:
        return ops.rmsnorm(x, w, eps=eps, offset=offset)
    return ops.rmsnorm_residual(x, residual, w, eps=eps, offset=offset)


def layernorm(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def apply_norm(cfg, p: dict, x: torch.Tensor, *, residual: torch.Tensor | None = None,
               plain: bool = False) -> torch.Tensor:
    """Norm of ``x``, or of ``x + residual`` (the sum is not returned)."""
    if residual is not None:
        x, residual = shard(x, STREAM), shard(residual, STREAM)
    if cfg.norm == "layernorm":
        if residual is not None:
            x = x + residual
        return layernorm(p["w"], p["b"], x, eps=cfg.norm_eps)
    return rmsnorm(p["w"], x, eps=cfg.norm_eps, offset=cfg.rms_offset, residual=residual,
                   plain=plain)


def add_norm(cfg, p: dict, h: torch.Tensor, pending: torch.Tensor | None, *,
             plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, norm(s))`` with ``s = h + pending``: a residual add left pending
    by the block before, carried into the norm that reads its sum (one kernel
    launch for both on the card).  ``pending`` None: ``(h, norm(h))``.
    The sum is the residual stream: under a sharding env both of its terms
    take the stream's placements first (a row-parallel product's partial
    sums reduced where GSPMD reduces them, before the add)."""
    if pending is None:
        return h, apply_norm(cfg, p, h, plain=plain)
    h, pending = shard(h, STREAM), shard(pending, STREAM)
    if cfg.norm == "layernorm":
        s = h + pending
        return s, layernorm(p["w"], p["b"], s, eps=cfg.norm_eps)
    add = add_rmsnorm_plain if plain else ops.add_rmsnorm
    return add(h, pending, p["w"], eps=cfg.norm_eps, offset=cfg.rms_offset)


# --------------------------------------------------------------------------
# Rotary position embeddings (standard / partial / M-RoPE)
# --------------------------------------------------------------------------

def _rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    """(dim/2,) float32 ``1 / theta^(2i/dim)``, bit for bit the reference's:
    the exponent in float32, its power in float64 rounded once to float32
    (as XLA's float32 power gives it; torch's float32 power misses the last
    bit of some), the reciprocal in float32."""
    e = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** e.double()).float()


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., D_rot) with cos/sin (..., D_rot/2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rot_dim(cfg, d: int) -> int:
    rot = d if cfg.rope_style != "partial" else int(d * cfg.rope_fraction)
    return rot - rot % 2


def rope_head_dim(cfg) -> int:
    """The head dim a block of ``cfg`` rotates: MLA's rotary part
    (``qk_rope_head_dim``), else the head."""
    return cfg.qk_rope_head_dim if cfg.attention == "mla" else cfg.head_dim


def mrope_sections(half: int, device) -> torch.Tensor:
    """(half,) int64: the section, 0 (t), 1 (h) or 2 (w), whose position
    each rotary frequency takes: a quarter, three eighths and the rest of
    the ``half`` frequencies (Qwen2-VL's ``mrope_section``, [16, 24, 24] at
    half = 64)."""
    s0 = half // 4
    s1 = s0 + (3 * half) // 8
    return torch.cat([torch.zeros((s0,), dtype=torch.long, device=device),
                      torch.ones((s1 - s0,), dtype=torch.long, device=device),
                      torch.full((half - s1,), 2, dtype=torch.long, device=device)])


def rope_angles(cfg, positions: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(B, S, 1, rot/2) float32: the float32 positions times the
    frequencies, the reference's product.

    M-RoPE (``rope_style="mrope"``) takes positions (B, S, 3), one (t, h, w)
    triple a token, or (B, S), broadcast to three equal sections (then the
    angles are standard RoPE's).  Each frequency takes the position of its
    section (``mrope_sections``) by one gather, as the reference's
    ``take_along_axis`` does."""
    inv = _rope_freqs(_rot_dim(cfg, head_dim), cfg.rope_theta, positions.device)   # (half,)
    if cfg.rope_style != "mrope":
        return positions.float()[..., None, None] * inv
    if positions.ndim == 2:
        positions = positions[..., None].expand(*positions.shape, 3)
    half = inv.shape[0]
    sec = mrope_sections(half, positions.device).expand(*positions.shape[:2], half)
    return torch.gather(positions.float(), -1, sec)[..., None, :] * inv


def rope_tables(cfg, positions: torch.Tensor, head_dim: int):
    """(cos, sin) of :func:`rope_angles`, each (B, S, 1, rot/2) float32, for
    ``apply_rope``.  They depend on the positions only, so a model call
    computes them once and hands them to every layer (eager torch has no
    compiler to share them)."""
    if cfg.rope_style == "none":
        return None
    angles = rope_angles(cfg, positions, head_dim)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(cfg, x: torch.Tensor, positions: torch.Tensor, *, tables=None) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integer, or (B, S, 3) for M-RoPE.
    ``tables``: what :func:`rope_tables` gave for these positions and this
    D, if the caller has it already."""
    if cfg.rope_style == "none":
        return x
    d = x.shape[-1]
    rot = _rot_dim(cfg, d)
    cos, sin = tables if tables is not None else rope_tables(cfg, positions, d)
    out = _rotate(x[..., :rot], cos, sin).to(x.dtype)
    return torch.cat([out, x[..., rot:]], dim=-1) if rot < d else out


def sinusoidal_positions(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Whisper-style sinusoidal embedding; positions (B, S) -> (B, S, D)
    float32: sines then cosines of ``half`` frequencies spaced by
    ``log(10000) / (half - 1)``."""
    half = d_model // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=positions.device)
                      * (math.log(10_000.0) / max(half - 1, 1)))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# Softmax attention over GQA layouts
# --------------------------------------------------------------------------

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _soft_cap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(s / cap) * cap if cap > 0 else s


def attend_dense(q, k, v, *, q_offset, causal: bool, window: int = 0,
                 kv_valid_len=None, soft_cap: float = 0.0, scale: float | None = None):
    """q: (B, Sq, Hkv, G, Dq), k: (B, T, Hkv, Dq), v: (B, T, Hkv, Dv).

    ``q_offset``: absolute position of q[0].
    ``kv_valid_len``: scalar or (B,) — entries >= this in T are masked (ring caches).
    """
    B, Sq, Hkv, G, Dq = q.shape
    T = k.shape[1]
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(Dq)
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    s = _soft_cap(s, soft_cap)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    t_pos = torch.arange(T, device=dev)
    mask = torch.ones((Sq, T), dtype=torch.bool, device=dev)
    if causal:
        mask &= t_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= t_pos[None, :] > q_pos[:, None] - window
    mask = mask.expand(B, 1, 1, Sq, T)
    if kv_valid_len is not None:
        vl = torch.as_tensor(kv_valid_len, device=dev)
        vl = vl.reshape(-1, 1, 1, 1, 1) if vl.ndim else vl
        mask = mask & (t_pos[None, None, None, None, :] < vl)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.to(q.dtype)


def _attend_kernel(q, k, v, *, q_offset, causal, window, kv_valid_len, soft_cap, scale, plain):
    """Route one attention call to the kernel that computes it: one unmasked
    query token a sequence (decode; Whisper's cross decode has no valid
    length, every key row counts) to the split-KV decode kernel, the rest to
    flash attention.  A call with no valid length that autograd records
    stays on flash attention, whose backward the decode kernel lacks.  The
    output takes v's head dim, which MLA's prefill has apart from q's and
    k's."""
    B, Sq, Hkv, G, D = q.shape
    Dv = v.shape[-1]
    if soft_cap != 0.0 or q_offset != 0:
        raise ValueError("attention(strategy='kernel'): soft_cap and q_offset are not "
                         "taken by the kernels")
    records = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    decode = Sq == 1 and not causal and window == 0 and (kv_valid_len is not None or not records)
    if kv_valid_len is None and not decode:
        if plain:
            qh = q.reshape(B, Sq, Hkv * G, D).permute(0, 2, 1, 3)
            o = flash_attention_plain(qh, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                                      causal=causal, window=window, scale=scale)
            return o.permute(0, 2, 1, 3).reshape(B, Sq, Hkv, G, Dv)
        return ops.flash_attention_bshd(q, k, v, causal=causal, window=window, scale=scale)
    if decode:
        vl = kv_valid_len       # None: all T rows valid
        if vl is not None and not (torch.is_tensor(vl) and vl.dtype == torch.int32
                                   and vl.shape == (B,)):
            vl = torch.as_tensor(vl, device=q.device).to(torch.int32).expand(B).contiguous()
        if plain:
            o = decode_attention_plain(q.reshape(B, Hkv * G, D), k.permute(0, 2, 1, 3),
                                       v.permute(0, 2, 1, 3), kv_valid_len=vl, scale=scale)
            return o.reshape(B, 1, Hkv, G, Dv)
        return ops.decode_attention_bthd(q, k, v, vl, scale=scale)
    raise ValueError("attention(strategy='kernel'): kv_valid_len is taken only for one "
                     "unmasked query token a sequence (decode)")


def attend_blockwise(q, k, v, *, q_offset, causal: bool, window: int = 0,
                     kv_valid_len=None, soft_cap: float = 0.0,
                     q_block: int = 512, kv_block: int = 1024,
                     scale: float | None = None, skip_masked_blocks: bool = True,
                     score_dtype=torch.float32):
    """Online-softmax (flash-style) attention in plain torch; shapes as in
    :func:`attend_dense`.

    Outer Python loop over q blocks (static trip count) so causal runs can
    statically truncate the KV range per q block (``skip_masked_blocks``);
    inner :func:`scan` over kv blocks carries the running (m, l, acc).  The
    scan walks the kv blocks as a leading dim of views of k and v, so a step
    slices nothing.

    ``score_dtype=torch.bfloat16`` keeps the probability tensor in bf16 for
    the PV product while the running max/sum statistics stay fp32.
    """
    B, Sq, Hkv, G, Dq = q.shape
    T, Dv = k.shape[1], v.shape[-1]
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(Dq)
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, T)
    # pad to block multiples
    Sq_p = -(-Sq // q_block) * q_block
    T_p = -(-T // kv_block) * kv_block
    qp = F.pad(q, (0, 0, 0, 0, 0, 0, 0, Sq_p - Sq)) if Sq_p > Sq else q
    kp = F.pad(k, (0, 0, 0, 0, 0, T_p - T)) if T_p > T else k
    vp = F.pad(v, (0, 0, 0, 0, 0, T_p - T)) if T_p > T else v
    n_kv = T_p // kv_block
    # (n_kv, B, kv_block, Hkv, D): the loop's blocks along dim 0, as views
    k_blocks = kp.view(B, n_kv, kv_block, Hkv, Dq).transpose(0, 1)
    v_blocks = vp.view(B, n_kv, kv_block, Hkv, Dv).transpose(0, 1)

    vl_b = None
    if kv_valid_len is not None:
        vl = torch.as_tensor(kv_valid_len, device=dev)
        vl_b = vl.reshape(-1, 1, 1, 1, 1) if vl.ndim else vl
    outs = []
    for qi in range(Sq_p // q_block):
        q_blk = qp[:, qi * q_block:(qi + 1) * q_block].float()
        q_pos = q_offset + qi * q_block + torch.arange(q_block, device=dev)
        # static causal truncation: kv blocks strictly after this q block's
        # last row are fully masked -> skip (saves ~2x flops at scale)
        hi = n_kv
        if causal and skip_masked_blocks and isinstance(q_offset, int):
            last = q_offset + (qi + 1) * q_block - 1
            hi = min(n_kv, last // kv_block + 1)
        lo = 0
        if window > 0 and skip_masked_blocks and isinstance(q_offset, int):
            first = max(q_offset + qi * q_block - window + 1, 0)
            lo = min(first // kv_block, hi)

        def step(carry, xs, q_blk=q_blk, q_pos=q_pos):
            m, l, acc = carry
            ti, kb, vb = xs
            s = torch.einsum("bskgd,btkd->bkgst", q_blk, kb.float()) * scale
            s = _soft_cap(s, soft_cap)
            t_pos = ti * kv_block + torch.arange(kv_block, device=dev)
            msk = t_pos[None, :] < T  # padding
            if causal:
                msk = msk & (t_pos[None, :] <= q_pos[:, None])
            if window > 0:
                msk = msk & (t_pos[None, :] > q_pos[:, None] - window)
            msk = msk.expand(B, 1, 1, q_block, kv_block)
            if vl_b is not None:
                msk = msk & (t_pos[None, None, None, None, :] < vl_b)
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_new = l * corr + p.sum(-1)
            acc_new = acc * corr[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", p.to(score_dtype), vb.to(score_dtype)).float()
            return (m_new, l_new, acc_new), None

        m0 = torch.full((B, Hkv, G, q_block), NEG_INF, dtype=torch.float32, device=dev)
        l0 = torch.zeros((B, Hkv, G, q_block), dtype=torch.float32, device=dev)
        a0 = torch.zeros((B, Hkv, G, q_block, Dv), dtype=torch.float32, device=dev)
        if hi > lo:
            (m, l, acc), _ = scan(step, (m0, l0, a0), (torch.arange(lo, hi, device=dev),
                                                       k_blocks[lo:hi], v_blocks[lo:hi]))
        else:
            m, l, acc = m0, l0, a0
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4))                    # bkgsd -> bskgd
    o = torch.cat(outs, dim=1)[:, :Sq]
    return o.to(q.dtype)


def _auto_strategy(q, k) -> str:
    """The reference's rule off the card (``kernel`` on it)."""
    if q.device.type == "cuda":
        return "kernel"
    T = k.shape[1]
    return "blockwise" if (q.shape[1] * T > 2048 * 2048 or T > 1024) else "dense"


def attention(q, k, v, *, q_offset=0, causal=True, window=0, kv_valid_len=None,
              soft_cap=0.0, strategy="auto", scale=None, q_block=2048, kv_block=512,
              score_dtype=torch.float32, plain=False):
    """Dispatch over attention strategies.  Shapes as in :func:`attend_dense`.
    ``q_block``, ``kv_block`` and ``score_dtype`` are the blockwise
    strategy's; the kernels take none of them.  DTensor inputs (the dry
    run) go through :func:`_sharded_attention`."""
    if strategy == "auto":
        strategy = _auto_strategy(q, k)
    kw = dict(q_offset=q_offset, causal=causal, window=window, kv_valid_len=kv_valid_len,
              soft_cap=soft_cap, scale=scale)
    if is_dtensor(q):
        return _sharded_attention(q, k, v, strategy=strategy, q_block=q_block,
                                  kv_block=kv_block, score_dtype=score_dtype, plain=plain, **kw)
    if strategy == "kernel":
        return _attend_kernel(q, k, v, plain=plain, **kw)
    if strategy == "blockwise":
        return attend_blockwise(q, k, v, q_block=q_block, kv_block=kv_block,
                                score_dtype=score_dtype, **kw)
    if strategy != "dense":
        raise ValueError(f"unknown attention strategy {strategy!r}")
    return attend_dense(q, k, v, **kw)


def _sharded_attention(q, k, v, *, strategy, q_block, kv_block, score_dtype, q_offset,
                       kv_valid_len, plain, **kw):
    """Attention over DTensors.  Where k and v keep every kv row on each rank
    (batch and heads sharded, or the q sequence: context parallelism), the
    attention is local, as GSPMD partitions it, and runs on each rank's
    shards (``local_map``): through K1 or K2 for ``strategy="kernel"`` (the
    card's; their plain versions on the CPU, as for a plain tensor); a
    q-sequence shard then starts at its rank's offset and takes every kv
    block (the reference's single q block, which truncates nothing).  Else
    (the KV sequence sharded: a decode over ``kv_seq``) the ops run on the
    DTensors and DTensor places the collectives.  The kernels take neither
    a sharded KV sequence nor a q-sequence shard: those raise."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if strategy == "kernel":
        fn = functools.partial(_attend_kernel, plain=plain)
    elif strategy in ("blockwise", "dense"):
        fn = {"blockwise": attend_blockwise, "dense": attend_dense}[strategy]
    else:
        raise ValueError(f"unknown attention strategy {strategy!r} for DTensor inputs")
    extra = dict(q_block=q_block, kv_block=kv_block, score_dtype=score_dtype) \
        if strategy == "blockwise" else {}
    if any(p.is_shard(1) for p in (*k.placements, *v.placements)):
        if strategy == "kernel":
            raise NotImplementedError(
                "attention(strategy='kernel') with the KV sequence sharded across ranks: each "
                "rank's split-KV partials (acc, m, l) of K2 would need a combine across ranks, "
                "which is not written")
        return fn(q, k, v, q_offset=q_offset, kv_valid_len=kv_valid_len, **extra, **kw)
    mesh = q.device_mesh
    # q, v and the valid lengths sharded as k on batch and kv heads; q keeps
    # its sequence shards (context parallelism)
    kv_pl = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate() for p in k.placements)
    q_pl = tuple(kp if not isinstance(kp, Replicate) else Shard(1) if qp.is_shard(1)
                 else Replicate() for kp, qp in zip(kv_pl, q.placements))
    seq_dims = [i for i, p in enumerate(q_pl) if p.is_shard(1)]
    if strategy == "kernel" and (q_offset != 0 or math.prod(mesh.size(i) for i in seq_dims) > 1):
        raise NotImplementedError(
            "attention(strategy='kernel') with the q sequence sharded across ranks (context "
            "parallelism) or a nonzero q_offset: a shard's queries would start at a nonzero "
            "q_offset, which K1 and K2 do not take")
    q, k, v = (redistribute(t, mesh, pl) for t, pl in ((q, q_pl), (k, kv_pl), (v, kv_pl)))
    if is_dtensor(kv_valid_len):
        kv_valid_len = redistribute(kv_valid_len, mesh,
                                    tuple(p if p.is_shard(0) else Replicate() for p in kv_pl))
    if seq_dims:
        coord = mesh.get_coordinate()
        idx = 0
        for i in seq_dims:
            idx = idx * mesh.size(i) + coord[i]
        q_offset = q_offset + idx * (q.shape[1] // math.prod(mesh.size(i) for i in seq_dims))
        if strategy == "blockwise":
            extra["skip_masked_blocks"] = False
    vl_dt = is_dtensor(kv_valid_len)

    def local(ql, kl, vl_, valid):
        return fn(ql, kl, vl_, q_offset=q_offset, kv_valid_len=valid, **extra, **kw)

    in_pl = (q.placements, k.placements, v.placements,
             kv_valid_len.placements if vl_dt else None)
    return local_map(local, out_placements=list(q.placements), in_placements=in_pl,
                     device_mesh=mesh)(q, k, v, kv_valid_len)


# --------------------------------------------------------------------------
# Dense projections / FFN
# --------------------------------------------------------------------------

def flat_ready(x: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """``x`` ready to have its dims ``start`` to ``end - 1`` flattened: a
    DTensor sharded on more than one of them keeps the first shard and
    gathers the later ones (the sequence of a Megatron-SP stream, a weight's
    FSDP shard), as GSPMD gathers before such a product (DTensor would
    otherwise re-shard the flattened dim through index arithmetic traced op
    by op).  Any other tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dims = sorted({p.dim for p in x.placements if p.is_shard() and start <= p.dim < end})
    if len(dims) <= 1:
        return x
    pl = [Replicate() if p.is_shard() and dims[0] < p.dim < end else p for p in x.placements]
    return redistribute(x, x.device_mesh, pl)


def rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` ready for a product that flattens its leading dims."""
    return flat_ready(x, 0, x.ndim - 1)


class _RowsGrad(torch.autograd.Function):
    """The identity whose backward hands on :func:`rows` of the gradient: a
    product's output gradient, sharded as the stream after it, made ready
    for the product's backward, which flattens its leading dims too."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return rows(g)


class _GradPlaced(torch.autograd.Function):
    """The identity whose backward gives the gradient the input's own
    placements."""

    @staticmethod
    def forward(ctx, w):
        ctx.mesh, ctx.placements = w.device_mesh, tuple(w.placements)
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return redistribute(g, ctx.mesh, ctx.placements)


def grad_placed(w: torch.Tensor) -> torch.Tensor:
    """A use of ``w`` whose gradient comes back in ``w``'s placements (on a
    DTensor: a tied embedding's two uses then add their gradients as they
    lie, where DTensor would move one into the other's placements by a step
    some torch releases lack).  Any other tensor as it is."""
    return _GradPlaced.apply(w) if is_dtensor(w) else w


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., D) and w (D, N).  On DTensors (the dry run) the
    leading dims of x, and of the output's gradient, keep one shard
    (:func:`rows`)."""
    if not is_dtensor(x):
        return x @ w
    return _RowsGrad.apply(rows(x) @ w)


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def ffn(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU / GeGLU / plain-GELU feed-forward."""
    if cfg.act in ("swiglu", "geglu"):
        g = linear(p["gate"], x)
        u = linear(p["up"], x)
        g = F.silu(g) if cfg.act == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * u
    else:
        h = F.gelu(linear(p["up"], x), approximate="tanh")
    h = shard(h, ("batch", "seq", "ffn"))
    return linear(p["down"], h)


# --------------------------------------------------------------------------
# Mixture of Experts (capacity-factor, sort-based dispatch)
# --------------------------------------------------------------------------
#
# Plain torch, as the reference's is plain lax (no Pallas kernel): the expert
# products are batched matrix products, the dispatch and combine sorts,
# gathers and scatters.  Every shape is static (no boolean-mask indexing, no
# ``nonzero``, no host read), so the dispatch traces over FakeTensors and runs
# on the card without a host sync.


def _moe_dispatch(cfg, xf: torch.Tensor, router_w: torch.Tensor, cap: int):
    """Local sort-based top-k dispatch.  xf: (T, D) -> buf (E, cap, D) plus
    combine metadata ``(order, sorted_ids, pos, keep, gate_vals)`` and the
    Switch load-balancing aux loss.

    The reference scatters with ``mode="drop"``, so a (token, k) choice past
    its expert's capacity writes nothing.  Here the choices are added into a
    zero buffer (``index_add``, one launch): a kept choice owns its row, and a
    dropped one adds exact zeros to its expert's last row.  Each row then
    holds one value plus zeros, so the sum is that value whatever the order
    of the adds, and the buffer is the reference's bit for bit."""
    T, D = xf.shape
    E, K = cfg.num_experts, cfg.top_k
    logits = xf.float() @ router_w.float()                         # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, ids = torch.topk(probs, K, dim=-1)                   # (T, K)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    onehot = (ids[:, :1] == torch.arange(E, device=ids.device)).float()
    aux = E * torch.mean(onehot.mean(0) * probs.mean(0)) * cfg.router_aux_coef

    flat_ids = ids.reshape(-1)                                      # (T*K,)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    seg_start = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    pos = torch.arange(T * K, device=xf.device) - seg_start         # position within expert
    keep = pos < cap
    xs = xf[order // K]
    rows = sorted_ids * cap + torch.clamp(pos, max=cap - 1)
    buf = torch.zeros((E * cap, D), dtype=xf.dtype, device=xf.device)
    buf = buf.index_add(0, rows, torch.where(keep[:, None], xs, 0.0))
    return buf.view(E, cap, D), (order, sorted_ids, pos, keep, gate_vals), aux


def _moe_combine(eo: torch.Tensor, meta, T: int, K: int, dtype):
    """Each (token, k) choice's expert output, weighted by its gate and summed
    over k.  As in the reference the gate product is rounded to the expert
    output's type; the sum over k then accumulates in float32 and rounds once
    (torch's reduction of a bf16 tensor), where XLA rounds at its own places:
    the layer-level bf16 test holds the two within its tolerance."""
    order, sorted_ids, pos, keep, gate_vals = meta
    D = eo.shape[-1]
    back = eo[sorted_ids, torch.where(keep, pos, 0)] * keep[:, None].to(eo.dtype)
    unsorted = torch.zeros(back.shape, dtype=back.dtype, device=back.device)
    unsorted = unsorted.index_put((order,), back)                   # (T*K, D)
    return (unsorted.reshape(T, K, D) * gate_vals[..., None].to(eo.dtype)).sum(1).to(dtype)


def _expert_mlp(p: dict, buf: torch.Tensor, dtype) -> torch.Tensor:
    """(E, C, D) x per-expert SwiGLU weights (E, D, F) -> (E, C, D): three
    batched products (the reference's ``ecd,edf->ecf`` and ``ecf,efd->ecd``)."""
    g = torch.bmm(buf, p["gate"].to(dtype))
    u = torch.bmm(buf, p["up"].to(dtype))
    return torch.bmm(F.silu(g) * u, p["down"].to(dtype))


def moe_capacity(cfg, tokens: int) -> int:
    """Rows an expert takes in one call of ``tokens`` tokens."""
    return max(int(math.ceil(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor)), 4)


def moe_ffn(cfg, p: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed experts.  Returns (output, router_aux_loss).

    With no active env, or a model axis of 1, every token is dispatched
    locally and every expert runs here (the reference's single-device path).
    Under an env whose model axis is wider (``x`` and the weights DTensors),
    the interior runs on each rank's shards, as the reference's
    ``shard_map``: :func:`_moe_expert_parallel`."""
    env = active_env()
    if env is not None and axis_size("model", env) > 1 and is_dtensor(x):
        out, aux = _moe_expert_parallel(cfg, p, x, env)
    else:
        B, S, D = x.shape
        buf, meta, aux = _moe_dispatch(cfg, x.reshape(B * S, D), p["router"]["w"],
                                       moe_capacity(cfg, B * S))
        eo = _expert_mlp(p["experts"], buf, x.dtype)
        out = _moe_combine(eo, meta, B * S, cfg.top_k, x.dtype).reshape(B, S, D)
    if cfg.num_shared_experts > 0:
        out = out + ffn(cfg, p["shared"], x)
    return out, aux


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Tiled all-to-all over dim 0 (``jax.lax.all_to_all(..., tiled=True)``):
    chunk j of ``m`` goes to rank j of ``group``, the chunks received are
    concatenated in rank order.  Differentiable."""
    from torch.distributed._functional_collectives import all_to_all_single_autograd
    return all_to_all_single_autograd(t.contiguous(), None, None, group)


def _moe_expert_parallel(cfg, p: dict, x: torch.Tensor, env):
    """The reference's expert-parallel path (``layers.py`` ``shard_map``):
    each rank dispatches its local tokens, an all-to-all over the model axis
    moves capacity rows to the expert owners (Megatron-EP dataflow), expert
    products run on the local expert shards, and a second all-to-all brings
    the outputs back.  The body runs on local tensors (``local_map``); the
    router loss leaves it as a mean over every rank (the reference's
    ``pmean`` over all axes): each rank's share of the mean, placed
    ``Partial("sum")``, which DTensor reduces where it is read."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    mesh = env.mesh
    m = axis_size("model", env)
    if E % m != 0:
        m = 1  # experts unshardable -> local compute, replicated weights
    group = mesh.get_group("model") if m > 1 else None
    x_spec = resolve_spec(env, ("batch", "seq_sp", None), tuple(x.shape))
    ew_spec = resolve_spec(env, ("expert", None, None), tuple(p["experts"]["gate"].shape))
    x_pl, ew_pl = placements(mesh, x_spec), placements(mesh, ew_spec)
    rep = (Replicate(),) * mesh.ndim
    n_ranks = mesh.size()

    # local token count per rank (static)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def _sh(entry):
        axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        return math.prod(sizes[a] for a in axes)
    xs_full = list(x_spec) + [None] * (3 - len(x_spec))
    T_loc = (B // _sh(xs_full[0])) * (S // _sh(xs_full[1]))
    cap = max(int(math.ceil(T_loc * K / E * cfg.capacity_factor)), 4)

    def body(x_loc, router_w, gate_w, up_w, down_w):
        b, s, _ = x_loc.shape
        xf = x_loc.reshape(b * s, D)
        buf, meta, aux = _moe_dispatch(cfg, xf, router_w, cap)       # (E, cap, D)
        if m > 1:
            # EP all-to-all: (E, cap, D) -> (E/m, cap*m, D) on expert owners
            buf = _all_to_all(buf, group).view(m, E // m, cap, D)
            buf = buf.transpose(0, 1).reshape(E // m, m * cap, D)
        eo = _expert_mlp({"gate": gate_w, "up": up_w, "down": down_w}, buf, x_loc.dtype)
        if m > 1:
            eo = eo.view(E // m, m, cap, D).transpose(0, 1)
            eo = _all_to_all(eo, group).view(E, cap, D)
        out = _moe_combine(eo, meta, b * s, K, x_loc.dtype).reshape(b, s, D)
        return out, aux / n_ranks

    w = p["experts"]
    args = [redistribute(x, mesh, x_pl), redistribute(p["router"]["w"], mesh, rep),
            *(redistribute(w[n], mesh, ew_pl) for n in ("gate", "up", "down"))]
    return local_map(body, out_placements=(x_pl, (Partial("sum"),) * mesh.ndim),
                     in_placements=(x_pl, rep, ew_pl, ew_pl, ew_pl),
                     device_mesh=mesh)(*args)


# --------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma recurrent block)
# --------------------------------------------------------------------------
#
# Plain torch, as the reference's is plain lax (no Pallas kernel): the gate
# products are float32 matrix products (TF32 stays off), the recurrence is
# the reference's log-depth scan written out.

_RGLRU_C = 8.0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``; ``F.softplus``
    returns ``x`` itself above its threshold of 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _rglru_gate_matmul(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Full (W, W) or block-diagonal (nb, Wb, Wb) gate projection of a float32
    (..., W), in float32."""
    wf = w.float()
    if w.ndim == 3:
        nb, Wb, _ = w.shape
        xs = shard(x.reshape(-1, nb, Wb), (None, "lru_width", None))
        xs = xs.transpose(0, 1)                                 # (nb, N, Wb), a view
        return torch.bmm(xs, wf).transpose(0, 1).reshape(x.shape)
    return x @ wf


def _rglru_coeffs(p: dict, xf: torch.Tensor):
    """``(a, b)`` of the recurrence ``h_t = a_t h_{t-1} + b_t`` for float32
    inputs: ``a = exp(-c softplus(lam) r)``, ``b = sqrt(1 - a^2) i x``."""
    r = torch.sigmoid(_rglru_gate_matmul(p["wa"], xf) + p["ba"])
    i = torch.sigmoid(_rglru_gate_matmul(p["wx"], xf) + p["bx"])
    log_a = -_RGLRU_C * _softplus(p["lam"].float()) * r           # <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * i * xf


def _scan_combine(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def _interleave(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x at the even positions of dim 1, y at the odd ones; x has as many
    rows as y or one more."""
    if x.shape[1] == y.shape[1]:
        return torch.stack([x, y], dim=2).flatten(1, 2)
    return torch.cat([torch.stack([x[:, :-1], y], dim=2).flatten(1, 2), x[:, -1:]], dim=1)


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """``jax.lax.associative_scan`` of the recurrence's combine over dim 1,
    written out as jax 0.9 computes it (``lax/control_flow/loops.py``:
    ``_scan`` and ``_interleave``): combine the even elements with the odd
    ones (strided slices), scan those pairs by recursion, combine the odd
    results with the elements from 2 on, put element 0 first and interleave.
    The products pair up as the reference's do, so float32 results agree
    with it to the last bits or nearly, and the traced graph has the
    reference's log depth (about 20 nodes a level), where a loop over S
    would trace S steps."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _scan_combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _scan_combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _scan_combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_scan(p: dict, x: torch.Tensor, h0: torch.Tensor | None):
    """x: (B, S, W).  Returns (y in x's dtype, h_last in float32).  Diagonal
    gated linear recurrence ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) i_t x_t``,
    computed in float32 by the log-depth scan; ``h0`` is folded into the
    first step, as in the reference."""
    xf = x.float()
    a, b = _rglru_coeffs(p, xf)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]], dim=1)
    _, h = _associative_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rglru_step(p: dict, x_t: torch.Tensor, h: torch.Tensor):
    """One decode step; x_t, h: (B, W).  Returns (h_new in x_t's dtype, h_new
    in float32)."""
    xf = x_t.float()
    a, b = _rglru_coeffs(p, xf)
    h_new = a * h.float() + b
    return h_new.to(x_t.dtype), h_new


def causal_conv1d(p: dict, x: torch.Tensor, state: torch.Tensor | None):
    """Depthwise causal conv of width K.  x: (B, S, W); state: (B, K-1, W) or
    None.  Returns (y, new_state).  The K terms are summed in x's dtype in
    the reference's order (Python's ``sum``, from 0)."""
    Kw = p["w"].shape[0]
    B, S, W = x.shape
    if state is None:
        state = torch.zeros((B, Kw - 1, W), dtype=x.dtype, device=x.device)
    xx = torch.cat([state, x], dim=1)
    y = sum(xx[:, i:i + S] * p["w"][i].to(x.dtype) for i in range(Kw))
    y = y + p["b"].to(x.dtype)
    new_state = xx[:, -(Kw - 1):] if Kw > 1 else torch.zeros((B, 0, W), dtype=x.dtype,
                                                               device=x.device)
    return y, new_state


# --------------------------------------------------------------------------
# Loops: the port's ``lax.scan``
# --------------------------------------------------------------------------

def tree_leaves_of(tree):
    """(leaves, spec) of a pytree, with None as an empty tree (as JAX has it;
    torch's pytree takes None for a leaf)."""
    return ([], None) if tree is None else tree_flatten(tree)


def tree_of(leaves, spec):
    """The inverse of :func:`tree_leaves_of`."""
    return None if spec is None else tree_unflatten(list(leaves), spec)


_MARKED_LOOPS = contextvars.ContextVar("marked_loops", default=False)


@contextlib.contextmanager
def marked_loops():
    """While open (in this thread), :func:`scan` traces its step once
    between ``core.stubs``' loop marks, DTensor operands on their local
    shards: the dry run's trace, whose analysis multiplies the step by the
    loop's length as the reference's does a ``lax.scan``'s while loop."""
    token = _MARKED_LOOPS.set(True)
    try:
        yield
    finally:
        _MARKED_LOOPS.reset(token)


def scan(step, carry, xs, length=None):
    """``jax.lax.scan``'s contract: ``step(carry, x) -> (carry, y)`` over dim 0
    of every leaf of ``xs`` (or ``length`` times where ``xs`` is None);
    returns the last carry and the ``y`` leaves stacked along dim 0.  It runs
    as a Python loop; inside :func:`marked_loops` (the ingest and the dry
    run), as :func:`_marked_scan`, one step traced between marks whose
    nodes the tracers take at the loop's length, as the reference's do a
    ``lax.scan`` body."""
    if _MARKED_LOOPS.get():
        return _marked_scan(step, carry, xs, length)
    x_leaves, x_spec = tree_leaves_of(xs)
    n = length if length is not None else x_leaves[0].shape[0]
    if n < 1:
        raise ValueError("scan over an empty sequence")
    ys = []
    for t in range(n):
        carry, y = step(carry, tree_of([a[t] for a in x_leaves], x_spec))
        ys.append(tree_leaves_of(y))
    y_spec = ys[0][1]
    stacked = [torch.stack([leaves[i] for leaves, _ in ys]) for i in range(len(ys[0][0]))]
    return carry, tree_of(stacked, y_spec)


def _marked_scan(step, carry, xs, length=None):
    """One step of ``step`` traced between ``core.stubs.scan_enter`` and
    ``scan_exit``, which give the loop's carry and one step's slice of
    ``xs``, then the last carry and the stacked ``y``.  DTensor operands
    pass the marks as their local shards (the marks are custom ops, which
    DTensor has no rule for), each re-wrapped with its placements."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.core.stubs import scan_enter, scan_exit

    def unwrap(leaves, drop_lead):
        info = []
        for t in leaves:
            if isinstance(t, DTensor):
                pl = tuple(Shard(p.dim - 1) if drop_lead and p.is_shard() else p
                           for p in t.placements)
                if drop_lead and any(p.is_shard(0) for p in t.placements):
                    raise ValueError("scan over a sharded leading dim")
                info.append((t.device_mesh, pl, t.shape[1:] if drop_lead else t.shape))
            else:
                info.append(None)
        return [t.to_local() if isinstance(t, DTensor) else t for t in leaves], info

    def wrap(leaves, info, lead=None):
        out = []
        for t, i in zip(leaves, info):
            if i is None:
                out.append(t)
                continue
            mesh, pl, shape = i
            if lead is not None:
                pl = tuple(Shard(p.dim + 1) if p.is_shard() else p for p in pl)
                shape = (lead, *shape)
            shape = torch.Size(shape)
            out.append(DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                                          stride=contiguous_stride(shape)))
        return out

    c_leaves, c_spec = tree_leaves_of(carry)
    x_leaves, x_spec = tree_leaves_of(xs)
    if length is None:
        length = x_leaves[0].shape[0]
    cl, ci = unwrap(c_leaves, False)
    xl, xi = unwrap(x_leaves, True)
    ins = scan_enter(cl + xl, int(length), len(cl))
    ins = wrap(ins[:len(cl)], ci) + wrap(ins[len(cl):], xi)
    carry, y = step(tree_of(ins[:len(cl)], c_spec), tree_of(ins[len(cl):], x_spec))
    c_leaves, c_spec = tree_leaves_of(carry)
    y_leaves, y_spec = tree_leaves_of(y)
    cl, ci = unwrap(c_leaves, False)
    yl, yi = unwrap(y_leaves, False)
    outs = scan_exit(cl + yl, int(length), len(cl))
    outs = wrap(outs[:len(cl)], ci) + wrap(outs[len(cl):], yi, lead=int(length))
    return tree_of(outs[:len(cl)], c_spec), tree_of(outs[len(cl):], y_spec)


# --------------------------------------------------------------------------
# xLSTM cells (mLSTM chunkwise-parallel + sLSTM sequential)
# --------------------------------------------------------------------------
#
# Plain torch, as the reference's are plain lax (no Pallas kernel).  Each of
# the reference's ``jnp.einsum`` contractions is written out as the batched
# products JAX lowers it to (opt_einsum's order, ``dot_general``'s operand
# roles), so that both tracers see the same (M, N, K), the outer products
# ``(N, 1, D)`` among them.  The elementwise products JAX emits as
# all-batch products, ``(N, 1, 1)``, are elementwise multiplies here: as a
# ``torch.bmm`` over N 1x1 matrices the chunk body's (2097152, 1, 1) took
# 1.86-1.90 ms on an H100 (CUDA events) against the multiply's 0.015, with
# the same bits, so the ingest test sets them aside, counted (``ALL_BATCH``).  Every product runs
# in float32 (TF32 stays off), with the batch and heads of a chunk leading
# (``B*H`` is every product's batch dim), where the reference's layout is
# (B, chunk, H, D).


class _Dot(torch.autograd.Function):
    """``torch.bmm`` whose backward forms each operand's gradient as JAX's
    transpose of ``dot_general`` does: ``g @ b^T`` for ``a`` and ``(g^T @
    a)^T`` for ``b`` (torch's ``a^T @ g`` has the same flops and other
    (M, N, K)), so the joint graphs have the reference's products too.  An
    outer product's ``b`` (``a`` (N, 1, 1)) takes ``g * a``: JAX's all-batch
    (N*D, 1, 1) product, as a multiply."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = torch.bmm(g, b.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        gb = None
        if ctx.needs_input_grad[1]:
            gb = g * a if a.shape[1:] == (1, 1) else torch.bmm(g.transpose(1, 2), a).transpose(1, 2)
        return ga, gb


_dot = _Dot.apply


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -_softplus(-x)


def _heads_first(t: torch.Tensor, B: int, NC: int, chunk: int, H: int) -> torch.Tensor:
    """(B, NC*chunk, H[, X]) -> (NC, B*H, chunk[, X]) in float32, transposed
    and widened in one pass (the reference's ``shp`` cast and its scan
    transpose)."""
    t = t.reshape(B, NC, chunk, H, -1)
    t = t.permute(1, 0, 3, 2, 4).to(torch.float32, memory_format=torch.contiguous_format,
                                    copy=True)
    return t.reshape(NC, B * H, chunk, -1)


def mlstm_chunkwise(q, k, v, i_gate, f_gate, state=None, *, chunk: int = 256):
    """Stabilised chunkwise mLSTM (matrix-memory) forward.

    q,k,v: (B, S, H, D);  i_gate,f_gate: (B, S, H) pre-activation.
    state: optional (C, n, m) with C:(B,H,D,D), n:(B,H,D), m:(B,H).
    Returns (y, (C,n,m)), the state in float32.  [arXiv:2405.04517]

    A sequence that is not a multiple of the chunk is padded with forget
    gates of -1e9, as in the reference: the outputs are right, but the
    padded steps wipe the returned state (C = 0, n = 0, m = 0).  That is a
    fault of the reference, kept bit for bit for parity (ROADMAP queue C:
    fixed in both packages or in neither)."""
    B, S, H, D = q.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        beyond = (torch.arange(S + pad, device=q.device) >= S)[None, :, None]
        i_gate = F.pad(i_gate, (0, 0, 0, pad))
        f_gate = F.pad(f_gate, (0, 0, 0, pad)) - (1e9 * beyond).to(f_gate.dtype)
    Sp = q.shape[1]
    NC, BH = Sp // chunk, B * H
    q_, k_, v_ = (_heads_first(t, B, NC, chunk, H) for t in (q, k, v))       # (NC,BH,T,D)
    ig = _heads_first(i_gate, B, NC, chunk, H)[..., 0]                      # (NC,BH,T)
    lf = _log_sigmoid(_heads_first(f_gate, B, NC, chunk, H)[..., 0])
    csum_f = torch.cumsum(lf, dim=-1)              # within-chunk cumulative log-forget
    total_f = csum_f[..., -1]                      # (NC, BH)

    scale = 1.0 / math.sqrt(D)
    if state is None:
        C0 = torch.zeros((BH, D, D), dtype=torch.float32, device=q.device)
        n0 = torch.zeros((BH, D), dtype=torch.float32, device=q.device)
        m0 = torch.full((BH,), NEG_INF, dtype=torch.float32, device=q.device)
    else:
        C0, n0, m0 = (s.float().reshape(BH, *s.shape[2:]) for s in state)

    idx = torch.arange(chunk, device=q.device)
    causal = idx[:, None] >= idx[None, :]          # (t, s)

    def chunk_step(carry, inp):
        C, n, m = carry
        qc, kc, vc, igc, cfc, tfc = inp            # (BH,T,D) x3, (BH,T) x2, (BH,)
        # log weights of the state path (decay from the chunk's start) and of
        # the intra-chunk path: g[t, s] = cfc[t] - cfc[s] + igc[s] for s <= t
        g = cfc[:, :, None] - cfc[:, None, :] + igc[:, None, :]            # (BH,t,s)
        g = torch.where(causal, g, NEG_INF)
        m_intra = g.amax(-1)                                                # (BH,t)
        m_t = torch.maximum(cfc + m[:, None], m_intra)
        w_state = torch.exp(cfc + m[:, None] - m_t)                         # (BH,t)
        w_intra = torch.exp(g - m_t[:, :, None])                            # (BH,t,s)

        s_intra = _dot(qc, kc.transpose(1, 2)) * scale                     # (BH,t,s)
        sw = s_intra * w_intra                     # JAX: an all-batch (N, 1, 1) product
        qs = qc * scale
        cq = _dot(C.transpose(1, 2), qs.transpose(1, 2))                   # (BH,k,t)
        num = _dot(sw, vc) + _dot(w_state.reshape(-1, 1, 1),
                                  cq.transpose(1, 2).reshape(-1, 1, D)).view(BH, chunk, D)
        den1 = _dot(s_intra.reshape(-1, 1, chunk), w_intra.reshape(-1, chunk, 1))
        den2 = w_state * _dot(qs, n[:, :, None])[..., 0]    # JAX: all-batch (N, 1, 1)
        den = torch.abs(den1.view(BH, chunk) + den2)
        y = num / torch.maximum(den, torch.exp(-m_t))[..., None]  # lower-bound denom (xLSTM eq. 25)

        # state update to the end of the chunk
        m_next = torch.maximum(tfc + m, (tfc[:, None] - cfc + igc).amax(-1))
        w_old = torch.exp(tfc + m - m_next)                                  # (BH,)
        kw = torch.exp(tfc[:, None] - cfc + igc - m_next[:, None])           # (BH,s)
        kv = _dot(kw.reshape(-1, 1, 1), vc.reshape(-1, 1, D)).view(BH, chunk, D)
        C_next = C * w_old[:, None, None] + _dot(kc.transpose(1, 2), kv)
        n_next = n * w_old[:, None] + _dot(kc.transpose(1, 2), kw[:, :, None])[..., 0]
        return (C_next, n_next, m_next), y

    (C, n, m), ys = scan(chunk_step, (C0, n0, m0), (q_, k_, v_, ig, csum_f, total_f))
    y = ys.view(NC, B, H, chunk, D).permute(1, 0, 3, 2, 4)
    y = y.to(q.dtype, memory_format=torch.contiguous_format, copy=True).reshape(B, Sp, H, D)
    return y[:, :S].contiguous(), (C.view(B, H, D, D), n.view(B, H, D), m.view(B, H))


def mlstm_step(q_t, k_t, v_t, i_t, f_t, state):
    """Single-token mLSTM update; q_t,k_t,v_t: (B,H,D); i_t,f_t: (B,H);
    state (C, n, m) float32, a decode cache's.  Returns (y in q_t's dtype,
    (C, n, m)): the state's tensors, updated where they lie by the
    reference's operations in its order, so the matrix memory is read and
    written once a step (the reference returns new arrays)."""
    C, n, m = state
    B, H, D = q_t.shape
    BH = B * H
    qf, kf, vf = (t.float() for t in (q_t, k_t, v_t))
    i_f = i_t.float()
    lf = _log_sigmoid(f_t.float())
    m_new = torch.maximum(lf + m, i_f)
    kv = _dot(kf.reshape(BH, D, 1), vf.reshape(BH, 1, D)).view(B, H, D, D)
    decay, gain = torch.exp(lf + m - m_new), torch.exp(i_f - m_new)
    C.mul_(decay[..., None, None]).add_(gain[..., None, None] * kv)
    n.mul_(decay[..., None]).add_(gain[..., None] * kf)
    m_new = m.copy_(m_new)
    qs = (qf * (1.0 / math.sqrt(D))).reshape(BH, 1, D)
    num = _dot(qs, C.reshape(BH, D, D)).view(B, H, D)
    den = torch.abs(_dot(qs, n.reshape(BH, D, 1)).view(B, H))
    y = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return y.to(q_t.dtype), (C, n, m_new)


def slstm_scan(p: dict, x: torch.Tensor, state=None):
    """Sequential sLSTM over time.  x: (B, S, 4W) pre-projected gates packed
    as (i, f, z, o) contributions; the recurrent weights ``p["r"]`` (W, 4W)
    act on h.  Returns (h over time in x's dtype, (c, n, h, m) in float32)."""
    B, S, W4 = x.shape
    W = W4 // 4
    if state is None:
        z = torch.zeros((B, W), dtype=torch.float32, device=x.device)
        state = (z, z + 1e-6, z, z - 1e9)  # c, n, h, m

    # R rides in the carry, unchanged: a traced step (``_marked_scan``)
    # then adds its gradient into the carried one at every step, as the loop's
    # backward accumulates it (and JAX's transposed scan carries it)
    def step(carry, x_t):
        c, n, h, m, R = carry
        g = x_t.float() + h @ R
        gi, gf, gz, go = torch.split(g, W, dim=-1)
        lf = _log_sigmoid(gf)
        m_new = torch.maximum(lf + m, gi)
        c_new = c * torch.exp(lf + m - m_new) + torch.exp(gi - m_new) * torch.tanh(gz)
        n_new = n * torch.exp(lf + m - m_new) + torch.exp(gi - m_new)
        h_new = torch.sigmoid(go) * c_new / torch.clamp_min(n_new, 1e-9)
        return (c_new, n_new, h_new, m_new, R), h_new

    (c, n, h, m, _), ys = scan(step, (*state, p["r"].float()), x.transpose(0, 1))
    ys = ys.transpose(0, 1).to(x.dtype, memory_format=torch.contiguous_format, copy=True)
    return ys, (c, n, h, m)
