"""Parameter-tree construction (counterpart of ``repro/models/params.py``), for the
``attn_ffn`` block of the dense decoders and of the VLM backbone, the
``moe_attn_ffn`` block of the MoE decoders with GQA attention, the
``mla_moe`` block of those with MLA, the ``griffin_rec`` / ``griffin_attn``
blocks of the RG-LRU hybrid, the ``mlstm`` / ``slstm`` blocks of the xLSTM
stack and Whisper's ``xattn`` decoder block and ``enc`` encoder block.

One function (``build_params``) drives its consumers through a creator
callback ``creator(path, shape, logical, fan_in)``: abstract shapes
(``abstract_params``, meta tensors), concrete init (``init_params``), logical
axes (``param_logical_axes``, which ``training.train_step.param_pspecs``
resolves against a mesh) and parameter counts (``count_params``).  The
reference stacks block parameters over depth so that it can ``lax.scan``
over them; torch loops over layers, so here
``tree["blocks"]`` is a plain list with one dict a layer, each leaf with the
reference's per-layer shape and its logical axes with the reference's leading
``"layer"`` dropped; an encoder-decoder's ``tree["encoder"]`` is
``{"blocks": [one dict an encoder layer], "final_norm"}`` likewise.
``repro_torch.convert`` unstacks a reference tree into this form.
"""
from __future__ import annotations

import functools
import math
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, torch_dtype

Creator = Callable[..., object]  # creator(path, shape, logical, fan_in) -> leaf


def block_cycle(cfg: ModelConfig) -> tuple[tuple[str, ...], int, tuple[str, ...]]:
    """Return (cycle_kinds, n_cycles, tail_kinds) for the decoder stack."""
    if cfg.family in ("dense", "vlm"):
        cycle = ("attn_ffn",)
    elif cfg.family == "moe":
        cycle = ("moe_attn_ffn" if cfg.attention != "mla" else "mla_moe",)
    elif cfg.family == "hybrid":
        cycle = tuple("griffin_rec" if k == "rec" else "griffin_attn" for k in cfg.block_pattern)
    elif cfg.family == "ssm":
        cycle = cfg.block_pattern
    elif cfg.family == "audio":
        cycle = ("xattn",)
    else:
        raise ValueError(f"family {cfg.family!r} is not ported "
                         "(dense, MoE, hybrid, ssm, audio and vlm only)")
    n = cfg.num_layers // len(cycle)
    tail_len = cfg.num_layers - n * len(cycle)
    return cycle, n, cycle[:tail_len]


def _norm(cfg, c: Creator, path):
    p = {"w": c(path + ("w",), (cfg.d_model,), ("embed",), 0)}
    if cfg.norm == "layernorm":
        p["b"] = c(path + ("b",), (cfg.d_model,), ("embed",), 0)
    return p


def _vec_norm(cfg, c: Creator, path, dim):
    return {"w": c(path + ("w",), (dim,), (None,), 0)}


def _gqa_attn(cfg, c: Creator, path):
    D, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "q": {"w": c(path + ("q", "w"), (D, H, Dh), ("embed", "heads", "head_dim"), D)},
        "k": {"w": c(path + ("k", "w"), (D, Hkv, Dh), ("embed", "kv_heads", "head_dim"), D)},
        "v": {"w": c(path + ("v", "w"), (D, Hkv, Dh), ("embed", "kv_heads", "head_dim"), D)},
        "o": {"w": c(path + ("o", "w"), (H, Dh, D), ("heads", "head_dim", "embed"), H * Dh)},
    }
    if cfg.qkv_bias:
        p["q"]["b"] = c(path + ("q", "b"), (H, Dh), ("heads", "head_dim"), 0)
        p["k"]["b"] = c(path + ("k", "b"), (Hkv, Dh), ("kv_heads", "head_dim"), 0)
        p["v"]["b"] = c(path + ("v", "b"), (Hkv, Dh), ("kv_heads", "head_dim"), 0)
    return p


def _mla_attn(cfg, c: Creator, path):
    D, H = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "dq": {"w": c(path + ("dq", "w"), (D, qr), ("embed", None), D)},
        "q_norm": _vec_norm(cfg, c, path + ("q_norm",), qr),
        "uq": {"w": c(path + ("uq", "w"), (qr, H, dn + dr), (None, "heads", "head_dim"), qr)},
        "dkv": {"w": c(path + ("dkv", "w"), (D, kvr), ("embed", None), D)},
        "kv_norm": _vec_norm(cfg, c, path + ("kv_norm",), kvr),
        "uk": {"w": c(path + ("uk", "w"), (kvr, H, dn), (None, "heads", "head_dim"), kvr)},
        "uv": {"w": c(path + ("uv", "w"), (kvr, H, dv), (None, "heads", "head_dim"), kvr)},
        "kr": {"w": c(path + ("kr", "w"), (D, dr), ("embed", None), D)},
        "o": {"w": c(path + ("o", "w"), (H, dv, D), ("heads", "head_dim", "embed"), H * dv)},
    }


def _mlp(cfg, c: Creator, path, d_ff=None, *, bias=False):
    D = cfg.d_model
    F = d_ff if d_ff is not None else cfg.d_ff
    p = {}
    if cfg.act in ("swiglu", "geglu"):
        p["gate"] = {"w": c(path + ("gate", "w"), (D, F), ("embed", "ffn"), D)}
    p["up"] = {"w": c(path + ("up", "w"), (D, F), ("embed", "ffn"), D)}
    p["down"] = {"w": c(path + ("down", "w"), (F, D), ("ffn", "embed"), F)}
    if bias:
        p["up"]["b"] = c(path + ("up", "b"), (F,), ("ffn",), 0)
        p["down"]["b"] = c(path + ("down", "b"), (D,), ("embed",), 0)
        if "gate" in p:
            p["gate"]["b"] = c(path + ("gate", "b"), (F,), ("ffn",), 0)
    return p


def _moe(cfg, c: Creator, path):
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": {"w": c(path + ("router", "w"), (D, E), ("embed", None), D)},
        "experts": {
            "gate": c(path + ("experts", "gate"), (E, D, F), ("expert", "embed", "expert_ffn"), D),
            "up": c(path + ("experts", "up"), (E, D, F), ("expert", "embed", "expert_ffn"), D),
            "down": c(path + ("experts", "down"), (E, F, D), ("expert", "expert_ffn", "embed"), F),
        },
    }
    if cfg.num_shared_experts > 0:
        p["shared"] = _mlp(cfg, c, path + ("shared",), cfg.moe_d_ff * cfg.num_shared_experts)
    return p


def _rglru_gates(cfg, c: Creator, path, W: int):
    nb = max(cfg.lru_gate_blocks, 1)
    if nb > 1:
        # Griffin's appendix: block-diagonal recurrence and input gates, (nb, Wb, Wb),
        # which keep the gate products local under width sharding
        shp, ax = (nb, W // nb, W // nb), ("lru_width", None, None)
    else:
        shp, ax = (W, W), ("lru_width", None)
    return {
        "wa": c(path + ("rglru", "wa"), shp, ax, shp[-1]),
        "ba": c(path + ("rglru", "ba"), (W,), (None,), 0),
        "wx": c(path + ("rglru", "wx"), shp, ax, shp[-1]),
        "bx": c(path + ("rglru", "bx"), (W,), (None,), 0),
        "lam": c(path + ("rglru", "lam"), (W,), (None,), 0),
    }


def _griffin_rec(cfg, c: Creator, path):
    D, W, K = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.conv_width
    return {
        "ln": _norm(cfg, c, path + ("ln",)),
        "in_gate": {"w": c(path + ("in_gate", "w"), (D, W), ("embed", "lru_width"), D)},
        "in_rec": {"w": c(path + ("in_rec", "w"), (D, W), ("embed", "lru_width"), D)},
        "conv": {"w": c(path + ("conv", "w"), (K, W), (None, "lru_width"), 0),
                 "b": c(path + ("conv", "b"), (W,), ("lru_width",), 0)},
        "rglru": _rglru_gates(cfg, c, path, W),
        "out": {"w": c(path + ("out", "w"), (W, D), ("lru_width", "embed"), W)},
        "ln2": _norm(cfg, c, path + ("ln2",)),
        "mlp": _mlp(cfg, c, path + ("mlp",)),
    }


def _griffin_attn(cfg, c: Creator, path):
    return {
        "ln": _norm(cfg, c, path + ("ln",)),
        "attn": _gqa_attn(cfg, c, path + ("attn",)),
        "ln2": _norm(cfg, c, path + ("ln2",)),
        "mlp": _mlp(cfg, c, path + ("mlp",)),
    }


def _attn_ffn(cfg, c: Creator, path):
    return {
        "ln1": _norm(cfg, c, path + ("ln1",)),
        "attn": _gqa_attn(cfg, c, path + ("attn",)),
        "ln2": _norm(cfg, c, path + ("ln2",)),
        "mlp": _mlp(cfg, c, path + ("mlp",)),
    }


def _moe_attn_ffn(cfg, c: Creator, path):
    return {
        "ln1": _norm(cfg, c, path + ("ln1",)),
        "attn": _gqa_attn(cfg, c, path + ("attn",)),
        "ln2": _norm(cfg, c, path + ("ln2",)),
        "moe": _moe(cfg, c, path + ("moe",)),
    }


def _mla_moe(cfg, c: Creator, path):
    return {
        "ln1": _norm(cfg, c, path + ("ln1",)),
        "attn": _mla_attn(cfg, c, path + ("attn",)),
        "ln2": _norm(cfg, c, path + ("ln2",)),
        "moe": _moe(cfg, c, path + ("moe",)),
    }


def _mlstm_block(cfg, c: Creator, path):
    D = cfg.d_model
    Di = int(cfg.mlstm_proj_factor * D)
    H, Dh = cfg.num_heads, cfg.head_dim
    DQ = H * Dh
    return {
        "ln": _norm(cfg, c, path + ("ln",)),
        "up": {"w": c(path + ("up", "w"), (D, Di), ("embed", "ffn"), D)},
        "conv": {"w": c(path + ("conv", "w"), (cfg.conv_width, Di), (None, "ffn"), 0),
                 "b": c(path + ("conv", "b"), (Di,), ("ffn",), 0)},
        "q": {"w": c(path + ("q", "w"), (Di, DQ), ("ffn", None), Di)},
        "k": {"w": c(path + ("k", "w"), (Di, DQ), ("ffn", None), Di)},
        "v": {"w": c(path + ("v", "w"), (Di, DQ), ("ffn", None), Di)},
        "gates": {"w": c(path + ("gates", "w"), (Di, 2 * H), ("ffn", None), Di),
                  "b": c(path + ("gates", "b"), (2 * H,), (None,), 0)},
        "out_norm": _vec_norm(cfg, c, path + ("out_norm",), DQ),
        "z": {"w": c(path + ("z", "w"), (D, DQ), ("embed", None), D)},
        "o": {"w": c(path + ("o", "w"), (DQ, D), (None, "embed"), DQ)},
    }


def _slstm_block(cfg, c: Creator, path):
    D = cfg.d_model
    W = D
    F = int(cfg.slstm_proj_factor * D)
    return {
        "ln": _norm(cfg, c, path + ("ln",)),
        "gates_in": {"w": c(path + ("gates_in", "w"), (D, 4 * W), ("embed", None), D)},
        "r": c(path + ("r",), (W, 4 * W), (None, None), W),
        "out_norm": _vec_norm(cfg, c, path + ("out_norm",), W),
        "ffn_up": {"w": c(path + ("ffn_up", "w"), (W, F), ("embed", "ffn"), W)},
        "ffn_down": {"w": c(path + ("ffn_down", "w"), (F, D), ("ffn", "embed"), F)},
    }


def _xattn_block(cfg, c: Creator, path):
    """Whisper decoder block: self-attn + cross-attn + FFN (LayerNorm, biases)."""
    return {
        "ln1": _norm(cfg, c, path + ("ln1",)),
        "self_attn": _gqa_attn(cfg, c, path + ("self_attn",)),
        "ln2": _norm(cfg, c, path + ("ln2",)),
        "cross_attn": _gqa_attn(cfg, c, path + ("cross_attn",)),
        "ln3": _norm(cfg, c, path + ("ln3",)),
        "mlp": _mlp(cfg, c, path + ("mlp",), bias=True),
    }


def _enc_block(cfg, c: Creator, path):
    """Whisper encoder block: bidirectional self-attn + FFN (LayerNorm, biases)."""
    return {
        "ln1": _norm(cfg, c, path + ("ln1",)),
        "attn": _gqa_attn(cfg, c, path + ("attn",)),
        "ln2": _norm(cfg, c, path + ("ln2",)),
        "mlp": _mlp(cfg, c, path + ("mlp",), bias=True),
    }


BLOCK_PARAMS = {"attn_ffn": _attn_ffn, "moe_attn_ffn": _moe_attn_ffn, "mla_moe": _mla_moe,
                "griffin_rec": _griffin_rec, "griffin_attn": _griffin_attn,
                "mlstm": _mlstm_block, "slstm": _slstm_block, "xattn": _xattn_block,
                "enc": _enc_block}


def layer_kinds(cfg: ModelConfig) -> tuple[str, ...]:
    """Block kind of every layer, in order."""
    cycle, n, tail = block_cycle(cfg)
    return cycle * n + tail


def build_params(cfg: ModelConfig, creator: Creator) -> dict:
    tree: dict = {
        "embed": {"w": creator(("embed", "w"), (cfg.vocab_size, cfg.d_model),
                               ("vocab", "embed"), cfg.d_model)},
        "final_norm": _norm(cfg, creator, ("final_norm",)),
    }
    tree["blocks"] = [BLOCK_PARAMS[kind](cfg, creator, ("blocks", str(i), kind))
                      for i, kind in enumerate(layer_kinds(cfg))]
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": creator(("lm_head", "w"), (cfg.d_model, cfg.vocab_size),
                                        ("embed", "vocab"), cfg.d_model)}
    if cfg.encoder_layers > 0:
        tree["encoder"] = {
            "blocks": [_enc_block(cfg, creator, ("encoder", "blocks", str(i), "enc"))
                       for i in range(cfg.encoder_layers)],
            "final_norm": _norm(cfg, creator, ("encoder", "final_norm")),
        }
    return tree


def abstract_params(cfg: ModelConfig, dtype=None) -> dict:
    """The tree as tensors on the ``meta`` device: each leaf has its shape and
    dtype and allocates nothing (the reference's ``ShapeDtypeStruct``s, as
    ``launch/specs.input_specs`` gives the inputs)."""
    dt = dtype or torch_dtype(cfg.param_dtype)

    def c(path, shape, logical, fan_in):
        return torch.empty(shape, dtype=dt, device="meta")

    return build_params(cfg, c)


def param_logical_axes(cfg: ModelConfig) -> dict:
    """The tree with each leaf's logical axes (a tuple, one entry a dim)."""
    def c(path, shape, logical, fan_in):
        return tuple(logical)

    return build_params(cfg, c)


def init_params(cfg: ModelConfig, generator: torch.Generator, device, dtype=None):
    """Concrete init on ``device`` from ``generator`` (which must live on the
    same device).  Same distributions as the reference: normal with std
    ``1/sqrt(fan_in)`` for matrices, norm scales 1 (0 for the ``1 + w`` form),
    biases 0, and the RG-LRU's ``lam`` in float32 such that its decay
    ``exp(-8 softplus(lam))`` is uniform in [0.9, 0.999] (Griffin's appendix;
    the conv filters, which the reference's creator treats as biases, are 0
    too: at this init an mLSTM block adds exactly 0, so tests and the card's
    checks draw them from a seed).  The numbers differ from the reference's for the same seed (the
    two frameworks' generators differ); tests carry weights across instead."""
    dt = dtype or torch_dtype(cfg.param_dtype)
    device = torch.device(device)

    def c(path, shape, logical, fan_in):
        if fan_in <= 0:  # biases / norm scales / gates
            name, parent = path[-1], path[-2] if len(path) > 1 else ""
            is_norm = parent.startswith("ln") or "norm" in parent
            if name == "w" and is_norm and not cfg.rms_offset:
                return torch.ones(shape, dtype=dt, device=device)
            if name == "lam":
                u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
                u = 0.9 + u * (0.999 - 0.9)
                return torch.log(torch.expm1(-torch.log(u) / 8.0))
            return torch.zeros(shape, dtype=dt, device=device)
        std = 1.0 / math.sqrt(fan_in)
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return w.mul_(std).to(dt)

    return build_params(cfg, c)


@functools.lru_cache(maxsize=512)
def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Total parameter count; ``active_only`` counts the top-k routed experts
    only (the MoE's active parameters, ``MODEL_FLOPS = 6 * N_active * D``),
    scaling each expert leaf by ``top_k / num_experts`` as the reference does.
    The dense families count the same either way."""
    total = [0]

    def c(path, shape, logical, fan_in):
        n = math.prod(shape)
        if active_only and "experts" in path:
            n = n * (cfg.top_k / cfg.num_experts)
        total[0] += n
        return None

    build_params(cfg, c)
    return int(total[0])
