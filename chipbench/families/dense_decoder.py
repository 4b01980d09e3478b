"""The dense GQA decoder family (Qwen2.5, Yi: Llama-style decoders with a
SwiGLU MLP): everything the benchmark needs to know of a configuration of
this family, found by the configuration file's ``family`` key.  A family of
another shape (experts, latent attention, a tied or GeGLU decoder) brings a
file of its own beside this one with the same five functions.

  * ``leaf_specs``: the weights' layout, the one the port's ``Model`` takes
    (one dict a layer under ``blocks``; q/k/v as (D, H, Dh), o as (H, Dh, D),
    the MLP's gate/up (D, F) and down (F, D), the head (D, V)), written out
    from the configuration file, not taken from the port;
  * ``port_config``: the port's ``ModelConfig`` with every size the file
    states;
  * ``train_flops``, ``prefill_work``, ``decode_step_work``: a step's model
    operations and least bytes, counted from the shapes.
"""
from __future__ import annotations

import math

from chipbench.work import causal_pairs


def _dims(cfg: dict):
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return D, H, cfg["num_key_value_heads"], cfg.get("head_dim", D // H)


def leaf_specs(cfg: dict) -> list[tuple[tuple, tuple, str, int]]:
    """(path, shape, kind, fan_in) of every leaf, in stream order; kind is
    ``matrix``, ``norm`` or ``bias``."""
    D, H, Hkv, Dh = _dims(cfg)
    F, V, L = cfg["intermediate_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    specs = [(("embed", "w"), (V, D), "matrix", D), (("final_norm", "w"), (D,), "norm", 0)]
    for i in range(L):
        b = ("blocks", i)
        specs.append((b + ("ln1", "w"), (D,), "norm", 0))
        for name, heads in (("q", H), ("k", Hkv), ("v", Hkv)):
            specs.append((b + ("attn", name, "w"), (D, heads, Dh), "matrix", D))
            if cfg["qkv_bias"]:
                specs.append((b + ("attn", name, "b"), (heads, Dh), "bias", 0))
        specs += [(b + ("attn", "o", "w"), (H, Dh, D), "matrix", H * Dh),
                  (b + ("ln2", "w"), (D,), "norm", 0),
                  (b + ("mlp", "gate", "w"), (D, F), "matrix", D),
                  (b + ("mlp", "up", "w"), (D, F), "matrix", D),
                  (b + ("mlp", "down", "w"), (F, D), "matrix", F)]
    if not cfg["tie_word_embeddings"]:
        specs.append((("lm_head", "w"), (D, V), "matrix", D))
    return specs


def port_config(cfgj: dict):
    """The port's ``ModelConfig``: the port's config of ``port_arch`` with
    every size the file states."""
    from repro_torch.configs import get_config
    base = get_config(cfgj["port_arch"])
    D, H, Hkv, Dh = _dims(cfgj)
    if cfgj["hidden_act"] != "silu" or base.act != "swiglu":
        raise ValueError(f"{cfgj['name']}: the dense_decoder family is SwiGLU")
    return base.replace(
        name=cfgj["name"], num_layers=cfgj["num_hidden_layers"], d_model=D, num_heads=H,
        num_kv_heads=Hkv, head_dim=Dh, d_ff=cfgj["intermediate_size"],
        vocab_size=cfgj["vocab_size"], qkv_bias=cfgj["qkv_bias"],
        rope_theta=float(cfgj["rope_theta"]), norm_eps=float(cfgj["rms_norm_eps"]),
        tie_embeddings=cfgj["tie_word_embeddings"], dtype=cfgj["torch_dtype"],
        param_dtype=cfgj["torch_dtype"])


def body_matmul_params(cfg: dict) -> int:
    """Parameters of the layers' matrix products (no embedding, no head)."""
    return sum(math.prod(shape) for path, shape, kind, _ in leaf_specs(cfg)
               if kind == "matrix" and path[0] == "blocks")


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model operations of one training step: 6 N a token over the matrix
    products (N counts the head, not the embedding table) and 3 x 4 H Dh a
    visible causal pair a layer for attention (forward and backward, no
    recompute)."""
    D, H, _, Dh = _dims(cfg)
    n = body_matmul_params(cfg) + D * cfg["vocab_size"]
    return (6.0 * n * batch * seq
            + 3.0 * 4.0 * H * Dh * batch * causal_pairs(seq) * cfg["num_hidden_layers"])


def prefill_work(cfg: dict, S: int, elt: int = 2) -> tuple[float, float]:
    """(bytes, operations) of one B1 prefill of S tokens through the whole
    model, logits at its last position: the layers' products over S rows,
    causal attention, the head over one row; the weights read once, the
    embedding rows read and the K/V rows written once."""
    D, H, Hkv, Dh = _dims(cfg)
    V, L, n = cfg["vocab_size"], cfg["num_hidden_layers"], body_matmul_params(cfg)
    flops = 2.0 * n * S + 4.0 * H * Dh * causal_pairs(S) * L + 2.0 * D * V
    nbytes = (n + D * V + S * D + 2 * S * L * Hkv * Dh) * elt
    return float(nbytes), flops


def decode_step_work(cfg: dict, B: int, rows: int, elt: int = 2) -> tuple[float, float]:
    """(bytes, operations) of one decode step of B live rows that attend to
    ``rows`` cache rows in all (a layer): the weights read once, the live K/V
    rows read once and the new ones written, B embedding rows."""
    D, H, Hkv, Dh = _dims(cfg)
    V, L, n = cfg["vocab_size"], cfg["num_hidden_layers"], body_matmul_params(cfg)
    flops = 2.0 * (n + D * V) * B + 4.0 * H * Dh * rows * L
    nbytes = (n + D * V + B * D + 2 * (rows + B) * L * Hkv * Dh) * elt
    return float(nbytes), flops
