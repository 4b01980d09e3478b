"""Carries weights and decode state between the JAX reference and the port.

The reference stacks block parameters and caches over depth (leading layer
dim, for ``lax.scan``); the port keeps one dict a layer.
:func:`from_reference_params` and :func:`from_reference_cache` take the
reference's trees **as numpy arrays** (this package never imports jax; bf16
has no numpy dtype, so callers hand float32 over and name the torch dtype
they want) and return the port's trees on a device;
:func:`to_reference_params` is the inverse.  :func:`reference_layout` and
:func:`port_layout` restack a tree of tensors (parameters, gradients, moments)
between the two layouts; the optimizer and the checkpoints use them where the
reference's numbers or files depend on its layout.  An encoder-decoder's
encoder (``encoder.blocks.cycle[0]`` stacked over its layers in the
reference, one dict a layer in the port, beside ``encoder.final_norm``) is
carried the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.models.kvcache import _kind_cache, build_cache, cache_len_of
from repro_torch.models.params import block_cycle, build_params, layer_kinds


def _leaf(a, device, dtype) -> torch.Tensor:
    # a copy: the port updates caches in place and must not write into the caller's array
    return torch.tensor(np.asarray(a)).to(device=device, dtype=dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _map_keyed(tree, fn, keys=()):
    """``fn(leaf, keys)`` at every leaf, ``keys`` the dict keys and list
    indices on its way."""
    if isinstance(tree, dict):
        return {k: _map_keyed(v, fn, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_keyed(v, fn, keys + (i,)) for i, v in enumerate(tree)]
    return fn(tree, keys)


def _unstack_blocks(cfg: ModelConfig, blocks, convert, *, encoder: bool = False):
    """``{"cycle": [stacked tree a kind], "tail": [tree a kind]}`` -> one tree
    a layer, in layer order; ``convert(array, keys)`` makes each leaf.
    ``encoder``: the blocks of ``cfg``'s encoder, one ``enc`` stacked over its
    layers."""
    cycle, n, tail = (("enc",), cfg.encoder_layers, ()) if encoder else block_cycle(cfg)
    if (len(blocks["cycle"]) != len(cycle) or len(blocks["tail"]) != len(tail)
            or any(np.shape(a)[:1] != (n,) for c in blocks["cycle"] for a in _leaves(c))):
        raise ValueError("reference tree does not match the config's block cycle")
    layers = []
    for i in range(n):
        for j in range(len(cycle)):
            layers.append(_map_keyed(blocks["cycle"][j],
                                     lambda a, keys, i=i: convert(np.asarray(a)[i], keys)))
    for j in range(len(tail)):
        layers.append(_map_keyed(blocks["tail"][j],
                                 lambda a, keys: convert(np.asarray(a), keys)))
    return layers


def from_reference_params(np_tree: dict, cfg: ModelConfig, device, dtype=None) -> dict:
    """Reference parameter tree (``repro.models.params.build_params`` names:
    ``embed.w (V,D)``, ``blocks.cycle[0].{ln1,ln2}.w (L,D)``, ``attn.{q,k,v,o}``,
    ``mlp.{gate,up,down}`` or, in a MoE block, ``moe.router.w (L,D,E)`` and
    ``moe.experts.{gate,up} (L,E,D,F)``, ``moe.experts.down (L,E,F,D)``, a
    shared expert's ``moe.shared.{gate,up,down}``, MLA's ``attn.{dq, q_norm,
    uq, dkv, kv_norm, uk, uv, kr, o}``, the RG-LRU block's ``ln``, ``in_gate``,
    ``in_rec``, ``conv.{w, b}``, ``rglru.{wa, ba, wx, bx, lam}``, ``out``,
    Whisper's ``ln1..3``, ``self_attn``, ``cross_attn`` and biased ``mlp``,
    ``final_norm.w``, optional ``lm_head.w``, Whisper's ``encoder.blocks``
    and ``encoder.final_norm``) as numpy arrays -> the port's
    tree on ``device``, every leaf in ``dtype`` but ``rglru.lam``, which stays
    float32 as the reference's init makes it.  A tree of another config
    (names or shapes) raises."""
    dt = dtype or torch_dtype(cfg.param_dtype)
    device = torch.device(device)

    def convert(a, keys=()):
        return _leaf(a, device, torch.float32 if keys[-1:] == ("lam",) else dt)

    tree = {
        "embed": _map(np_tree["embed"], convert),
        "final_norm": _map(np_tree["final_norm"], convert),
        "blocks": _unstack_blocks(cfg, np_tree["blocks"], convert),
    }
    if "lm_head" in np_tree:
        tree["lm_head"] = _map(np_tree["lm_head"], convert)
    if "encoder" in np_tree:
        enc = np_tree["encoder"]
        tree["encoder"] = {"blocks": _unstack_blocks(cfg, enc["blocks"], convert, encoder=True),
                           "final_norm": _map(enc["final_norm"], convert)}

    # hold the result to the port's own build_params: same names, same shapes
    want = build_params(cfg, lambda path, shape, logical, fan_in: tuple(shape))
    _check_same(want, _map(tree, lambda t: tuple(t.shape)), "params")
    return tree


def _stack_blocks(cfg: ModelConfig | None, layers: list, stack) -> dict:
    """One tree a layer -> ``{"cycle": [stacked tree a kind], "tail": [tree a
    kind]}``, the inverse of :func:`_unstack_blocks`.  Without ``cfg`` every
    layer is one cycle position (the dense decoders' cycle is one kind)."""
    if cfg is None:
        cycle, n, tail = ["block"], len(layers), []
    else:
        cycle, n, tail = block_cycle(cfg)
    if len(layers) != n * len(cycle) + len(tail):
        raise ValueError(f"{len(layers)} layers do not match the block cycle "
                         f"({n} x {len(cycle)} + {len(tail)})")
    stacked = [_zip(layers[j::len(cycle)][:n], stack) for j in range(len(cycle))]
    return {"cycle": stacked, "tail": list(layers[n * len(cycle):])}


def _zip(trees: list, fn):
    """Trees of one structure -> one tree whose leaves are ``fn`` of the
    list of the trees' leaves at the same place."""
    first = trees[0]
    if isinstance(first, dict):
        if any(not isinstance(t, dict) or set(t) != set(first) for t in trees):
            raise ValueError("layers differ in structure: they cannot be stacked")
        return {k: _zip([t[k] for t in trees], fn) for k in first}
    if isinstance(first, (list, tuple)):
        return [_zip([t[i] for t in trees], fn) for i in range(len(first))]
    return fn(trees)


def reference_layout(tree: dict, cfg: ModelConfig | None = None, stack=torch.stack) -> dict:
    """The port's parameter-shaped tree (parameters, gradients, moments) in
    the reference's layout: ``blocks`` (and an encoder's, one cycle
    position) stacked over depth by ``stack``, the other entries as they are
    (the same objects)."""
    out = {k: v for k, v in tree.items() if k not in ("blocks", "encoder")}
    out["blocks"] = _stack_blocks(cfg, tree["blocks"], stack)
    if "encoder" in tree:
        out["encoder"] = dict(tree["encoder"],
                              blocks=_stack_blocks(None, tree["encoder"]["blocks"], stack))
    return out


def port_layout(tree: dict, cfg: ModelConfig | None = None) -> dict:
    """The inverse of :func:`reference_layout`: the stacked blocks split into
    one tree a layer (views of the stacked tensors or arrays)."""
    blocks = tree["blocks"]
    if cfg is None:
        cycle, n = ["block"], next(_leaves(blocks["cycle"][0])).shape[0]
    else:
        cycle, n, _ = block_cycle(cfg)
    layers = [_map(blocks["cycle"][j], lambda a, i=i: a[i])
              for i in range(n) for j in range(len(cycle))]
    out = {k: v for k, v in tree.items() if k not in ("blocks", "encoder")}
    out["blocks"] = layers + list(blocks["tail"])
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = dict(enc, blocks=port_layout({"blocks": enc["blocks"]})["blocks"])
    return out


def _leaves(tree, is_leaf=None):
    """Leaves in the reference's order (``jax.tree.leaves``: dict keys
    sorted, lists in order); ``is_leaf(x)`` stops the walk at ``x``."""
    if is_leaf is not None and is_leaf(tree):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], is_leaf)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, is_leaf)
    else:
        yield tree


def to_reference_params(tree: dict, cfg: ModelConfig) -> dict:
    """The port's parameter-shaped tree -> the reference's (``build_params``
    names, blocks stacked over depth) as numpy arrays on the host, bf16
    widened to float32 (numpy has none).  The inverse of
    :func:`from_reference_params`."""
    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return reference_layout(_map(tree, host), cfg, stack=np.stack)


def from_reference_cache(np_cache: dict, cfg: ModelConfig, device, dtype=None) -> dict:
    """Reference decode cache (``blocks.cycle[0].{k,v} (L,B,T,Hkv,D)``, or
    MLA's ``blocks.cycle[0].ckv (L,B,T,kv_lora_rank)`` and ``.kr
    (L,B,T,qk_rope_head_dim)``, or the RG-LRU's ``.h (L,B,W)`` and ``.conv
    (L,B,K-1,W)``, or the mLSTM's ``.conv``, ``.C (L,B,H,D,D)``, ``.n``,
    ``.m`` and the sLSTM's ``.c``, ``.n``, ``.h``, ``.m (L,B,W)``, or
    Whisper's ``.{k,v} (L,B,T,Hkv,D)`` and ``.{ck,cv} (L,B,encoder_seq,Hkv,D)``;
    ``pos (B,)``) as numpy arrays -> the port's cache on ``device``, every
    leaf in ``dtype`` but the xLSTM's states, which stay float32 as the
    reference keeps them, each layer's leaves in the port's order (``k, v,
    ck, cv``).  A cache of another config (names or shapes) raises."""
    dt = dtype or torch_dtype(cfg.dtype)
    device = torch.device(device)
    blocks = []
    for kind, layer in zip(layer_kinds(cfg), _unstack_blocks(cfg, np_cache["blocks"],
                                                             lambda a, keys: a)):
        # a leaf the port keeps in float32 (the xLSTM states) stays float32
        own = _kind_cache(cfg, kind, lambda shape, logical, d: d, 1, 1)
        names = list(own) if set(own) == set(layer) else list(layer)    # else raises below
        blocks.append({name: _leaf(layer[name], device,
                                   torch.float32 if own.get(name) == torch.float32 else dt)
                       for name in names})
    cache = {"blocks": blocks, "pos": _leaf(np_cache["pos"], device, torch.int32)}
    # hold the result to the port's own build_cache at the cache's batch and its
    # attention rings' rows (a windowed ring's min(cache_len, window) rows are what a
    # cache of that many rows builds too; a stack with no ring has no T)
    B, T = cache["pos"].shape[0], cache_len_of(cache) or 0
    want = build_cache(cfg, lambda shape, logical, d: tuple(shape), B, T)
    _check_same(want, _map(cache, lambda t: tuple(t.shape)), "cache")
    return cache


def _check_same(want, got, what: str, path: str = "") -> None:
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(want) != set(got):
            raise ValueError(f"{what}{path}: keys differ: "
                             f"{sorted(want)} vs {sorted(got) if isinstance(got, dict) else got}")
        for k in want:
            _check_same(want[k], got[k], what, f"{path}.{k}")
    elif isinstance(want, list):
        if not isinstance(got, list) or len(want) != len(got):
            raise ValueError(f"{what}{path}: lengths differ")
        for i, (w, g) in enumerate(zip(want, got)):
            _check_same(w, g, what, f"{path}[{i}]")
    elif want != got:
        raise ValueError(f"{what}{path}: shape {got}, expected {want}")
