"""Carries weights and decode state from the JAX reference into the port.

The reference stacks block parameters and caches over depth (leading layer
dim, for ``lax.scan``); the port keeps one dict a layer.  These functions
take the reference's trees **as numpy arrays** (this package never imports
jax; bf16 has no numpy dtype, so callers hand float32 over and name the torch
dtype they want) and return the port's trees on a device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.models.params import block_cycle, build_params


def _leaf(a, device, dtype) -> torch.Tensor:
    # a copy: the port updates caches in place and must not write into the caller's array
    return torch.tensor(np.asarray(a)).to(device=device, dtype=dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _unstack_blocks(cfg: ModelConfig, blocks, convert):
    """``{"cycle": [stacked tree a kind], "tail": [tree a kind]}`` -> one tree
    a layer, in layer order."""
    cycle, n, tail = block_cycle(cfg)
    if len(blocks["cycle"]) != len(cycle) or len(blocks["tail"]) != len(tail):
        raise ValueError("reference tree does not match the config's block cycle")
    layers = []
    for i in range(n):
        for j in range(len(cycle)):
            layers.append(_map(blocks["cycle"][j], lambda a, i=i: convert(np.asarray(a)[i])))
    for j in range(len(tail)):
        layers.append(_map(blocks["tail"][j], lambda a: convert(np.asarray(a))))
    return layers


def from_reference_params(np_tree: dict, cfg: ModelConfig, device, dtype=None) -> dict:
    """Reference parameter tree (``repro.models.params.build_params`` names:
    ``embed.w (V,D)``, ``blocks.cycle[0].{ln1,ln2}.w (L,D)``, ``attn.{q,k,v,o}``,
    ``mlp.{gate,up,down}``, ``final_norm.w``, optional ``lm_head.w``) as numpy
    arrays -> the port's tree on ``device``."""
    dt = dtype or torch_dtype(cfg.param_dtype)
    device = torch.device(device)

    def convert(a):
        return _leaf(a, device, dt)

    tree = {
        "embed": _map(np_tree["embed"], convert),
        "final_norm": _map(np_tree["final_norm"], convert),
        "blocks": _unstack_blocks(cfg, np_tree["blocks"], convert),
    }
    if "lm_head" in np_tree:
        tree["lm_head"] = _map(np_tree["lm_head"], convert)

    # hold the result to the port's own build_params: same names, same shapes
    want = build_params(cfg, lambda path, shape, fan_in: tuple(shape))
    _check_same(want, _map(tree, lambda t: tuple(t.shape)), "params")
    return tree


def from_reference_cache(np_cache: dict, cfg: ModelConfig, device, dtype=None) -> dict:
    """Reference decode cache (``blocks.cycle[0].{k,v} (L,B,T,Hkv,D)``,
    ``pos (B,)``) as numpy arrays -> the port's cache on ``device``."""
    dt = dtype or torch_dtype(cfg.dtype)
    device = torch.device(device)
    return {
        "blocks": _unstack_blocks(cfg, np_cache["blocks"], lambda a: _leaf(a, device, dt)),
        "pos": _leaf(np_cache["pos"], device, torch.int32),
    }


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
