"""Optimizers written out over the parameter tree (counterpart of
``repro/training/optimizer.py``; ``torch.optim`` is not used).

* ``adamw``      — AdamW with fp32 first/second moments (16 B/param states).
* ``adafactor``  — factored second moments (sub-byte/param states).

Both support int8 gradient "compression" (quantise-dequantise transform that
models the numerics of compressed DP all-reduce; the simulator prices the
bytes reduction, see core/passes/data_parallel.py).

The arithmetic is the reference's, in fp32 and in the same order, so a step
gives the reference's numbers for the same tree.  Two things differ in form:

* ``update(grads, state, params)`` writes the new parameters into
  ``params`` and AdamW's new moments into ``state`` **in place** and returns
  them (the reference returns new arrays).  phi4-mini's AdamW state is about
  46 GB on an 80 GB card, so a second copy of it cannot be made.  On the
  card AdamW's update of a leaf is one kernel launch
  (``kernels.adamw_update``), the fused pass XLA makes of the reference's.
* Where the reference's result depends on its layout, the port computes on
  that layout: the reference stacks each block parameter over depth
  (``convert.reference_layout``), so int8 compression takes one scale per
  stacked leaf, and Adafactor factors and clips each stacked leaf (a norm
  weight of L layers is an (L, D) matrix there).  The stacking is the
  config's block cycle (``models.block_cycle``): recurrentgemma's layers
  are stacked by (rec, rec, attn) position plus a tail, xlstm's by (m, m,
  m, s) position, so Adafactor and int8 compression take the model's
  ``cfg`` (without one every layer is one cycle position, the dense
  decoders' stacking).  Adafactor's state is kept in the reference's
  layout, a flat list aligned with the reference's leaves, updated in
  place.  On the card a group's update is one call of
  ``kernels.adafactor_update``, whose kernels read the layers where they
  lie; its plain version (the CPU's) stacks them and makes temporary fp32
  copies of one stacked leaf at a time.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import _leaves, reference_layout
from repro_torch.kernels.adafactor import adafactor_update, adafactor_update_plain
from repro_torch.kernels.adafactor import factored as _factored
from repro_torch.kernels.adamw import adamw_update, adamw_update_plain


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]  # (grads, state, params) -> (new_params, new_state)


def tree_leaves(tree) -> list:
    """Leaves in the reference's order (dict keys sorted, lists in order)."""
    return list(_leaves(tree))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of trees of the same structure
    in ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _is_stacked(group) -> bool:
    return getattr(group, "stacked", False)


class _Group(list):
    """A block parameter's group: stacked even when it has one layer."""
    stacked = True


def _groups(tree, cfg: ModelConfig | None = None) -> list:
    """The tree's leaves grouped as the reference holds them, in its leaf
    order: a block parameter's group (a ``_Group``) holds its tensor of every
    layer of one position of ``cfg``'s block cycle (or of the tail), in layer
    order; any other leaf is a group of one."""
    def one(x):
        return x if isinstance(x, _Group) else [x]
    if not (isinstance(tree, dict) and isinstance(tree.get("blocks"), list)):
        return [[t] for t in tree_leaves(tree)]
    ref = reference_layout(tree, cfg, stack=_Group)
    return [one(x) for x in _leaves(ref, is_leaf=lambda x: isinstance(x, _Group))]


# --------------------------------------------------------------------------
# LR schedules
# --------------------------------------------------------------------------

def cosine_schedule(peak_lr: float, warmup: int = 100, total: int = 10_000,
                    final_frac: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, peak_lr * cos)
    return lr


# --------------------------------------------------------------------------
# Gradient compression (int8 quant-dequant; models compressed DP all-reduce)
# --------------------------------------------------------------------------

def _int8_group(group: list[torch.Tensor]) -> list[torch.Tensor]:
    """int8 quant-dequant of a group that the reference holds as one array:
    one scale from the group's absolute maximum."""
    g0 = group[0]
    if g0.dtype == torch.int32 or (not _is_stacked(group) and g0.ndim == 0):
        return group
    # |g| and its maximum are exact in g's dtype, so only the maximum is widened
    absmax = torch.stack([g.abs().amax().float() for g in group]).max()
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    return [(torch.clamp(torch.round(g.float() / scale), -127, 127).to(torch.int8).float()
             * scale).to(g.dtype) for g in group]


def int8_compress_decompress(g: torch.Tensor) -> torch.Tensor:
    return _int8_group([g])[0]


def maybe_compress(grads, mode: str, cfg: ModelConfig | None = None):
    """``grads`` with int8 quant-dequant applied per reference leaf (mode
    "int8"; ``cfg`` the model's config, for its block cycle), else ``grads``
    itself."""
    if mode != "int8":
        return grads
    out = {}
    for group in _groups(grads, cfg):
        for g, q in zip(group, _int8_group(group)):
            out[id(g)] = q
    return tree_map(lambda g: out[id(g)], grads)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def adamw(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, *, plain_kernels: bool = False) -> Optimizer:
    """``plain_kernels`` updates through the plain version on the card too
    (the on-card check of the kernel against it)."""
    leaf_update = adamw_update_plain if plain_kernels else adamw_update

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        first = tree_leaves(params)[0]
        return {"m": tree_map(zeros, params),
                "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=first.device)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr = lr_fn(step)
        c1 = 1.0 - torch.pow(_scalar(b1, step), step.to(torch.float32))
        c2 = 1.0 - torch.pow(_scalar(b2, step), step.to(torch.float32))

        def upd(g, m, v, p):
            # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
            # u = (m / c1) / (sqrt(v / c2) + eps) + wd p;  p <- p - lr u
            # (one fused launch a leaf on the card, the same arithmetic in
            # plain torch on the CPU: kernels/adamw.py)
            leaf_update(p, g.contiguous(), m, v, lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps,
                        weight_decay=weight_decay)
            return p

        new_p = tree_map(upd, grads, state["m"], state["v"], params)
        return new_p, {"m": state["m"], "v": state["v"], "step": step}

    return Optimizer(init, update)


# --------------------------------------------------------------------------
# Adafactor (factored second moment, update clipping)
# --------------------------------------------------------------------------

def adafactor(lr_fn, eps1: float = 1e-30, eps2: float = 1e-3,
              clip_threshold: float = 1.0, weight_decay: float = 0.0,
              cfg: ModelConfig | None = None, *, plain_kernels: bool = False) -> Optimizer:
    """Factored state is kept as a flat list aligned with the reference's
    leaves (its stacked layout, by ``cfg``'s block cycle).  ``plain_kernels``
    updates through the plain version on the card too (the on-card check of
    the kernels against it)."""
    group_update = adafactor_update_plain if plain_kernels else adafactor_update

    def init(params):
        def st(group):
            shape = _stack_shape(group)
            dev = group[0].device
            if _factored(shape):
                return {"vr": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                        "vc": torch.zeros((*shape[:-2], shape[-1]), dtype=torch.float32,
                                          device=dev)}
            return {"v": torch.zeros(shape, dtype=torch.float32, device=dev)}
        first = tree_leaves(params)[0]
        return {"f": [st(g) for g in _groups(params, cfg)],
                "step": torch.zeros((), dtype=torch.int32, device=first.device)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        lr = lr_fn(step)
        beta2 = 1.0 - step.to(torch.float32) ** -0.8
        # a group's update (one array of the reference: a block parameter's
        # layers of one cycle position, or one tensor) writes its parameters
        # and its state in place: the kernels on the card, the reference's
        # arithmetic in plain torch on the CPU (kernels/adafactor.py)
        for gg, s, pg in zip(_groups(grads, cfg), state["f"], _groups(params, cfg)):
            group_update([g.contiguous() for g in gg], pg, s, lr=lr, beta2=beta2, eps1=eps1,
                         eps2=eps2, clip_threshold=clip_threshold, weight_decay=weight_decay)
        return params, {"f": state["f"], "step": step}

    return Optimizer(init, update)


def _stack_shape(group) -> tuple:
    shape = tuple(group[0].shape)
    return shape if len(group) == 1 and not _is_stacked(group) else (len(group), *shape)


def make_optimizer(name: str, peak_lr: float = 3e-4, cfg: ModelConfig | None = None,
                   **kw) -> Optimizer:
    """``cfg``: the model's config, whose block cycle Adafactor stacks by
    (AdamW works leaf by leaf and needs none)."""
    lr_fn = cosine_schedule(peak_lr)
    if name == "adamw":
        return adamw(lr_fn, **kw)
    if name == "adafactor":
        return adafactor(lr_fn, cfg=cfg, **kw)
    raise ValueError(name)


__all__ = ["Optimizer", "adafactor", "adamw", "cosine_schedule", "int8_compress_decompress",
           "make_optimizer", "maybe_compress", "tree_leaves", "tree_map"]
