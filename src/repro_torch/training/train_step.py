"""Training step: loss, grad accumulation, optimizer, ZeRO specs
(counterpart of ``repro/training/train_step.py``).

``make_train_step`` returns the step; on the card its forward runs K1 and K3
and its backward their backward kernels (``kernels/ops.py``).  The spec half
(``param_pspecs``, ``opt_pspecs``, ``batch_pspecs``, ``state_pspecs``)
resolves each leaf's logical axes against a sharding env
(``distributed.sharding``) into a spec ``P``, with the reference's ZeRO
stages; ``to_named`` turns a tree of specs into one of DTensor placements,
which the dry run (``launch/dryrun.py``) places the state on.  The port's
parameter tree has one dict a layer, so a block leaf's spec is the
reference's with its leading ``"layer"`` entry dropped (that axis is never
sharded); Adafactor's factored moments keep the reference's stacked layout,
as the optimizer does.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.convert import _leaves, reference_layout
from repro_torch.distributed.sharding import (
    P, ShardingEnv, fsdp_spec, is_dtensor, placements, redistribute, resolve_spec,
)
from repro_torch.models import Model
from repro_torch.models.params import build_params
from repro_torch.training.optimizer import (
    Optimizer, _factored, maybe_compress, tree_leaves, tree_map,
)

Pytree = Any


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token CE over labels >= 0.  logits f32 (B,S,V); labels (B,S).
    The labels' negative log-likelihood is ``nll_loss`` of the log-softmax:
    the reference's gathered log-probabilities negated, bit for bit."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = _nll_sharded(logp, labels) if is_dtensor(logp) else _nll(logp, labels)
    mask = (labels >= 0).to(torch.float32)
    tok = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / tok, tok


def _nll(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.nll_loss(logp.flatten(0, -2), labels.clamp_min(0).long().flatten(),
                      reduction="none").view(labels.shape)


def _nll_sharded(logp, labels):
    """:func:`_nll` over DTensors (the dry run): per token, so local to each
    rank's rows once the vocabulary is whole there (GSPMD's local CE); the
    labels take the log-probabilities' placements over (B, S)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = logp.device_mesh
    lp_pl = tuple(Replicate() if p.is_shard(2) else p for p in logp.placements)
    lb_pl = tuple(p if p.is_shard() else Replicate() for p in lp_pl)
    labels = labels if is_dtensor(labels) else \
        torch.distributed.tensor.DTensor.from_local(labels, mesh, (Replicate(),) * mesh.ndim)
    return local_map(_nll, out_placements=list(lb_pl), in_placements=(lp_pl, lb_pl),
                     device_mesh=mesh)(redistribute(logp, mesh, lp_pl),
                                       redistribute(labels, mesh, lb_pl))


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch)
        labels = torch.as_tensor(batch["labels"]).to(logits.device)
        ce, tok = cross_entropy(logits, labels)
        return ce + aux, {"loss": ce + aux, "ce": ce, "aux_loss": aux, "tokens": tok}
    return loss_fn


# --------------------------------------------------------------------------
# Sharding specs (params / optimizer state / batch)
# --------------------------------------------------------------------------

class _AxShape:
    """A parameter leaf's logical axes and shape (a leaf of the spec walks,
    where a tuple would be taken for a node)."""
    __slots__ = ("ax", "shape")

    def __init__(self, ax: tuple, shape: tuple):
        self.ax, self.shape = ax, shape


def _ax_shapes(cfg: ModelConfig) -> dict:
    return build_params(cfg, lambda path, shape, logical, fan_in:
                        _AxShape(tuple(logical), tuple(shape)))


def param_pspecs(cfg: ModelConfig, env: ShardingEnv, zero_stage: int) -> Pytree:
    """The parameter tree's specs; ZeRO-3 adds the fsdp axis (FSDP)."""
    def f(leaf):
        if zero_stage >= 3:
            return fsdp_spec(env, leaf.ax, leaf.shape)
        return resolve_spec(env, leaf.ax, leaf.shape)

    return tree_map(f, _ax_shapes(cfg))


def _moment_spec(env, ax, shape, zero_stage):
    """Spec for an fp32 moment with same shape as its param: ZeRO>=1 shards
    optimizer state over the data axis (past a stacked leaf's layer dim)."""
    skip = 1 if ax and ax[0] == "layer" else 0
    if zero_stage >= 1:
        return fsdp_spec(env, ax, shape, skip_leading=skip)
    return resolve_spec(env, ax, shape)


def _stacked(group: list) -> _AxShape:
    return _AxShape(("layer", *group[0].ax), (len(group), *group[0].shape))


def opt_pspecs(cfg: ModelConfig, env: ShardingEnv, run: RunConfig) -> Pytree:
    """AdamW's ``{m, v, step}`` (moments in the parameter tree's form), or
    Adafactor's ``{f, step}``: ``f`` a flat list aligned with the
    reference's leaves (the optimizer's ``_groups``), ``{vr, vc}`` for a
    factored leaf, else ``{v}``."""
    zs = run.zero_stage
    if run.optimizer == "adamw":
        mspec = tree_map(lambda leaf: _moment_spec(env, leaf.ax, leaf.shape, zs), _ax_shapes(cfg))
        return {"m": mspec, "v": mspec, "step": P()}

    f_specs = []
    for leaf in _leaves(reference_layout(_ax_shapes(cfg), cfg, stack=_stacked)):
        ax, shape = leaf.ax, leaf.shape
        if _factored(shape):
            f_specs.append({
                "vr": _moment_spec(env, ax[:-1], shape[:-1], zs),
                "vc": _moment_spec(env, (*ax[:-2], ax[-1]), (*shape[:-2], shape[-1]), zs),
            })
        else:
            f_specs.append({"v": _moment_spec(env, ax, shape, zs)})
    return {"f": f_specs, "step": P()}


def batch_pspecs(cfg: ModelConfig, env: ShardingEnv, global_batch: int,
                 *, kind: str = "train") -> dict:
    """Specs resolved against the *actual* batch size (long_500k has batch=1,
    which must degrade to replicated)."""
    bs = resolve_spec(env, ("batch",), (global_batch,))
    batch_axes = bs[0] if len(bs) else None
    specs = {"tokens": P(batch_axes, None)}
    if kind == "train":
        specs["labels"] = P(batch_axes, None)
    if cfg.rope_style == "mrope":
        specs["positions"] = P(batch_axes, None, None)
    if kind != "decode":   # modality stubs feed prefill/train only
        if cfg.encoder_layers > 0:
            specs["frame_embeds"] = P(batch_axes, None, None)
        if cfg.frontend == "vision_patches":
            specs["patch_embeds"] = P(batch_axes, None, None)
    return specs


def state_pspecs(cfg: ModelConfig, env: ShardingEnv, run: RunConfig) -> dict:
    return {
        "params": param_pspecs(cfg, env, run.zero_stage),
        "opt": opt_pspecs(cfg, env, run),
        "step": P(),
    }


def to_named(env: ShardingEnv, tree: Pytree) -> Pytree:
    """A tree of specs -> the tree of their DTensor placements over the env's
    mesh (the reference's ``NamedSharding``s)."""
    if isinstance(tree, P):
        return placements(env.mesh, tree)
    if isinstance(tree, dict):
        return {k: to_named(env, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_named(env, v) for v in tree]
    return tree


# --------------------------------------------------------------------------
# Train step
# --------------------------------------------------------------------------

def _detached(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


def _micro(batch: dict, k: int, i: int) -> dict:
    """Microbatch ``i`` of ``k``: rows ``i * B/k`` to ``(i + 1) * B/k`` of
    every entry (the reference's reshape to ``(k, B/k, ...)``)."""
    out = {}
    for name, x in batch.items():
        x = torch.as_tensor(x)
        out[name] = x.reshape(k, x.shape[0] // k, *x.shape[1:])[i]
    return out


def make_train_step(cfg: ModelConfig, run: RunConfig, optimizer: Optimizer, device=None, *,
                    plain_kernels: bool = False):
    """``train_step(state, batch) -> (state, metrics)`` with ``state =
    {"params", "opt", "step"}``.  ``device=None`` is the card.  The
    parameters must require grad; the optimizer updates them and its
    moments in place and the returned state holds the same tensors.
    ``plain_kernels`` is the model's switch, for the on-card parity check
    of the kernels against their plain versions.  The step's ``model``
    attribute is the model it runs (``Model.init`` makes its parameters)."""
    model = Model(cfg, device, remat_policy=run.remat_policy, plain_kernels=plain_kernels)
    loss_fn = make_loss_fn(model)
    k = run.microbatches

    def train_step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        if k <= 1:
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
            metrics = _detached(metrics)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            zero = torch.zeros((), dtype=torch.float32, device=model.device)
            metrics = {"loss": zero, "ce": zero, "aux_loss": zero, "tokens": zero}
            for i in range(k):
                loss, m = loss_fn(params, _micro(batch, k, i))
                g = torch.autograd.grad(loss, leaves)
                with torch.no_grad():
                    for a, b in zip(grads, g):
                        a.add_(b.to(torch.float32) / k)
                metrics = {name: metrics[name] + m[name].detach() / k for name in metrics}
                del loss, m, g
        by_leaf = dict(zip(map(id, leaves), grads))
        grads = tree_map(lambda p: by_leaf[id(p)], params)
        del by_leaf     # int8: the raw gradients go as their quantised copies are made
        grads = maybe_compress(grads, run.grad_compression, cfg)
        with torch.no_grad():
            # sqrt of the sum of squares over every element, as the reference
            # (one fp32 reduction a leaf, not a widened copy, a square and a sum)
            grad_norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g, dtype=torch.float32) for g in tree_leaves(grads)]))
        new_params, new_opt = optimizer.update(grads, state["opt"], params)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        metrics = dict(metrics)
        metrics["grad_norm"] = grad_norm
        return new_state, metrics

    train_step.model = model
    return train_step


def init_state(params, optimizer: Optimizer) -> dict:
    """``{"params", "opt", "step"}`` for ``make_train_step``: the parameters
    set to require grad, the optimizer's fresh state, step 0."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
    first = tree_leaves(params)[0]
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


__all__ = ["batch_pspecs", "cross_entropy", "init_state", "make_loss_fn", "make_train_step",
           "opt_pspecs", "param_pspecs", "state_pspecs", "to_named"]
