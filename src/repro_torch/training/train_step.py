"""Training step: loss, grad accumulation, optimizer (counterpart of
``repro/training/train_step.py``).

``make_train_step`` returns the step; on the card its forward runs K1 and K3
and its backward their backward kernels (``kernels/ops.py``).  The
reference's sharding half of the module (``param_pspecs``, ``opt_pspecs``,
``batch_pspecs``, ``state_pspecs``, ``to_named``, which resolve partition
specs over a JAX mesh) is not ported yet: it comes with the sharding rule
table (ROADMAP queue A item 6).  On one device there is nothing to shard.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import Model
from repro_torch.training.optimizer import Optimizer, maybe_compress, tree_leaves, tree_map

Pytree = Any


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token CE over labels >= 0.  logits f32 (B,S,V); labels (B,S).
    The labels' negative log-likelihood is ``nll_loss`` of the log-softmax:
    the reference's gathered log-probabilities negated, bit for bit."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = F.nll_loss(logp.flatten(0, -2), labels.clamp_min(0).long().flatten(),
                     reduction="none").view(labels.shape)
    mask = (labels >= 0).to(torch.float32)
    tok = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / tok, tok


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch)
        labels = torch.as_tensor(batch["labels"]).to(logits.device)
        ce, tok = cross_entropy(logits, labels)
        return ce + aux, {"loss": ce + aux, "ce": ce, "aux_loss": aux, "tokens": tok}
    return loss_fn


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
        grads = maybe_compress(tree_map(lambda p: by_leaf[id(p)], params), run.grad_compression)
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


__all__ = ["cross_entropy", "init_state", "make_loss_fn", "make_train_step"]
