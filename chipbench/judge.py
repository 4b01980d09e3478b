"""The comparisons that decide ``correct``, and their numbers.

Training: each checked step's loss; each leaf's gradient norm at the first
step, as the optimizer received it; each leaf's change over the checked
steps.  A norm is compared by the gap between the program's and the
reference's norm, over the larger of the reference's norm of that leaf and
of the median leaf, and the worst leaf counts.  Leaves whose reference
gradient is under a thousandth of the median leaf's (a key's bias under
softmax, whose gradient is nought to rounding) take no part.

Serving: the widest gap by which a served token's logit lies below the
reference's best at its position.
"""
from __future__ import annotations

import statistics

ZERO_GRADIENT = 1e-3


def _worst_leaf(prog: dict, ref: dict, keep: list[str]) -> tuple[float, str]:
    med = statistics.median(ref[k] for k in keep)
    worst, at = 0.0, ""
    for k in keep:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med)
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def kept_leaves(ref_grad: dict) -> list[str]:
    med = statistics.median(ref_grad.values())
    return sorted(k for k, g in ref_grad.items() if g >= ZERO_GRADIENT * med)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [...], "grad_norms": {leaf: norm},
    "change_norms": {leaf: norm}}.  Returns the numbers compared and where
    the worst leaves are."""
    if set(prog["grad_norms"]) != set(ref["grad_norms"]):
        raise ValueError("the program's leaves and the reference's differ")
    keep = kept_leaves(ref["grad_norms"])
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_at = _worst_leaf(prog["grad_norms"], ref["grad_norms"], keep)
    change_gap, change_at = _worst_leaf(prog["change_norms"], ref["change_norms"], keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "where": {"grad_gap": grad_at, "change_gap": change_at,
                      "left_out": sorted(set(ref["grad_norms"]) - set(keep))}}


def served_gap(ref_logits, served: list[int]) -> float:
    """Widest (best - served) over the rows of one request's reference
    logits (len(served), V) and its served tokens."""
    import torch
    tok = torch.tensor(served, device=ref_logits.device)[:, None]
    return float((ref_logits.max(dim=1).values - ref_logits.gather(1, tok)[:, 0]).max())


def checks(numbers: dict, limits: dict) -> dict:
    return {name: {"value": float(numbers[name]), "limit": float(limits[name])}
            for name in limits}


def all_within(ch: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in ch.values())
