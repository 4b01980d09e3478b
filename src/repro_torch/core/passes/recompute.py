"""Activation recomputation pass (paper §3.2c / §5 what-if analyses).

Under 'block' remat the backward pass re-executes the block forward; the
pass clones forward compute nodes into the backward phase.  The memory
analyzer (core/memory.py) correspondingly keeps only block-boundary
activations alive.  FLOPs analyses run before this pass (the paper notes
FLOPs must be measured pre-recompute)."""
from __future__ import annotations

from repro_torch.core.ir import Graph


class RecomputePass:
    name = "recompute"

    def __init__(self, policy: str = "block"):
        self.policy = policy  # none | block | dots

    def cache_key(self) -> tuple:
        return (self.name, self.policy)

    def apply(self, g: Graph, ctx=None) -> Graph:
        if self.policy == "none":
            return g
        for node in list(g.toposort()):
            if node.phase != "fwd" or node.is_comm:
                continue
            if self.policy == "dots" and node.kind in ("matmul", "attention", "conv"):
                continue  # dots saved, everything else recomputed
            rc = node.clone()
            rc.name = f"{node.name}.rc"
            rc.phase = "bwd"
            rc.attrs = dict(rc.attrs, recompute=True)
            g.add(rc)
        return g
