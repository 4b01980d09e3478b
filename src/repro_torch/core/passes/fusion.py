"""Match-and-replace operator rewriting (paper §3.2b operator fusion).

A ``FusionRule`` matches a linear chain of node kinds (connected through
single-consumer edges) and replaces it with one fused node whose cost model
is derived from the chain (sum of flops; boundary bytes only — the fusion
eliminates intermediate materialisation).  New rules are plain data.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core.ir import Graph, OpNode


@dataclass
class FusionRule:
    name: str
    pattern: tuple[str, ...]             # chain of node kinds
    fused_kind: str = "fused"
    extra_pred: Callable[[list[OpNode]], bool] | None = None


DEFAULT_RULES = [
    FusionRule("norm+matmul", ("norm", "matmul")),
    FusionRule("matmul+elementwise", ("matmul", "elementwise")),
    FusionRule("elementwise+matmul", ("elementwise", "matmul")),
    FusionRule("softmax+matmul", ("softmax", "matmul")),
]


class FusionPass:
    name = "fusion"

    def __init__(self, rules: list[FusionRule] | None = None):
        self.rules = rules if rules is not None else list(DEFAULT_RULES)
        self.applied: list[str] = []

    def cache_key(self) -> tuple:
        return (self.name,) + tuple(r.name for r in self.rules)

    def apply(self, g: Graph, ctx=None) -> Graph:
        for rule in self.rules:
            g = self._apply_rule(g, rule)
        return g

    def _apply_rule(self, g: Graph, rule: FusionRule) -> Graph:
        succ = g.successors()
        consumed: set[str] = set()
        out = Graph(g.name)
        rename: dict[str, str] = {}
        order = g.toposort()
        by_name = {n.name: n for n in order}

        def chain_from(start: OpNode):
            chain = [start]
            cur = start
            for want in rule.pattern[1:]:
                nxt = succ.get(cur.name, [])
                if len(nxt) != 1:
                    return None
                nn = by_name[nxt[0]]
                if nn.kind != want or nn.repeat != start.repeat or nn.phase != start.phase:
                    return None
                chain.append(nn)
                cur = nn
            if rule.extra_pred and not rule.extra_pred(chain):
                return None
            return chain

        for node in order:
            if node.name in consumed:
                continue
            if node.kind == rule.pattern[0]:
                chain = chain_from(node)
                if chain:
                    fused = OpNode(
                        name=f"{rule.name}.{node.name}",
                        kind=rule.fused_kind,
                        deps=[rename.get(d, d) for d in chain[0].deps],
                        out_shape=chain[-1].out_shape,
                        dtype=chain[-1].dtype,
                        flops=sum(c.flops for c in chain),
                        bytes_in=chain[0].bytes_in,
                        bytes_out=chain[-1].bytes_out,
                        repeat=node.repeat, phase=node.phase,
                        attrs={"fused_from": [c.kind for c in chain],
                               **{k: v for c in chain for k, v in c.attrs.items()}},
                    )
                    out.add(fused)
                    for c in chain:
                        consumed.add(c.name)
                        rename[c.name] = fused.name
                    self.applied.append(rule.name)
                    continue
            n = node.clone()
            n.deps = [rename.get(d, d) for d in n.deps]
            out.add(n)
        return out
