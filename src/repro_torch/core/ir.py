"""Operator-graph IR for the Charon simulator.

A ``Graph`` is a DAG of ``OpNode``s at PyTorch-profiler granularity (matmul,
attention, norm, elementwise fusion, collective, ...).  Parallelism and
optimization passes rewrite graphs; backend engines price individual nodes;
the scheduler turns a priced graph into a per-rank timeline.

Charon's single-block trick (paper §3.2a): a node may carry ``repeat=n`` —
the scheduler expands it n times; tracing cost stays O(1) in depth.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

COMPUTE_KINDS = {
    "matmul", "attention", "conv", "elementwise", "norm", "reduce", "softmax",
    "embed", "gather", "scatter", "sort", "transpose", "copy", "scan_cell",
    "fused", "optimizer", "quant",
}
COMM_KINDS = {"all_reduce", "all_gather", "reduce_scatter", "all_to_all",
              "send", "recv", "collective_permute"}


@dataclass
class OpNode:
    name: str
    kind: str
    deps: list[str] = field(default_factory=list)
    out_shape: tuple = ()
    dtype: str = "bf16"
    flops: float = 0.0
    bytes_in: float = 0.0
    bytes_out: float = 0.0
    # communication
    comm_bytes: float = 0.0          # payload per participating device
    comm_group: str = ""             # mesh axis: 'tp' | 'dp' | 'ep' | 'pp' | 'pod'
    comm_size: int = 1               # participants
    overlappable: bool = False       # may run on a comm stream alongside compute
    stream: str = "compute"
    repeat: int = 1                  # single-block extrapolation multiplier
    phase: str = "fwd"               # fwd | bwd | opt | comm
    attrs: dict[str, Any] = field(default_factory=dict)

    @property
    def is_comm(self) -> bool:
        return self.kind in COMM_KINDS

    @property
    def total_bytes(self) -> float:
        return self.bytes_in + self.bytes_out

    def clone(self, **kw) -> "OpNode":
        # hot path (pass pipelines clone every node of every graph): a direct
        # __dict__ copy is ~6x faster than dataclasses.replace
        n = object.__new__(OpNode)
        n.__dict__.update(self.__dict__)
        n.deps = list(self.deps)
        n.attrs = dict(self.attrs)
        for k, v in kw.items():
            setattr(n, k, v)
        return n


class Graph:
    """Ordered operator DAG (insertion order is a valid topological order)."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self.nodes: dict[str, OpNode] = {}
        self._ctr = 0
        self._topo: list[OpNode] | None = None   # cached toposort order

    # ---- construction ----
    def add(self, node: OpNode) -> OpNode:
        if node.name in self.nodes:
            self._ctr += 1
            node.name = f"{node.name}.{self._ctr}"
        self.nodes[node.name] = node
        self._topo = None
        return node

    def op(self, kind: str, name: str | None = None, deps: Iterable[str] = (),
           **kw) -> OpNode:
        self._ctr += 1
        return self.add(OpNode(name or f"{kind}.{self._ctr}", kind,
                               deps=list(deps), **kw))

    def remove(self, name: str):
        self._topo = None
        node = self.nodes.pop(name)
        for other in self.nodes.values():
            other.deps = [node.deps[0] if d == name and node.deps else d
                          for d in other.deps if d != name or node.deps]

    # ---- queries ----
    def __iter__(self):
        return iter(self.nodes.values())

    def __len__(self):
        return len(self.nodes)

    def toposort(self) -> list[OpNode]:
        if self._topo is not None:
            return self._topo
        order: list[OpNode] = []
        seen: set[str] = set()
        state: dict[str, int] = {}

        def visit(name: str):
            stack = [(name, iter(self.nodes[name].deps))]
            state[name] = 1
            while stack:
                cur, it = stack[-1]
                advanced = False
                for d in it:
                    if d not in self.nodes or d in seen:
                        continue
                    if state.get(d) == 1:
                        continue  # ignore back-edges defensively
                    state[d] = 1
                    stack.append((d, iter(self.nodes[d].deps)))
                    advanced = True
                    break
                if not advanced:
                    stack.pop()
                    seen.add(cur)
                    order.append(self.nodes[cur])

        for n in self.nodes:
            if n not in seen:
                visit(n)
        self._topo = order
        return order

    def successors(self) -> dict[str, list[str]]:
        succ: dict[str, list[str]] = {n: [] for n in self.nodes}
        for node in self.nodes.values():
            for d in node.deps:
                if d in succ:
                    succ[d].append(node.name)
        return succ

    # ---- aggregate metrics ----
    def total(self, attr: str, *, phase: str | None = None,
              pred: Callable[[OpNode], bool] | None = None) -> float:
        tot = 0.0
        for n in self.nodes.values():
            if phase is not None and n.phase != phase:
                continue
            if pred is not None and not pred(n):
                continue
            tot += getattr(n, attr) * n.repeat
        return tot

    def by_kind(self, attr: str = "flops") -> dict[str, float]:
        out: dict[str, float] = {}
        for n in self.nodes.values():
            out[n.kind] = out.get(n.kind, 0.0) + getattr(n, attr) * n.repeat
        return out

    def clone(self) -> "Graph":
        g = Graph(self.name)
        g._ctr = self._ctr
        for n in self.nodes.values():
            g.nodes[n.name] = n.clone()
        return g

    def __repr__(self):
        return f"Graph({self.name}, {len(self.nodes)} ops)"
