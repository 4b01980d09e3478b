"""Analysis passes (paper §3.2c): dependency-independent metrics computed by
graph traversal, composable with optimization passes in one flow.

The paper stresses ordering: FLOPs analysis runs BEFORE the recompute pass
(model-level compute cost), memory liveness AFTER (real allocation timing).
``AnalysisPipeline`` enforces that.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.ir import Graph
from repro_torch.core.memory import graph_liveness_peak


@dataclass
class GraphMetrics:
    flops: float = 0.0
    bytes: float = 0.0
    comm_bytes: float = 0.0
    arithmetic_intensity: float = 0.0
    by_kind_flops: dict = field(default_factory=dict)
    by_phase_flops: dict = field(default_factory=dict)
    activation_peak: float = 0.0
    n_ops: int = 0


class FlopsAnalysis:
    """Dependency-independent: totals + per-kind/per-phase aggregation."""

    name = "flops_analysis"

    def run(self, g: Graph) -> GraphMetrics:
        m = GraphMetrics()
        for n in g:
            m.flops += n.flops * n.repeat
            m.bytes += n.total_bytes * n.repeat
            m.comm_bytes += n.comm_bytes * n.repeat
            m.by_kind_flops[n.kind] = m.by_kind_flops.get(n.kind, 0.0) + n.flops * n.repeat
            m.by_phase_flops[n.phase] = m.by_phase_flops.get(n.phase, 0.0) + n.flops * n.repeat
            m.n_ops += 1
        m.arithmetic_intensity = m.flops / max(m.bytes, 1.0)
        return m


class MemoryAnalysis:
    """Dependency-aware: liveness peak over the (possibly remat-rewritten)
    graph — must run AFTER RecomputePass."""

    name = "memory_analysis"

    def run(self, g: Graph) -> float:
        peak, _ = graph_liveness_peak(g)
        return peak


def mfu(model_flops: float, wall_us: float, chips: int, peak_flops: float) -> float:
    """Model-FLOPs utilisation (paper's headline summary metric)."""
    if wall_us <= 0:
        return 0.0
    return model_flops / (chips * peak_flops * wall_us / 1e6)


@dataclass
class AnalysisPipeline:
    """Interleave analyses with optimization passes at the right stages
    (paper: 'natively supports interleaving them within the same flow')."""

    pre_passes: list = field(default_factory=list)    # e.g. TP/SP/EP
    post_passes: list = field(default_factory=list)   # e.g. Recompute

    def run(self, g: Graph, ctx) -> dict:
        for p in self.pre_passes:
            g = p.apply(g, ctx)
        pre = FlopsAnalysis().run(g)          # model-level flops: pre-recompute
        for p in self.post_passes:
            g = p.apply(g, ctx)
        post = FlopsAnalysis().run(g)
        return {
            "model_flops": pre.flops,
            "executed_flops": post.flops,     # includes recompute
            "recompute_overhead": post.flops / max(pre.flops, 1.0) - 1.0,
            "activation_peak": MemoryAnalysis().run(g),
            "pre": pre, "post": post, "graph": g,
        }
