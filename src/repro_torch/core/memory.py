"""Liveness-based peak-memory simulation (paper §3.2c memory analysis).

Graph-level liveness: an activation is allocated at its producer and freed
after its last consumer *in the joint fwd+bwd order* — peak memory is reached
during backward, which layer-level (static-tensor) estimators cannot see.
Static components (weights, grads, optimizer states per ZeRO stage, KV cache)
are added analytically, plus calibrated collective-buffer overhead and a
fragmentation factor (paper §4.3 calibrations).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.ir import Graph

COLLECTIVE_BUFFER_BYTES = 256 * 1024 * 1024 * 0.12   # calibrated NCCL/ICI staging
FRAGMENTATION = 1.03                                  # calibrated allocator slack


@dataclass
class MemoryReport:
    weights: float = 0.0
    grads: float = 0.0
    opt_state: float = 0.0
    activations_peak: float = 0.0
    saved_activations: float = 0.0
    kv_cache: float = 0.0
    collective_buffers: float = 0.0
    total: float = 0.0
    # (op_idx, live_bytes) liveness curve.  Immutable on purpose: the walk
    # is cached (SimCache "memory" bucket) and shared across reports, so a
    # mutable list here would let one consumer poison every sibling report.
    timeline: tuple[tuple[float, float], ...] = ()

    def summary(self) -> dict:
        return {k: getattr(self, k) for k in
                ("weights", "grads", "opt_state", "activations_peak",
                 "saved_activations", "kv_cache", "collective_buffers", "total")}


def graph_liveness_peak(g: Graph, *, record_timeline: bool = False):
    """Peak live activation bytes over a single execution of ``g`` (repeat
    multipliers do not stack activations — a scanned block reuses buffers)."""
    order = g.toposort()
    last_use: dict[str, int] = {}
    for i, node in enumerate(order):
        for d in node.deps:
            last_use[d] = i
        last_use.setdefault(node.name, i)
    live = 0.0
    peak = 0.0
    timeline = []
    frees: dict[int, list[float]] = {}
    for i, node in enumerate(order):
        live += node.bytes_out
        frees.setdefault(last_use[node.name], []).append(node.bytes_out)
        peak = max(peak, live)
        if record_timeline:
            timeline.append((float(i), live))
        for b in frees.pop(i, ()):  # free tensors whose last use is this op
            live -= b
    return peak, timeline


def block_liveness(block_fwd: Graph, block_joint: Graph | None,
                   mode: str) -> tuple[float, list, float]:
    """The graph-walk stage of :func:`simulate_memory`: (peak live bytes,
    liveness timeline, interior fwd activation bytes).

    This is the only part of the memory report that touches the block graph
    — everything else is closed-form arithmetic — so it is what the
    simulator memoizes (SimCache ``memory`` bucket) across sweep candidates
    that share a transformed first block.  The timeline is returned as a
    tuple so the shared cached value is immutable by construction (a
    consumer mutating its report cannot poison the cache bucket).
    """
    g = block_joint if (mode == "train" and block_joint is not None) \
        else block_fwd
    peak, timeline = graph_liveness_peak(g, record_timeline=True)
    interior = block_fwd.total("bytes_out", phase="fwd")
    return peak, tuple(timeline), interior


def simulate_memory(block_fwd: Graph, *, n_layers: int, param_bytes: float,
                    boundary_bytes: float, mode: str = "train",
                    optimizer: str = "adamw", zero_stage: int = 0,
                    dp: int = 1, tp: int = 1, remat: str = "block",
                    kv_cache_bytes: float = 0.0,
                    block_joint: Graph | None = None,
                    liveness: tuple[float, list, float] | None = None
                    ) -> MemoryReport:
    """Per-device peak memory for an n_layers stack of ``block_fwd``.

    ``param_bytes``: per-device parameter bytes (post TP/EP/FSDP sharding).
    ``boundary_bytes``: per-layer residual-stream activation saved for bwd.
    ``liveness``: a precomputed (possibly cached) :func:`block_liveness`
    result; when None the graphs are walked here.
    """
    if liveness is None:
        liveness = block_liveness(block_fwd, block_joint, mode)
    peak_block, tl, interior = liveness
    r = MemoryReport()
    r.weights = param_bytes
    if mode == "train":
        r.grads = param_bytes * (2 / 2)  # grads at param dtype
        if zero_stage >= 2:
            r.grads /= max(dp, 1)
        n_params = param_bytes / 2
        if optimizer == "adamw":
            opt = n_params * 8  # fp32 m + v
        else:
            opt = n_params * 0.1  # adafactor factored moments
        if zero_stage >= 1:
            opt /= max(dp, 1)
        r.opt_state = opt
        # live activations inside one block's fwd+bwd (peak during backward)
        r.timeline = tuple(tl)
        if remat == "none":
            # every layer's interior activations are saved
            r.saved_activations = interior * n_layers
        else:
            r.saved_activations = boundary_bytes * n_layers
        r.activations_peak = peak_block
    else:
        r.timeline = tuple(tl)
        r.activations_peak = peak_block
        r.kv_cache = kv_cache_bytes
    r.collective_buffers = COLLECTIVE_BUFFER_BYTES
    r.total = (r.weights + r.grads + r.opt_state + r.activations_peak +
               r.saved_activations + r.kv_cache + r.collective_buffers) * FRAGMENTATION
    return r
