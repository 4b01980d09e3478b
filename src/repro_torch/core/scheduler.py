"""Dependency-aware operator scheduler (paper §3.2c).

List-schedules a priced graph onto per-rank streams ('compute' plus comm
streams), honoring data dependencies; overlappable comm ops run on their own
stream concurrently with compute.  The result feeds the overlap processor
(core/overlap.py) and the chrome-trace exporter (core/timeline.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.ir import Graph, OpNode


@dataclass
class Interval:
    name: str
    kind: str
    stream: str
    start: float            # us
    end: float
    phase: str = "fwd"
    comm_group: str = ""
    comm_bytes: float = 0.0
    repeat: int = 1
    engine: str = ""

    @property
    def dur(self) -> float:
        return self.end - self.start


@dataclass
class Timeline:
    intervals: list[Interval] = field(default_factory=list)

    @property
    def total_time(self) -> float:
        return max((i.end for i in self.intervals), default=0.0)

    def stream_time(self, stream: str) -> float:
        return sum(i.dur for i in self.intervals if i.stream == stream)

    def by_kind(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for i in self.intervals:
            out[i.kind] = out.get(i.kind, 0.0) + i.dur
        return out

    def by_phase(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for i in self.intervals:
            out[i.phase] = out.get(i.phase, 0.0) + i.dur
        return out


def _prices(order: list[OpNode], engine) -> list[float]:
    """Latency per node, via the engine's vectorized ``price_batch`` when it
    has one (one numpy pass over the cache misses) else per-node calls."""
    batch = getattr(engine, "price_batch", None)
    lats = batch(order) if batch is not None \
        else [engine.latency_us(n) for n in order]
    return [0.0 if t is None else t for t in lats]


def schedule(graph: Graph, engine, *, expand_repeats: bool = False,
             max_expand: int = 4096) -> Timeline:
    """Price every node with ``engine`` and list-schedule.

    ``expand_repeats`` emits one interval per repetition (trace export);
    otherwise a node with repeat=n occupies n * latency sequentially.
    """
    tl = Timeline()
    stream_free: dict[str, float] = {}
    done: dict[str, float] = {}
    eng_name = getattr(engine, "engine_for", None)

    order = graph.toposort()
    lats = _prices(order, engine)
    for node, lat in zip(order, lats):
        stream = node.stream
        dep_ready = max((done.get(d, 0.0) for d in node.deps), default=0.0)
        reps = node.repeat if expand_repeats and node.repeat <= max_expand else 1
        dur_total = lat * (node.repeat if reps == 1 else 1)
        t = max(stream_free.get(stream, 0.0), dep_ready)
        for r in range(reps):
            iv = Interval(
                name=node.name if reps == 1 else f"{node.name}#{r}",
                kind=node.kind, stream=stream, start=t, end=t + dur_total,
                phase=node.phase, comm_group=node.comm_group,
                comm_bytes=node.comm_bytes * (node.repeat if reps == 1 else 1),
                repeat=node.repeat,
                engine=eng_name(node) if eng_name else getattr(engine, "name", ""),
            )
            tl.intervals.append(iv)
            t = iv.end
        stream_free[stream] = t
        done[node.name] = t
    return tl


def schedule_times(graph: Graph, engine, hw=None, *,
                   overlap: str = "ratio") -> tuple[float, dict[str, float]]:
    """Interval-free fast path: ``(total_time, by_kind)`` via running scalars.

    Performs the same list-scheduling arithmetic as :func:`schedule` followed
    by the overlap model (core/overlap.py) when ``hw`` is given, but keeps
    only flat per-op arrays — no per-node ``Interval``/``Timeline``
    allocation.  Accumulation order matches the interval path exactly, so
    ``overlap="ratio"`` is bit-identical to
    ``apply_ratio_overlap(schedule(g, engine), hw)`` and
    ``overlap="bandwidth"`` to ``apply_bandwidth_aware(...)`` — the latter is
    *flow-compressed*: only the (few) comm flows materialize as intervals for
    the progressive-filling fluid model; compute ops stay scalar columns.
    Used by ``Simulator._time`` whenever ``keep_timelines=False``; only trace
    export keeps the interval-building path.
    """
    starts: list[float] = []
    ends: list[float] = []
    kinds: list[str] = []
    comp_idx: list[int] = []
    comm_idx: list[int] = []
    comm_stream: list[str] = []
    comm_nodes: list[OpNode] = []
    stream_free: dict[str, float] = {}
    done: dict[str, float] = {}

    order = graph.toposort()
    lats = _prices(order, engine)
    for node, lat in zip(order, lats):
        stream = node.stream
        dep_ready = 0.0
        for d in node.deps:
            v = done.get(d, 0.0)
            if v > dep_ready:
                dep_ready = v
        t = max(stream_free.get(stream, 0.0), dep_ready)
        end = t + lat * node.repeat
        i = len(starts)
        starts.append(t)
        ends.append(end)
        kinds.append(node.kind)
        if stream == "compute":
            comp_idx.append(i)
        else:
            comm_idx.append(i)
            comm_stream.append(stream)
            comm_nodes.append(node)
        stream_free[stream] = end
        done[node.name] = end

    comm_streams = {i: s for i, s in zip(comm_idx, comm_stream)}
    if overlap == "bandwidth" and comm_idx:
        # fluid model first (mirrors apply_bandwidth_aware): adjusted comm
        # ends feed the ratio pass, whose comm iteration order becomes the
        # flows' start-sorted order — exactly the Timeline the interval path
        # would hand to apply_ratio_overlap
        from repro_torch.core.overlap import bandwidth_aware_comm
        flows = [Interval(name=str(i), kind=kinds[i], stream=comm_stream[j],
                          start=starts[i], end=ends[i],
                          comm_bytes=comm_nodes[j].comm_bytes
                          * comm_nodes[j].repeat)
                 for j, i in enumerate(comm_idx)]
        adjusted = bandwidth_aware_comm(flows)       # start-order preserved
        for f in adjusted:
            ends[int(f.name)] = f.end
        comm_order = [int(f.name) for f in adjusted]
    else:
        comm_order = comm_idx

    extra: dict[int, float] = {}
    if hw is not None and comm_order:
        sc = hw.overlap_slowdown_compute - 1.0
        sm = hw.overlap_slowdown_comm - 1.0
        smm = hw.overlap_slowdown_comm_comm - 1.0
        for c in comm_order:
            cs, ce = starts[c], ends[c]
            for k in comp_idx:
                ov = min(ce, ends[k]) - max(cs, starts[k])
                if ov <= 0:
                    continue
                extra[k] = extra.get(k, 0.0) + ov * sc
                extra[c] = extra.get(c, 0.0) + ov * sm
        for a, c1 in enumerate(comm_order):
            for b in range(a + 1, len(comm_order)):
                c2 = comm_order[b]
                if comm_streams[c1] == comm_streams[c2]:
                    continue
                ov = min(ends[c1], ends[c2]) - max(starts[c1], starts[c2])
                if ov <= 0:
                    continue
                extra[c1] = extra.get(c1, 0.0) + ov * smm
                extra[c2] = extra.get(c2, 0.0) + ov * smm

    total = 0.0
    by_kind: dict[str, float] = {}
    if overlap == "bandwidth" and comm_idx:
        # match Timeline(rest + adjusted).by_kind() summation order:
        # compute ops in graph order, then comm flows in start-sorted order
        sum_order = comp_idx + comm_order
    else:
        sum_order = range(len(starts))
    for i in sum_order:
        end = ends[i] + extra.get(i, 0.0)
        if end > total:
            total = end
        by_kind[kinds[i]] = by_kind.get(kinds[i], 0.0) + (end - starts[i])
    return total, by_kind


def graph_time_us(graph: Graph, engine) -> float:
    return schedule(graph, engine).total_time
