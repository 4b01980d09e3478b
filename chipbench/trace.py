"""The traced run's records: spans that the benchmark opens around its calls
into the program (host clock), and the device's kernels over a steady slice
of the window (``torch.profiler``, the device's activity alone).

A span ends in a device sync where it is opened with ``sync=True``, so its
length is the time the work took and not the time to enqueue it.  The
profiler's clock is tied to the host's by a marker: after a sync, one small
kernel is launched at a known host time, and it is the slice's first kernel.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class Span:
    name: str
    t0: float
    t1: float
    depth: int
    info: dict = field(default_factory=dict)


class Spans:
    """Spans of the traced run; ``enabled=False`` (the untraced run) records
    nothing and wraps nothing."""

    def __init__(self, enabled: bool, sync=None):
        self.enabled = enabled
        self.sync = sync
        self.items: list[Span] = []
        self._depth = 0

    @contextlib.contextmanager
    def span(self, name: str, *, sync: bool = False, **info):
        if not self.enabled:
            yield info
            return
        t0 = time.perf_counter()
        self._depth += 1
        try:
            yield info
        finally:
            if sync and self.sync is not None:
                self.sync()
            self._depth -= 1
            self.items.append(Span(name, t0, time.perf_counter(), self._depth, info))

    def wrap(self, obj, attr: str, name: str, *, sync: bool = False, info=None):
        """Replace ``obj.attr`` (on the instance) by a call inside a span;
        ``info(*args)`` gives the span's details."""
        if not self.enabled:
            return
        fn = getattr(obj, attr)

        def wrapped(*args, **kw):
            with self.span(name, sync=sync, **(info(*args, **kw) if info else {})):
                return fn(*args, **kw)

        setattr(obj, attr, wrapped)

    def named(self, name: str) -> list[Span]:
        return [s for s in self.items if s.name == name]


@dataclass
class Kernel:
    name: str
    t0: float
    t1: float


class DeviceSlice:
    """The device's kernels between ``start()`` and ``stop()``."""

    def __init__(self, torch, device):
        self.torch = torch
        self.device = device
        self.t_start = self.t_stop = None
        self._prof = None
        self._mark = torch.zeros(1, device=device)
        self._t_mark = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch = self.torch
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t_mark = time.perf_counter()
        self._mark.add_(1.0)
        torch.cuda.synchronize(self.device)
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        self.torch.cuda.synchronize(self.device)
        self.t_stop = time.perf_counter()
        self._prof.__exit__(None, None, None)

    def kernels(self) -> list[Kernel]:
        """Every device activity of the slice (kernels, copies, fills) on the
        host's clock, the marker left out."""
        raw = _device_events(self._prof, self.torch)
        if not raw:
            raise RuntimeError("the profiler delivered no device activity in the slice")
        raw.sort(key=lambda e: e[1])
        _, m0, _ = raw[0]
        off = self._t_mark - m0
        return [Kernel(n, a + off, b + off) for n, a, b in raw[1:]]


def _device_events(prof, torch) -> list[tuple[str, float, float]]:
    """(name, start s, end s) of each device event, on the profiler's clock."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    kin = getattr(prof.profiler, "kineto_results", None)
    if kin is not None:
        for e in kin.events():
            if e.device_type() == cuda:
                s = e.start_ns() * 1e-9
                out.append((e.name(), s, s + e.duration_ns() * 1e-9))
        if out:
            return out
    for e in prof.events():
        if e.device_type == cuda:
            out.append((e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6))
    return out


def merged(kernels: list[Kernel], lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of the kernels' intervals, clipped to [lo, hi]."""
    iv = sorted((max(k.t0, lo), min(k.t1, hi)) for k in kernels if k.t1 > lo and k.t0 < hi)
    out: list[list[float]] = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(kernels: list[Kernel], lo: float, hi: float) -> float:
    return sum(b - a for a, b in merged(kernels, lo, hi))


def idle_gaps(kernels: list[Kernel], lo: float, hi: float) -> list[tuple[float, float]]:
    """The intervals of [lo, hi] in which no device activity ran."""
    gaps, t = [], lo
    for a, b in merged(kernels, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def open_span(spans: list[Span], t: float) -> str:
    """The innermost span open at host time t, or "none"."""
    best = None
    for s in spans:
        if s.t0 <= t <= s.t1 and (best is None or s.depth > best.depth):
            best = s
    return best.name if best is not None else "none"


@dataclass
class Traced:
    """What the per-layer metrics read: the cell's files, the spans and the
    slice's kernels."""
    cfg: dict
    traffic: dict
    cell: dict
    spans: Spans
    kernels: list[Kernel]
    slice_t0: float
    slice_t1: float
    window_t0: float
    window_t1: float

    def in_slice(self, name: str) -> list[Span]:
        return [s for s in self.spans.named(name)
                if s.t0 >= self.slice_t0 and s.t1 <= self.slice_t1]

    def group_s(self, group: str) -> float:
        from chipbench.groups import kernel_group
        return sum(k.t1 - k.t0 for k in self.kernels
                   if kernel_group(k.name) == group and self.slice_t0 <= k.t0 < self.slice_t1)

    def breakdown(self, n: int = 10) -> dict:
        from chipbench.groups import kernel_group
        groups: dict[str, float] = {}
        for k in self.kernels:
            g = kernel_group(k.name)
            groups[g] = groups.get(g, 0.0) + (k.t1 - k.t0)
        ops = sorted(groups.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(idle_gaps(self.kernels, self.slice_t0, self.slice_t1),
                      key=lambda g: g[0] - g[1])[:n]
        items = self.spans.items
        return {"device_ops": [[g, s] for g, s in ops],
                "idle_gaps": [[open_span(items, (a + b) / 2), b - a] for a, b in gaps]}
