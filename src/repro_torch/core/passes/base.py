"""Compiler-style pass framework (paper §3.2b).

Optimizations, parallelisms and analyses are graph->graph passes; adding or
removing a pass toggles the corresponding feature in simulation; passes
compose freely (``PassManager``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Protocol

from repro_torch.core.ir import Graph


@dataclass(unsafe_hash=True)
class ParallelConfig:
    """Parallelism sizes the passes shard the graph by.

    Hashable (``unsafe_hash``) so a :class:`repro_torch.api.spec.SimSpec` can be a
    cache key; treat instances as frozen — build variants with
    ``dataclasses.replace``."""
    tp: int = 1
    dp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1           # Megatron sequence parallelism (within the TP group)
    pods: int = 1
    cp: int = 1           # context parallelism
    zero_stage: int = 0
    microbatches: int = 1
    pp_schedule: str = "1f1b"   # 1f1b | dualpipe | gpipe

    @property
    def chips(self) -> int:
        return self.tp * self.dp * self.pp * self.pods * self.cp

    def key(self) -> tuple:
        """Hashable identity over every field (cache keys, dedup)."""
        return (self.tp, self.dp, self.pp, self.ep, self.sp, self.pods,
                self.cp, self.zero_stage, self.microbatches, self.pp_schedule)

    def shard_key(self) -> tuple:
        """The fields the graph-rewriting passes consume (TP/SP/EP/CP).

        Replication axes (dp, pods, pp, microbatches, zero) only enter the
        stack/schedule math, not per-block graphs — candidates that differ
        only there share priced block graphs."""
        return (self.tp, self.sp, self.ep, self.cp)


@dataclass
class PassContext:
    parallel: ParallelConfig
    model: object | None = None          # ModelConfig when known
    param_bytes: float = 0.0             # per pipeline stage, pre-sharding
    extra: dict = field(default_factory=dict)


class Pass(Protocol):
    name: str

    def apply(self, g: Graph, ctx: PassContext) -> Graph: ...


def pass_cache_key(p) -> tuple:
    """Hashable identity of one pass instance.  Parameterized passes override
    ``cache_key()``; stateless passes are identified by name."""
    ck = getattr(p, "cache_key", None)
    if ck is not None:
        return ck()
    return (getattr(p, "name", type(p).__name__),)


class PassManager:
    def __init__(self, passes: list | None = None):
        self.passes = list(passes or [])

    def add(self, p) -> "PassManager":
        self.passes.append(p)
        return self

    def run(self, g: Graph, ctx: PassContext) -> Graph:
        for p in self.passes:
            g = p.apply(g, ctx)
        return g

    def signature(self) -> tuple:
        """Pipeline identity for post-pass graph caching: two managers with
        equal signatures rewrite a given graph identically (for equal
        ``ParallelConfig.shard_key()``)."""
        return tuple(pass_cache_key(p) for p in self.passes)
