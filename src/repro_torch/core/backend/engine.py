"""Backend engine protocol (paper §3.3).

An engine prices a single operator: ``latency_us(node) -> float | None``
(None = unsupported, the fused engine falls through to the next priority).
The fused engine memoizes prices on a canonical operator signature — sweep
candidates re-price the same (kind, shapes, dtype, comm) tuples thousands of
times, and every registered engine is a pure function of those fields.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

from repro_torch.core.backend.hardware import HardwareSpec
from repro_torch.core.ir import OpNode
from repro_torch.core.simcache import CacheStats


@runtime_checkable
class Engine(Protocol):
    name: str
    priority: int  # higher = preferred by the fused engine

    def supports(self, node: OpNode) -> bool: ...

    def latency_us(self, node: OpNode) -> float | None: ...


def node_signature(node: OpNode) -> tuple:
    """Canonical pricing signature: every node field any engine consumes.

    Analytical: kind/dtype/flops/bytes/comm + mm_dims + operand_bytes.
    Profiling:  kind/dtype + mm_dims | attn_dims | out_shape (+ vocab,
                + an attention node's group size ``G``, which the port's
                profiling key carries and the reference's has not).
    Prediction: kind/dtype + dims + flops + total_bytes.
    ``repeat`` and ``phase`` are deliberately excluded — engines price one
    execution; the scheduler applies the repeat multiplier.
    """
    a = node.attrs
    mm = a.get("mm_dims")
    at = a.get("attn_dims")
    return (node.kind, node.dtype, node.flops, node.bytes_in, node.bytes_out,
            node.comm_bytes, node.comm_group, node.comm_size,
            tuple(node.out_shape) if node.out_shape else (),
            tuple(mm) if mm else None, tuple(at) if at else None,
            a.get("operand_bytes"), a.get("vocab"), a.get("G"))


class FusedEngine:
    """Priority-fallback over a registry of engines (paper §3.3d).

    Each engine keeps its own supported-operator registry; the fused engine
    dynamically selects the highest-priority engine for every operator and
    falls back when an engine declines (returns None).  Prices are memoized
    per :func:`node_signature` with hit/miss counters for the benchmarks."""

    name = "fused"

    def __init__(self, engines, *, cache: bool = True):
        self.engines = sorted(engines, key=lambda e: -e.priority)
        self._cache: dict | None = {} if cache else None
        self.stats = CacheStats()
        self._version = self._state_version()

    def _state_version(self) -> int:
        """Combined version of mutable engine state (profiling DB contents,
        prediction-model retrains).  A change invalidates the price memo —
        engines are pure functions of (signature, state version)."""
        return sum(int(getattr(e, "state_version", 0)) for e in self.engines)

    def supports(self, node: OpNode) -> bool:
        return any(e.supports(node) for e in self.engines)

    def _price(self, node: OpNode) -> tuple[float | None, str]:
        for e in self.engines:
            if e.supports(node):
                t = e.latency_us(node)
                if t is not None:
                    return t, e.name
        return None, "none"

    def _priced(self, node: OpNode) -> tuple[float | None, str]:
        if self._cache is None:
            return self._price(node)
        v = self._state_version()
        if v != self._version:
            self._cache.clear()
            self._version = v
        try:
            sig = node_signature(node)
            ent = self._cache.get(sig)
        except TypeError:            # exotic attrs: price uncached
            return self._price(node)
        if ent is not None:
            self.stats.hits += 1
            return ent
        self.stats.misses += 1
        ent = self._price(node)
        self._cache[sig] = ent
        return ent

    def latency_us(self, node: OpNode) -> float | None:
        return self._priced(node)[0]

    def price_batch(self, nodes) -> list:
        """Vectorized pricing for a node batch (the scheduler's pre-pass).

        Cache hits resolve per signature exactly like :meth:`latency_us`;
        misses are grouped and pushed through the highest-priority engine's
        ``price_batch`` when one exists (the analytical roofline vectorizes),
        falling back to the scalar priority chain per node whenever a
        profile-DB-backed engine could claim the node — batch results are
        bit-identical to the scalar path by construction.  Duplicate
        signatures within one batch count one miss then hits, matching the
        scalar call sequence."""
        if self._cache is None:
            return [self._price(n)[0] for n in nodes]
        v = self._state_version()
        if v != self._version:
            self._cache.clear()
            self._version = v
        out: list = [None] * len(nodes)
        last = self.engines[-1] if self.engines else None
        vec_engine = last if hasattr(last, "price_batch") else None
        pending: dict[tuple, list[int]] = {}
        sig_of: list = [None] * len(nodes)
        for i, node in enumerate(nodes):
            try:
                sig = node_signature(node)
            except TypeError:            # exotic attrs: price uncached
                out[i] = self._price(node)[0]
                continue
            ent = self._cache.get(sig)
            if ent is not None:
                self.stats.hits += 1
                out[i] = ent[0]
            elif sig in pending:
                self.stats.hits += 1     # scalar path: earlier miss primed it
                pending[sig].append(i)
            else:
                self.stats.misses += 1
                pending[sig] = [i]
                sig_of[i] = sig
        if not pending:
            return out
        vec_nodes: list[OpNode] = []
        vec_sigs: list[tuple] = []
        for i, sig in enumerate(sig_of):
            if sig is None:
                continue
            node = nodes[i]
            # a node any higher-priority engine claims keeps the scalar
            # fallback chain (profile DBs may still decline with None)
            if vec_engine is not None and vec_engine.supports(node) and not any(
                    e.supports(node) for e in self.engines[:-1]):
                vec_nodes.append(node)
                vec_sigs.append(sig)
            else:
                ent = self._price(node)
                self._cache[sig] = ent
                for j in pending[sig]:
                    out[j] = ent[0]
        if vec_nodes:
            prices = vec_engine.price_batch(vec_nodes)
            for sig, t in zip(vec_sigs, prices):
                ent = (t, vec_engine.name) if t is not None else (None, "none")
                self._cache[sig] = ent
                for j in pending[sig]:
                    out[j] = ent[0]
        return out

    def engine_for(self, node: OpNode) -> str:
        return self._priced(node)[1]

    def cache_clear(self) -> None:
        if self._cache is not None:
            self._cache.clear()
        self.stats = CacheStats()

    def cache_info(self) -> CacheStats:
        return self.stats
