"""Hierarchical link-centric collective model (paper §3.3c).

Collectives decompose into physical link-level transfers: per hop the cost is
calibrated handshake latency + payload / effective bandwidth.  Ring and tree
algorithms over the chosen link domain; cross-pod ('dp across DCN') groups pay
the hierarchical price: intra-pod reduce-scatter + inter-pod exchange +
intra-pod all-gather.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.backend.hardware import HardwareSpec, LinkDomain
from repro_torch.core.simcache import CacheStats


def _ring_steps(kind: str, n: int) -> tuple[float, float]:
    """(#hops, per-hop payload fraction of the FULL buffer) for ring algos."""
    if n <= 1:
        return 0.0, 0.0
    if kind == "all_reduce":
        return 2.0 * (n - 1), 1.0 / n
    if kind in ("all_gather", "reduce_scatter"):
        return float(n - 1), 1.0 / n
    if kind == "all_to_all":
        return float(n - 1), 1.0 / n
    if kind in ("send", "recv", "collective_permute"):
        return 1.0, 1.0
    raise ValueError(kind)


def _tree_steps(kind: str, n: int) -> tuple[float, float]:
    if n <= 1:
        return 0.0, 0.0
    levels = math.ceil(math.log2(n))
    if kind == "all_reduce":
        return 2.0 * levels, 1.0          # reduce + broadcast, full payload/hop
    return float(levels), 1.0


def collective_time_us(kind: str, payload_bytes: float, group_size: int,
                       link: LinkDomain, *, algorithm: str = "ring",
                       congestion: float = 1.0) -> float:
    """Time for one collective over a single link domain.

    ``payload_bytes``: full per-device buffer size.  ``congestion`` > 1 divides
    the effective bandwidth (bandwidth-aware overlap model, paper §3.4).
    """
    if group_size <= 1 or payload_bytes <= 0:
        return 0.0
    steps, frac = (_tree_steps if algorithm == "tree" else _ring_steps)(kind, group_size)
    bw = link.bandwidth * max(link.links_per_chip, 1) / max(congestion, 1.0)
    per_hop = link.latency_us + (payload_bytes * frac) / bw * 1e6
    return steps * per_hop


@dataclass(frozen=True)
class GroupSpec:
    """A communication group: participants within a pod and across pods."""
    intra_size: int = 1     # group participants inside one pod (ICI)
    inter_size: int = 1     # pods spanned (DCN)


# Memo for hierarchical collective times.  The p2p/DP-sync terms in
# ``Simulator.simulate`` recompute the same handful of (kind, payload, group)
# tuples for every sweep candidate; the result is a pure function of its
# arguments, so a flat dict suffices.  The key carries the ``LinkDomain``
# field values themselves (frozen, hashable) rather than the HardwareSpec
# identity — a different spec, or a recalibrated link, hashes to a different
# key, which gives the same staleness guarantee the pricing cache gets from
# its engine state version, without any explicit versioning.
_MEMO: dict[tuple, float] = {}
_MEMO_MAX = 200_000          # runaway-sweep backstop, not a tuning knob
_MEMO_STATS = CacheStats()


def collective_memo_stats() -> CacheStats:
    return _MEMO_STATS


def collective_memo_clear() -> None:
    _MEMO.clear()
    _MEMO_STATS.hits = _MEMO_STATS.misses = 0


def hierarchical_collective_time_us(kind: str, payload_bytes: float,
                                    group: GroupSpec, hw: HardwareSpec,
                                    *, algorithm: str = "ring",
                                    congestion: float = 1.0) -> float:
    """Cross-pod collectives decompose hierarchically:
    intra-pod reduce-scatter -> inter-pod stage on the shard -> intra-pod
    all-gather (standard hierarchical all-reduce).  Memoized (module level,
    shared across simulators): see ``_MEMO`` above."""
    key = (kind, payload_bytes, group.intra_size, group.inter_size,
           hw.intra, hw.inter, algorithm, congestion)
    t = _MEMO.get(key)
    if t is not None:
        _MEMO_STATS.hits += 1
        return t
    _MEMO_STATS.misses += 1
    t = _hierarchical_uncached(kind, payload_bytes, group, hw,
                               algorithm=algorithm, congestion=congestion)
    if len(_MEMO) >= _MEMO_MAX:
        _MEMO.clear()
    _MEMO[key] = t
    return t


def _hierarchical_uncached(kind: str, payload_bytes: float, group: GroupSpec,
                           hw: HardwareSpec, *, algorithm: str = "ring",
                           congestion: float = 1.0) -> float:
    ni, ne = group.intra_size, group.inter_size
    if ne <= 1:
        return collective_time_us(kind, payload_bytes, ni, hw.intra,
                                  algorithm=algorithm, congestion=congestion)
    if ni <= 1:
        return collective_time_us(kind, payload_bytes, ne, hw.inter,
                                  algorithm=algorithm, congestion=congestion)
    if kind == "all_reduce":
        t = collective_time_us("reduce_scatter", payload_bytes, ni, hw.intra,
                               congestion=congestion)
        t += collective_time_us("all_reduce", payload_bytes / ni, ne, hw.inter,
                                congestion=congestion)
        t += collective_time_us("all_gather", payload_bytes, ni, hw.intra,
                                congestion=congestion)
        return t
    # gather/scatter style: do the intra stage then the inter stage on shards
    t = collective_time_us(kind, payload_bytes, ni, hw.intra, congestion=congestion)
    t += collective_time_us(kind, payload_bytes / ni, ne, hw.inter,
                            congestion=congestion)
    return t


def link_traffic_bytes(kind: str, payload_bytes: float, group_size: int) -> float:
    """Per-device link traffic (used for the roofline collective term)."""
    n = max(group_size, 1)
    if n == 1:
        return 0.0
    if kind == "all_reduce":
        return 2.0 * (n - 1) / n * payload_bytes
    if kind == "all_gather":
        return (n - 1) * payload_bytes / n
    if kind in ("reduce_scatter", "all_to_all"):
        return (n - 1) / n * payload_bytes
    return payload_bytes
