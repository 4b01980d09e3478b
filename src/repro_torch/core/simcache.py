"""Layered memoization for the simulation stack.

Design-space sweeps evaluate thousands of near-identical candidates; most of
the per-candidate cost (JAX tracing in ``block_graphs``, pass pipelines,
per-node engine pricing) repeats verbatim whenever two candidates share the
relevant key.  ``SimCache`` holds the three sweep-level buckets:

* ``ingest``       — ``block_graphs`` results, keyed on
                     (model config, B_local, S, mode, cache_len)
* ``passes``       — post-``PassManager`` graphs, keyed on
                     (ingest key, block kind, fwd/joint, pipeline signature,
                     parallel signature)
* ``block_times``  — the whole priced block stage (t_fwd / t_bwd / kind_us
                     plus the transformed first-block graphs the memory
                     analyzer needs), keyed on the union of the above
* ``memory``       — the memory analyzer's block-graph liveness walk
                     (``core.memory.block_liveness``), keyed like the block
                     stage minus the engine version (liveness reads bytes,
                     not prices)
* ``serving``      — whole ``Report``s priced for the request-level serving
                     simulator's step oracle, keyed directly on the
                     bucketed :class:`repro_torch.api.spec.SimSpec` (specs are
                     frozen and hashable — the spec *is* the cache key)
                     plus the engine state version
* ``reports``      — whole ``Report``s per simulated spec, keyed on
                     (``SimSpec.json_hash()``, engine state version).  Only
                     consulted when a persistent tier is attached: it is the
                     cross-run memo that lets a repeated CLI/benchmark run
                     skip JAX tracing entirely.

Operator-pricing memoization lives on ``FusedEngine`` (see
``backend/engine.py``) but reports through the same ``CacheStats`` type so
benchmarks can track hit rates uniformly.  All cached values are treated as
immutable by their consumers; correctness bar: bit-identical ``Report``s with
caching on vs off (see tests/test_perf_cache.py).

Persistence: :meth:`SimCache.attach_persistent` loads a versioned pickle of
the cacheable buckets (+ the fused engine's pricing table) written by
:meth:`SimCache.save_persistent`.  The file is keyed by a metadata dict —
cache format version, package version, jax version, hardware name, engine
stack, overlap model and an engine-state digest — and is ignored wholesale on
any mismatch, so a package upgrade or a profile-DB change can never serve
stale entries (tests/test_sweep_parallel.py).
"""
from __future__ import annotations

import os
import pickle
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

# bump when the pickled layout of any cached value changes incompatibly
CACHE_FORMAT = 1


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0

    @property
    def total(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.total if self.total else 0.0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": round(self.hit_rate, 4)}


class SimCache:
    """Sweep-scoped cache of expensive simulation sub-results.

    ``enabled=False`` turns every ``get`` into a pass-through build (the cold
    path), which keeps cached and uncached runs on the same code path — the
    property the bit-identical tests rely on.
    """

    BUCKETS = ("ingest", "passes", "block_times", "memory", "serving",
               "reports")
    # buckets whose keys/values survive pickling across processes ("passes"
    # rides along with "ingest": both hold plain Graphs keyed by hashable
    # tuples of frozen dataclasses; "serving" keys are frozen SimSpecs)
    PERSISTED = ("ingest", "passes", "block_times", "memory", "serving",
                 "reports")

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._data: dict[str, dict] = {b: {} for b in self.BUCKETS}
        self.stats: dict[str, CacheStats] = {b: CacheStats() for b in self.BUCKETS}
        self.persist_path: Path | None = None
        self._persist_meta: dict | None = None
        self.loaded_sizes: dict[str, int] = {}

    def get(self, bucket: str, key: Any, build: Callable[[], Any]) -> Any:
        if not self.enabled:
            return build()
        d = self._data[bucket]
        st = self.stats[bucket]
        try:
            hit = key in d
        except TypeError:           # unhashable key component: skip caching
            return build()
        if hit:
            st.hits += 1
            return d[key]
        st.misses += 1
        v = build()
        d[key] = v
        return v

    def clear(self) -> None:
        for d in self._data.values():
            d.clear()
        self.stats = {b: CacheStats() for b in self.BUCKETS}

    def sizes(self) -> dict[str, int]:
        return {b: len(d) for b, d in self._data.items()}

    def stats_dict(self) -> dict[str, dict]:
        return {b: st.as_dict() for b, st in self.stats.items()}

    # ---------------- persistent tier -------------------------------------
    @property
    def persistent(self) -> bool:
        return self.persist_path is not None

    def attach_persistent(self, path: str | Path, meta: dict) -> dict:
        """Attach an on-disk tier: load ``path`` if it exists and its stored
        metadata equals ``meta`` (any mismatch — package version, engine
        state digest, hardware, cache format — invalidates the whole file),
        merge its buckets, and return the persisted engine pricing table for
        the caller to splice into its ``FusedEngine``.  Corrupt or
        unreadable files are treated as a cold start."""
        self.persist_path = Path(path)
        self._persist_meta = dict(meta)
        self.loaded_sizes = {}
        if not self.enabled or not self.persist_path.exists():
            return {}
        try:
            with open(self.persist_path, "rb") as f:
                blob = pickle.load(f)
        except Exception:
            return {}
        if blob.get("meta") != self._persist_meta:
            return {}                     # versioned key mismatch: invalidate
        for b in self.PERSISTED:
            entries = blob.get("buckets", {}).get(b)
            if entries:
                self._data[b].update(entries)
                self.loaded_sizes[b] = len(entries)
        pricing = blob.get("pricing", {})
        if pricing:
            self.loaded_sizes["pricing"] = len(pricing)
        return pricing

    def save_persistent(self, pricing: dict | None = None, *,
                        meta: dict | None = None,
                        path: str | Path | None = None) -> Path | None:
        """Atomically write the persisted buckets (+ engine pricing table)
        to the attached path.  No-op without :meth:`attach_persistent`.

        ``meta`` lets the caller stamp the file with the *current* engine
        state (recomputed at save time): entries priced after a profile-DB
        mutation must never be described by the attach-time digest.
        ``path`` overrides the destination without re-attaching — how sweep
        worker processes write per-worker *shards* next to the main file
        (merged by :func:`repro_torch.core.simulator.merge_cache_shards`) instead
        of racing each other on it."""
        if self.persist_path is None:
            return None
        if meta is not None:
            self._persist_meta = dict(meta)
        blob = {
            "meta": self._persist_meta,
            "buckets": {b: self._data[b] for b in self.PERSISTED},
            "pricing": pricing or {},
        }
        return atomic_pickle(Path(path) if path is not None
                             else self.persist_path, blob)


def atomic_pickle(path: Path, blob) -> Path:
    """Pickle *blob* to *path* via tmp-file + ``os.replace`` so a concurrent
    reader (or a crash mid-write) can never observe a partial file at the
    final name.  Shared by the persistent tier and the shard merge."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)                # atomic vs concurrent runs
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path
