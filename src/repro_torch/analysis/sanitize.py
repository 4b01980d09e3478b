"""Runtime cache-poisoning detector and determinism harness.

Layer 2 of the correctness tooling (layer 1 is :mod:`repro_torch.analysis.lint`).
Two pieces:

* :class:`SanitizingSimCache` — a drop-in :class:`~repro_torch.core.simcache.
  SimCache` that fingerprints every cached value with a deep structural
  hash at insert and re-verifies the fingerprint on every hit.  Any
  in-place mutation of a cached value — the aliasing class charon-lint R1
  hunts statically — raises :class:`CacheSanitizerError` naming the
  offending bucket and key.  Enabled via ``CHARON_SANITIZE=1`` or
  ``Simulator(sanitize=True)``; the off path stays exactly one attribute
  check (the default ``SimCache`` has no fingerprinting code at all).

* :func:`check_determinism` — runs a spec cold, warm (cached vs cold),
  cache-disabled, and through a pickle round-trip, and diffs the four
  reports field-by-field with exact float equality.  Catches
  nondeterminism the linter cannot see (set-order leaks through data,
  process-salted hashes in persisted state).

This module imports the simulation stack lazily so ``repro_torch.analysis``
stays importable in a bare CI job.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
from typing import Any

from repro_torch.core.simcache import SimCache

__all__ = ["CacheSanitizerError", "DeterminismError", "DeterminismReport",
           "SanitizingSimCache", "check_determinism", "sanitize_enabled",
           "structural_fingerprint"]


def sanitize_enabled() -> bool:
    """True when the CHARON_SANITIZE env knob requests sanitizing."""
    return os.environ.get("CHARON_SANITIZE", "") not in ("", "0")


# ------------------------------------------------------------ fingerprint

def structural_fingerprint(value: Any) -> str:
    """Deep structural hash of *value* — dataclasses, dicts, sequences,
    sets, numpy arrays and scalars all contribute typed tokens, so any
    in-place mutation anywhere in the object graph changes the digest.

    Shared substructure is fine; genuinely cyclic graphs fall back to a
    stable per-path marker rather than recursing forever.
    """
    h = hashlib.blake2b(digest_size=16)
    _feed(h, value, seen=set())
    return h.hexdigest()


def _feed(h, value: Any, seen: set) -> None:
    # cycle guard: mark revisits of an object already on the current path
    if isinstance(value, (dict, list, set, tuple)) \
            or dataclasses.is_dataclass(value):
        vid = id(value)
        if vid in seen:
            h.update(b"<cycle>")
            return
        seen = seen | {vid}

    if value is None or isinstance(value, (bool, int, str, bytes)):
        h.update(f"{type(value).__name__}:{value!r};".encode())
    elif isinstance(value, float):
        # exact bit pattern (repr round-trips doubles; nan/inf included)
        h.update(f"f:{value!r};".encode())
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        h.update(f"dc:{type(value).__name__}(".encode())
        for f in dataclasses.fields(value):
            h.update(f.name.encode() + b"=")
            _feed(h, getattr(value, f.name, None), seen)
        h.update(b");")
    elif isinstance(value, dict):
        h.update(b"dict(")
        # entry fingerprints sorted so dicts differing only in insertion
        # order (still equal) fingerprint identically
        entries = []
        for k, v in value.items():
            eh = hashlib.blake2b(digest_size=16)
            _feed(eh, k, seen)
            eh.update(b"->")
            _feed(eh, v, seen)
            entries.append(eh.digest())
        for d in sorted(entries):
            h.update(d)
        h.update(b");")
    elif isinstance(value, (list, tuple)):
        h.update(f"{type(value).__name__}(".encode())
        for v in value:
            _feed(h, v, seen)
        h.update(b");")
    elif isinstance(value, (set, frozenset)):
        h.update(f"{type(value).__name__}(".encode())
        entries = []
        for v in value:
            eh = hashlib.blake2b(digest_size=16)
            _feed(eh, v, seen)
            entries.append(eh.digest())
        for d in sorted(entries):
            h.update(d)
        h.update(b");")
    elif type(value).__module__ == "numpy":
        import numpy as np
        arr = np.asarray(value)
        h.update(f"np:{arr.dtype}:{arr.shape}:".encode())
        h.update(np.ascontiguousarray(arr).tobytes())
        h.update(b";")
    else:
        # opaque object: repr is the best stable surface available
        h.update(f"obj:{type(value).__name__}:{value!r};".encode())


# ------------------------------------------------------------ sanitizer

class CacheSanitizerError(RuntimeError):
    """A cached value's structural fingerprint changed between insert and a
    later hit — someone mutated a cache-fetched value in place."""

    def __init__(self, bucket: str, key: Any, stored: str, now: str):
        self.bucket = bucket
        self.key = key
        self.stored_fingerprint = stored
        self.current_fingerprint = now
        super().__init__(
            f"cache poisoning detected in bucket {bucket!r}, key {key!r}: "
            f"value fingerprint changed {stored} -> {now} since insert; a "
            "consumer mutated a cached value in place (see charon-lint R1 "
            "and docs/static-analysis.md)")


class SanitizingSimCache(SimCache):
    """SimCache that verifies cached values were never mutated in place.

    Fingerprints are recorded at miss (insert) and at the first hit of an
    entry merged from the persistent tier, then re-verified on every
    subsequent hit.  The fingerprint table lives beside the data buckets
    and never pickles into the persistent tier.
    """

    def __init__(self, enabled: bool = True):
        super().__init__(enabled)
        self._fps: dict[str, dict] = {b: {} for b in self.BUCKETS}

    def get(self, bucket: str, key: Any, build):
        if not self.enabled:
            return build()
        d = self._data[bucket]
        st = self.stats[bucket]
        try:
            hit = key in d
        except TypeError:           # unhashable key component: skip caching
            return build()
        fps = self._fps[bucket]
        if hit:
            st.hits += 1
            v = d[key]
            now = structural_fingerprint(v)
            stored = fps.get(key)
            if stored is None:
                # first sighting of a persisted-tier entry
                fps[key] = now
            elif now != stored:
                raise CacheSanitizerError(bucket, key, stored, now)
            return v
        st.misses += 1
        v = build()
        d[key] = v
        fps[key] = structural_fingerprint(v)
        return v

    def clear(self) -> None:
        super().clear()
        self._fps = {b: {} for b in self.BUCKETS}


# ------------------------------------------------------------ determinism

class DeterminismError(AssertionError):
    """check_determinism(..., raise_on_mismatch=True) found a diff."""


@dataclasses.dataclass(frozen=True)
class DeterminismReport:
    """Outcome of :func:`check_determinism`: per-variant field diffs
    against the cold baseline run."""
    ok: bool
    variants: tuple                       # variant names compared
    mismatches: tuple                     # (variant, field_path, a, b)
    ignored_fields: tuple

    def render(self) -> str:
        if self.ok:
            return ("determinism check ok: " + ", ".join(self.variants)
                    + " all bit-identical to the cold run")
        lines = [f"determinism check FAILED "
                 f"({len(self.mismatches)} field diff(s)):"]
        for variant, path, a, b in self.mismatches:
            lines.append(f"  [{variant}] {path}: {a!r} != {b!r}")
        return "\n".join(lines)


# counter-like surfaces legitimately differing between warm and cold runs
_TELEMETRY_FIELDS = frozenset({"oracle_stats"})


def diff_values(a: Any, b: Any, path: str = "report",
                ignore: frozenset = _TELEMETRY_FIELDS) -> list:
    """Recursive field-by-field diff with exact float equality (nan==nan).
    Returns (path, a, b) rows; empty means bit-identical."""
    out: list = []
    if dataclasses.is_dataclass(a) and not isinstance(a, type) \
            and type(a) is type(b):
        for f in dataclasses.fields(a):
            if f.name in ignore:
                continue
            out.extend(diff_values(getattr(a, f.name), getattr(b, f.name),
                                   f"{path}.{f.name}", ignore))
    elif isinstance(a, dict) and isinstance(b, dict):
        for k in a.keys() | b.keys():
            if k in ignore:
                continue
            ka, kb = a.get(k, "<missing>"), b.get(k, "<missing>")
            out.extend(diff_values(ka, kb, f"{path}[{k!r}]", ignore))
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            out.append((path, f"len={len(a)}", f"len={len(b)}"))
        else:
            for i, (va, vb) in enumerate(zip(a, b)):
                out.extend(diff_values(va, vb, f"{path}[{i}]", ignore))
    elif isinstance(a, float) and isinstance(b, float):
        same = (a == b) or (a != a and b != b)   # exact; nan == nan
        if not same:
            out.append((path, a, b))
    elif a != b:
        out.append((path, a, b))
    return out


def _run_spec(spec, *, cache: bool, engine: str, sim=None):
    """Price *spec* on the right simulator for its workload mode."""
    from repro_torch.core.simulator import Simulator
    if sim is None:
        sim = Simulator(spec.cluster.resolve(), engine=engine, cache=cache)
    if getattr(spec.workload, "mode", None) == "serving":
        from repro_torch.serving.sim import ServingSimulator
        return ServingSimulator(sim).run(spec), sim
    if getattr(spec, "resilience", None) is not None:
        from repro_torch.resilience import ResilienceSimulator
        return ResilienceSimulator(sim).run(spec), sim
    return sim.run(spec), sim


def check_determinism(spec, *, engine: str = "analytical",
                      raise_on_mismatch: bool = False) -> DeterminismReport:
    """Run *spec* four ways and require bit-identical reports:

    * ``cold``      — fresh simulator, empty caches (the baseline)
    * ``warm``      — the same simulator again, everything cache-hit
    * ``uncached``  — fresh simulator with ``cache=False``
    * ``pickled``   — fresh simulator fed ``pickle.loads(pickle.dumps(
      spec))``, catching process-salted state leaking into the spec
      (a process-salted memo that ``__getstate__`` must drop)

    Telemetry counters (``oracle_stats``) are excluded: they legitimately
    differ between warm and cold runs.
    """
    base, sim = _run_spec(spec, cache=True, engine=engine)
    variants = {
        "warm": _run_spec(spec, cache=True, engine=engine, sim=sim)[0],
        "uncached": _run_spec(spec, cache=False, engine=engine)[0],
        "pickled": _run_spec(pickle.loads(pickle.dumps(spec)),
                             cache=True, engine=engine)[0],
    }
    mismatches: list = []
    for name, rep in variants.items():
        for path, a, b in diff_values(base, rep):
            mismatches.append((name, path, a, b))
    report = DeterminismReport(ok=not mismatches,
                               variants=tuple(variants),
                               mismatches=tuple(mismatches),
                               ignored_fields=tuple(sorted(
                                   _TELEMETRY_FIELDS)))
    if raise_on_mismatch and not report.ok:
        raise DeterminismError(report.render())
    return report
