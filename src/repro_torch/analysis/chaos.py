"""Deterministic chaos injection for the sweep execution layer.

The crash-safe worker pool (:mod:`repro_torch.api.pool`) recovers from worker
crashes, hangs, poison candidates and corrupt cache shards — but recovery
paths that are never exercised rot.  A :class:`FaultPlan` injects exactly
those failures, *deterministically*: every decision is a pure function of
``(seed, kind, key, attempt)`` hashed through blake2b, so a fault schedule
is reproducible across runs, processes and machines (no ``hash()``
randomization, no RNG sequence coupling to execution order).

The headline contract (tests/test_pool_robustness.py, CI chaos smoke): a
sweep under any injected fault schedule that does not exhaust a candidate's
retries produces rankings, reports and pruned reasons **bit-identical** to
the fault-free serial sweep.  Faults touch only the execution layer; they
must never be able to change a simulated number.

Fault kinds (the ``CHARON_FAULTS`` grammar, comma-separated ``kind:rate``):

* ``worker_crash``    — the worker process ``os._exit(137)``s before
                        evaluating the candidate (simulated segfault);
* ``worker_hang``     — the worker sleeps ``hang_s`` mid-candidate, so the
                        pool's per-candidate timeout must fire;
* ``candidate_error`` — a :class:`ChaosError` is raised inside evaluation
                        (simulated poison candidate; the only kind also
                        honored by *serial* sweeps, which have no process
                        boundary to crash);
* ``cache_corrupt``   — the worker's persistent-cache shard is truncated
                        mid-file after writing, so the parent's shard merge
                        must quarantine it.

Extra knobs: ``seed:<int>`` reseeds every decision; ``repeat:1`` makes a
faulted candidate fault on *every* attempt (default: first attempt only, so
bounded retry always recovers — the bit-identity schedule).  Example::

    CHARON_FAULTS="worker_crash:0.05,worker_hang:0.01,cache_corrupt:0.02"

Programmatic use: ``sweep(space, workers=2, faults=FaultPlan(seed=7,
worker_crash=0.3))``.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass


class ChaosError(RuntimeError):
    """The injected poison-candidate failure (``candidate_error``)."""


_RATE_KINDS = ("worker_crash", "worker_hang", "candidate_error",
               "cache_corrupt")


@dataclass(frozen=True)
class FaultPlan:
    """A seeded, hashable fault schedule (frozen: doubles as a pool key)."""
    worker_crash: float = 0.0
    worker_hang: float = 0.0
    candidate_error: float = 0.0
    cache_corrupt: float = 0.0
    seed: int = 0
    # fire on every attempt (exhausts retries -> quarantine paths) instead
    # of only the first (always-recoverable -> bit-identity paths)
    repeat: bool = False
    # how long an injected hang sleeps; the pool's per-candidate timeout is
    # expected to kill the worker long before this elapses
    hang_s: float = 3600.0

    def __post_init__(self):
        for kind in _RATE_KINDS:
            rate = getattr(self, kind)
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{kind} rate must be in [0, 1], "
                                 f"got {rate!r}")

    @property
    def enabled(self) -> bool:
        return any(getattr(self, k) > 0.0 for k in _RATE_KINDS)

    # ------------------------------------------------------------------
    def roll(self, kind: str, *key) -> bool:
        """Pure decision: blake2b((seed, kind, *key)) < rate.  Stable across
        processes and runs — never the interpreter ``hash()`` and never a
        sequential RNG stream (which would couple faults to dispatch
        order)."""
        rate = getattr(self, kind)
        if rate <= 0.0:
            return False
        if rate >= 1.0:
            return True
        blob = "|".join(str(p) for p in (self.seed, kind) + key)
        h = hashlib.blake2b(blob.encode(), digest_size=8).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64 < rate

    def should(self, kind: str, key: tuple, attempt: int = 1) -> bool:
        """Does *kind* fire for *key* on this *attempt*?  Without
        ``repeat``, a faulted key faults only on its first attempt, so the
        pool's retry always recovers it."""
        if attempt > 1 and not self.repeat:
            return False
        return self.roll(kind, *key)

    def maybe_raise(self, candidate_hash: str, attempt: int = 1) -> None:
        """Serial-safe injection: only ``candidate_error`` (a process with
        no worker boundary cannot meaningfully crash or hang itself)."""
        if self.should("candidate_error", (candidate_hash,), attempt):
            raise ChaosError(
                f"injected candidate_error for {candidate_hash[:12]} "
                f"(attempt {attempt}, seed {self.seed})")

    # ------------------------------------------------------------------
    @staticmethod
    def from_env(environ=None) -> "FaultPlan | None":
        """Parse ``CHARON_FAULTS`` (None when unset/empty).  Grammar:
        comma-separated ``kind:value`` with kinds ``worker_crash`` /
        ``worker_hang`` / ``candidate_error`` / ``cache_corrupt`` (rates in
        [0,1]) plus ``seed:<int>``, ``repeat:<0|1>``, ``hang_s:<float>``."""
        env = os.environ if environ is None else environ
        raw = env.get("CHARON_FAULTS", "").strip()
        if not raw:
            return None
        kwargs: dict = {}
        for part in raw.split(","):
            kind, sep, value = part.partition(":")
            kind, value = kind.strip(), value.strip()
            if not sep or not value:
                raise ValueError(
                    f"CHARON_FAULTS entry {part!r} is not 'kind:value'")
            if kind in _RATE_KINDS:
                kwargs[kind] = float(value)
            elif kind == "seed":
                kwargs["seed"] = int(value)
            elif kind == "hang_s":
                kwargs["hang_s"] = float(value)
            elif kind == "repeat":
                kwargs["repeat"] = value.lower() in ("1", "true", "yes")
            else:
                raise ValueError(
                    f"unknown CHARON_FAULTS kind {kind!r} (known: "
                    f"{', '.join(_RATE_KINDS + ('seed', 'repeat', 'hang_s'))})")
        return FaultPlan(**kwargs)


def corrupt_shard(path: str) -> None:
    """Truncate a cache shard mid-file (the ``cache_corrupt`` injection):
    the resulting partial pickle must be quarantined — never loaded, never
    fatal — by :func:`repro_torch.core.simulator.merge_cache_shards`."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(size // 2, 1))
